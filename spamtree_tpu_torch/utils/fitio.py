"""Persist a :func:`spamtree` fit to a single compressed ``.npz`` file.

Copy of ``spamtree_tpu/utils/fitio.py`` (imports no jax) that also
encodes a ``torch.dtype`` -- this package's ``fit_config["dtype"]`` -- as
the same ``{"k": "dtype", "name": "float32"}`` node, so either package's
``load_fit`` reads the other's fits; a dtype reads back as a numpy dtype.

Users of the reference persist fits with R's ``saveRDS`` — the returned
list is plain R data (reference: R/spamtree_fit.R:365-370).  The rebuild's
fit dict mixes numpy arrays with plain-Python metadata plus two large
rebuildable objects (``tree``, ``schedule``); :func:`save_fit` writes one
compressed ``.npz`` holding every array alongside a JSON structure tree,
and :func:`load_fit` returns a dict usable everywhere a fresh fit is —
including :func:`spamtree_predict`, which rebuilds the partition from
``fit_config`` + the original data, and ``resume_from=`` workflows (which
use the separate MCMC-state checkpoint, not the fit object).

``tree`` and ``schedule`` are deliberately not serialized: they are
deterministic functions of (coords, na pattern, fit_config) and dominate
the fit's in-memory footprint without adding information.  ``load_fit``
marks their absence in ``fit["skipped_on_save"]``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

_SKIP_KEYS = ("tree", "schedule")
_FORMAT_VERSION = 1


def _encode(value, prefix, arrays):
    """Recursively split `value` into a JSON structure tree + numpy arrays."""
    if isinstance(value, np.ndarray):
        key = f"arr/{prefix}"
        arrays[key] = value
        return {"k": "array", "key": key}
    if isinstance(value, np.generic):  # numpy scalar (np.float32(3.), ...)
        return {"k": "json", "v": value.item()}
    if isinstance(value, np.dtype):
        return {"k": "dtype", "name": value.name}
    if isinstance(value, torch.dtype):  # torch.float32 -> "float32"
        return {"k": "dtype", "name": str(value).removeprefix("torch.")}
    if isinstance(value, type):  # np.float32 dtype classes
        return {"k": "dtype", "name": np.dtype(value).name}
    if isinstance(value, dict):
        return {
            "k": "dict",
            "items": {
                str(k): _encode(v, f"{prefix}.{k}", arrays)
                for k, v in value.items()
            },
        }
    if isinstance(value, (list, tuple)):
        return {
            "k": "list",
            "tuple": isinstance(value, tuple),
            "items": [
                _encode(v, f"{prefix}[{i}]", arrays)
                for i, v in enumerate(value)
            ],
        }
    if value is None or isinstance(value, (bool, int, float, str)):
        # json.dumps(allow_nan=True) round-trips inf/nan (tree_depth=inf)
        return {"k": "json", "v": value}
    raise TypeError(
        f"save_fit cannot serialize fit[{prefix!r}] of type {type(value)!r}"
    )


def _decode(node, arrays):
    kind = node["k"]
    if kind == "array":
        return arrays[node["key"]]
    if kind == "json":
        return node["v"]
    if kind == "dtype":
        return np.dtype(node["name"])
    if kind == "dict":
        return {k: _decode(v, arrays) for k, v in node["items"].items()}
    if kind == "list":
        items = [_decode(v, arrays) for v in node["items"]]
        return tuple(items) if node["tuple"] else items
    raise ValueError(f"unknown fitio node kind {kind!r}")


def save_fit(path: str, fit: dict) -> None:
    """Write a :func:`spamtree` fit dict to ``path`` (one ``.npz`` file).

    Every numpy array in the fit (draws, summaries, coords, diagnostics,
    ``fit_config`` entries) is stored verbatim; plain metadata rides in an
    embedded JSON tree.  ``tree`` and ``schedule`` are skipped (see module
    docstring).  Use :func:`load_fit` to read it back.
    """
    arrays: dict[str, np.ndarray] = {}
    meta: dict[str, object] = {}
    skipped = []
    for k, v in fit.items():
        if k in _SKIP_KEYS:
            skipped.append(k)
            continue
        meta[str(k)] = _encode(v, str(k), arrays)
    header = json.dumps(
        {"version": _FORMAT_VERSION, "fit": meta, "skipped": skipped}
    )
    arrays["__spamtree_fit_meta__"] = np.frombuffer(
        header.encode("utf-8"), dtype=np.uint8
    ).copy()
    np.savez_compressed(path, **arrays)


def load_fit(path: str) -> dict:
    """Read a fit saved by :func:`save_fit`.

    Returns the fit dict with every array bit-identical to what was saved.
    ``tree``/``schedule`` are absent (listed in ``fit["skipped_on_save"]``);
    :func:`spamtree_predict` does not need them.
    """
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    raw = arrays.pop("__spamtree_fit_meta__", None)
    if raw is None:
        raise ValueError(
            f"{path!r} is not a spamtree fit file (missing meta entry)"
        )
    header = json.loads(raw.tobytes().decode("utf-8"))
    if header.get("version") != _FORMAT_VERSION:
        raise ValueError(
            f"unsupported spamtree fit-file version {header.get('version')!r}"
        )
    fit = {k: _decode(v, arrays) for k, v in header["fit"].items()}
    fit["skipped_on_save"] = list(header.get("skipped", []))
    return fit
