"""Checkpoint and resume of a SpamTree chain.

Port of ``spamtree_tpu/utils/checkpoint.py``.  The sampler state -- w,
beta, tausq, theta, the RAM adapter, the iteration counter -- round-trips
through one ``.npz`` file with the JAX package's field names, and so do
the summary moments (``mom_*``) and the writing run's chunk geometry
(``geom_counts``).  In place of the JAX ``key`` it holds the state of
every random stream the run draws from: the chain's torch generator
(``gen_state``), the device generator of summary collection's yhat noise
(``gen_yhat_state``) and the host's yhat generator (``host_rng_state``),
so a resumed chain continues the uninterrupted one draw for draw.  The
per-level factors are not stored: they are functions of theta, rebuilt
with one likelihood sweep on load.

Batched chains save their leaves with the chain axis (theta (C, nt)), the
RAM counters per chain and every chain's generator (``gen_state`` (C,
L)); the chain count is theta's leading dimension.  A mesh's run saves
every chain, gathered (rank 0 writes), and each chains rank loads its own
(``load_state(chains=)``).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from spamtree_tpu_torch.model.core import ModelStatic, gram_full, sweep
from spamtree_tpu_torch.model.mcmc import MCMCState, Moments
from spamtree_tpu_torch.model.ram import RAMState


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def save_state(path: str, state: MCMCState, gen, yhat_rngs,
               moments: Moments | None = None, counts=None) -> None:
    """Write ``state``, the chain's generator ``gen`` (a list of C
    generators, or of their ``get_state()`` tensors, for batched chains)
    and the yhat streams ``yhat_rngs`` =
    (host numpy generator, device torch generator) to ``path`` (``.npz``
    appended when missing, as ``np.savez`` does).

    ``moments``: summary collection's running sums, so an interrupted
    ``collect="summary"`` run resumes its partial sums.  ``counts``: the
    writing run's (mc, burn_done, kept_done, thin), which the resume path
    reads instead of inferring them from its own configuration.  The file
    is written beside ``path`` and renamed over it, so an interrupted save
    leaves the previous checkpoint whole."""
    if not path.endswith(".npz"):
        path += ".npz"
    host_rng, gen_yhat = yhat_rngs
    extra = {}
    if counts is not None:
        extra["geom_counts"] = np.asarray(counts, dtype=np.int64)
    if moments is not None:
        extra.update(mom_count=np.asarray(moments.count),
                     mom_w_sum=_np(moments.w_sum), mom_w_sq=_np(moments.w_sq),
                     mom_yh_sum=_np(moments.yh_sum),
                     mom_yh_sq=_np(moments.yh_sq))
    ram = state.ram
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(
            f, **extra,
            gen_state=(np.stack([_np(g.get_state() if isinstance(
                g, torch.Generator) else g) for g in gen])
                       if isinstance(gen, (list, tuple))
                       else _np(gen.get_state())),
            gen_yhat_state=_np(gen_yhat.get_state()),
            host_rng_state=np.frombuffer(json.dumps(
                host_rng.bit_generator.state).encode(), dtype=np.uint8),
            w=_np(state.w), beta=_np(state.beta),
            tausq_inv=_np(state.tausq_inv), XB=_np(state.XB),
            theta=_np(state.theta), logdetCi=_np(state.logdetCi),
            it=np.asarray(state.it), ram_paramsd=_np(ram.paramsd),
            ram_prodparam=_np(ram.prodparam),
            ram_started=np.asarray(ram.started),
            ram_propos=np.asarray(ram.propos_count),
            ram_accept=np.asarray(ram.accept_count))
    os.replace(tmp, path)


# the per-chain leaves of a batched chains checkpoint
_CHAIN_KEYS = ("w", "beta", "tausq_inv", "XB", "theta", "logdetCi",
               "ram_paramsd", "ram_prodparam", "ram_propos", "ram_accept",
               "gen_state", "mom_w_sum", "mom_w_sq", "mom_yh_sum",
               "mom_yh_sq")


def _load(path: str, chains=None) -> dict:
    """The checkpoint's arrays; ``chains=(c0, c)``: of chains c0 .. c0 + c
    - 1 alone."""
    with np.load(path) as zf:  # close the file promptly
        z = {k: zf[k] for k in zf.files}
    if chains is not None:
        c0, c = chains
        z = {k: (v[c0:c0 + c] if k in _CHAIN_KEYS else v)
             for k, v in z.items()}
    if "gen_state" not in z:
        if "key" in z:
            raise ValueError(
                f"{path} was written by the JAX package: its RNG key cannot "
                f"seed this package's torch generators, so the chain cannot "
                f"continue exactly; resume it with spamtree_tpu")
        raise ValueError(f"{path} is not a spamtree checkpoint (no "
                         f"generator state)")
    return z


def load_counts(path: str):
    """(mc, burn_done, kept_done, thin) of the run that wrote the
    checkpoint, or None when it recorded none."""
    z = _load(path)
    if "geom_counts" not in z:
        return None
    return tuple(int(v) for v in z["geom_counts"])


def load_moments(path: str, ms: ModelStatic, chains=None) -> Moments | None:
    """Summary collection's running sums saved by ``save_state`` (None when
    the writing run collected all draws); ``chains`` as ``load_state``'s."""
    z = _load(path, chains)
    if "mom_count" not in z:
        return None
    t = lambda k: torch.as_tensor(z[k], dtype=ms.dtype, device=ms.device)
    return Moments(count=float(z["mom_count"]), w_sum=t("mom_w_sum"),
                   w_sq=t("mom_w_sq"), yh_sum=t("mom_yh_sum"),
                   yh_sq=t("mom_yh_sq"))


def load_rngs(path: str, device, chains=None):
    """(chain generator -- a list of them for batched chains --, (host yhat
    generator, device yhat generator)) as they stood when the checkpoint
    was written, on ``device``; ``chains`` as ``load_state``'s."""
    z = _load(path, chains)
    device = torch.device(device)

    def gen(state):
        g = torch.Generator(device=device)
        g.set_state(torch.as_tensor(state, dtype=torch.uint8))
        return g

    host = np.random.default_rng()
    host.bit_generator.state = json.loads(z["host_rng_state"].tobytes())
    gs = z["gen_state"]
    chain = [gen(s) for s in gs] if gs.ndim == 2 else gen(gs)
    return chain, (host, gen(z["gen_yhat_state"]))


def load_chains(path: str) -> int:
    """The number of chains the checkpoint holds (1 for a single chain)."""
    theta = _load(path)["theta"]
    return theta.shape[0] if theta.ndim == 2 else 1


def load_state(path: str, ms: ModelStatic, chains=None) -> MCMCState:
    """The sampler state saved at ``path``, on ``ms.device``: the factors,
    Gram blocks and prediction operators rebuilt by one likelihood sweep
    (kernel K1 on the reference levels) at the saved theta; logdetCi is
    the chain's own, as saved.  Batched chains come back with their chain
    axis, (C,) counters on the device and no gram, as
    ``mcmc.stack_chain_states`` builds them; ``chains=(c0, c)`` keeps
    chains c0 .. c0 + c - 1 alone (a mesh's chains rank)."""
    z = _load(path, chains)
    t = lambda k: torch.as_tensor(z[k], dtype=ms.dtype, device=ms.device)
    theta, w = t("theta"), t("w")
    chains = theta.dim() == 2
    leveldata, pred_data, _logdet, ok = sweep(ms, theta, w)
    if not bool(ok.all()):
        raise RuntimeError("checkpointed theta fails Cholesky on rebuild")
    count = t if chains else (lambda k: float(z[k]))
    ram = RAMState(paramsd=t("ram_paramsd"), prodparam=t("ram_prodparam"),
                   started=bool(z["ram_started"]),
                   propos_count=count("ram_propos"),
                   accept_count=count("ram_accept"))
    return MCMCState(w=w, beta=t("beta"), tausq_inv=t("tausq_inv"),
                     XB=t("XB"), theta=theta, leveldata=leveldata,
                     pred_data=pred_data, logdetCi=t("logdetCi"), ram=ram,
                     it=int(z["it"]),
                     gram=() if chains else gram_full(ms, leveldata))
