# The distributions and sizes are those of the data makers of
# spamtree_tpu_torch/bench.py (make_univariate, make_multivariate and
# _latent_field, themselves copies of the JAX package's bench.py) at commit
# 1ed94f536e0e.  Do not edit them to follow the program.
"""Synthetic spatial data for the benchmark's configurations, drawn on the
device from the seed."""

import numpy as np


def make(config: dict, seed: int, device="cuda") -> dict:
    """The data of a configuration file's ``data`` entry, as NumPy arrays:
    ``y`` (NaN where held out), ``y_full``, the held-out mask ``miss``,
    ``X``, ``coords``, the margins ``mv`` (1-based, or None for one
    margin), and what the check holds the fit against: the noise-free mean
    ``mu`` = X B + w of every row and its noise variance ``noise_var``.

    Drawn on ``device`` in a few large calls: bench.py's makers' random
    exp-kernel features for the field, margin-dependent field scale and
    noise.  The sites, their margins and the held-out mask come from the
    configuration's ``layout_seed``, so that every run of a cell has the
    same tree, block shapes and work; the values (covariates,
    coefficients, field, noise) come from ``seed``."""
    import torch

    d = config["data"]
    f64 = dict(dtype=torch.float64, device=device)
    lay = torch.Generator(device=device).manual_seed(int(d["layout_seed"]))
    rng = torch.Generator(device=device).manual_seed(int(seed))

    def field(coords, k=64):
        # _latent_field: random exp-kernel features
        w = torch.zeros(len(coords), **f64)
        for scale, amp in ((0.4, 1.0), (0.08, 0.5)):
            centers = torch.rand((k, coords.shape[1]), generator=rng, **f64)
            feat = torch.exp(-torch.cdist(coords, centers) / scale)
            w += amp * (feat @ torch.randn(k, generator=rng, **f64)) / k ** 0.5
        return w

    if d["maker"] == "univariate":
        n = d["n"]
        coords = torch.rand((n, 2), generator=lay, **f64)
        miss = torch.rand(n, generator=lay, **f64) < d["miss"]
        X = torch.randn((n, 3), generator=rng, **f64)
        B = torch.tensor([-1.0, 0.5, 1.0], **f64)
        mu = X @ B + field(coords)
        noise_var = torch.full((n,), 0.1, **f64)
        mv = None
    else:
        n_per_q, q, imb = d["n_per_q"], d["q"], d.get("imbalance")
        if imb is None:
            base = torch.rand((n_per_q, 2), generator=lay, **f64)
            coords = base.repeat_interleave(q, dim=0)
            mv = np.tile(np.arange(1, q + 1), n_per_q)
        else:
            counts = [int(n_per_q * q * frac) for frac in imb]
            coords = torch.cat([torch.rand((c, 2), generator=lay, **f64)
                                for c in counts])
            mv = np.concatenate([np.full(c, j + 1)
                                 for j, c in enumerate(counts)])
        n = len(coords)
        miss = torch.rand(n, generator=lay, **f64) < d["miss"]
        mv0 = torch.as_tensor(mv - 1, device=device)
        X = torch.randn((n, 2), generator=rng, **f64)
        B = torch.randn((2, q), generator=rng, **f64)
        w = field(coords) * (1.0 + 0.3 * mv0)  # margin-dependent scale
        mu = (X * B[:, mv0].T).sum(1) + w
        noise_var = (0.1 + 0.05 * torch.arange(q, **f64))[mv0]
    y_full = mu + noise_var.sqrt() * torch.randn(n, generator=rng, **f64)
    y = torch.where(miss, float("nan"), y_full)
    host = lambda t: t.cpu().numpy()
    return dict(y=host(y), y_full=host(y_full), miss=host(miss), X=host(X),
                coords=host(coords), mv=mv, mu=host(mu),
                noise_var=host(noise_var))
