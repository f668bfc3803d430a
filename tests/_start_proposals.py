"""The theta proposal's decision terms at bench config 3's start, in the
port and (unless ``--port-only``) in the JAX package on the same inputs.

    python tests/_start_proposals.py [--n_per_q 12500] [--dtype float64]
        [--device cpu] [--port-only] [--draws 8] [--mcmcsd 1e-4 1e-2 1e-12]

Config 3's data (``bench.make_multivariate(n_per_q, 2)``, 50000 per margin
in the bench) goes through the port's ``prepare_fit`` as ``spamtree``
prepares it (cell_size 25, seed 1, ``settings=dict(mcmcsd=s)``: no tuner);
one Gibbs update of w from the start (generator seed 7) gives the w that
both packages then use.  For each ``mcmcsd`` s (the initial proposal
*covariance* s I, so each coordinate's step has sd sqrt(s) in the
transformed space) and each of ``--draws`` directions U (numpy seed 0,
the same at every s), the proposal transf_back(transf_fwd(theta) +
chol(s I) U) is held against the start by each package's decision-only
sweep: new_logdet, ok, q_new, q_cur, the jacobian and the log-accept
(l = new_logdet + q_new - logdetCi - q_cur + jacobian).  With the accept
draw u = 0 a proposal installs iff ok and exp(min(l, 0)) > 0 in the model's
type, so the last column says which of the two refused it.  One JSON line
per proposal; the JAX package's model is built from the same tree
arguments (``tests/test_torch_tree.py`` holds the trees equal).
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import bench  # noqa: E402
from spamtree_tpu_torch.api import prepare_fit  # noqa: E402
from spamtree_tpu_torch.model import core as ct  # noqa: E402
from spamtree_tpu_torch.model import transforms as tt  # noqa: E402


def start(n_per_q, dtype, device, seed=1):
    """Config 3's data (n_per_q per margin) and the port's prepared fit at
    a placeholder proposal; returns (fit, sorted data dict, w)."""
    y, _, _, X, coords, mv = bench.make_multivariate(n_per_q, 2)
    y = y - np.nanmean(y)
    fit = prepare_fit(y, X, coords, mv_id=mv, cell_size=25,
                      mcmc=dict(keep=1, burn=0), settings=dict(mcmcsd=1e-4),
                      seed=seed, device=device, dtype=dtype)
    o = fit.order
    data = dict(y=y[o], X=X[o], coords=coords[o],
                mv=np.searchsorted(np.unique(mv), mv)[o], seed=seed)
    st = fit.state
    gen = torch.Generator(device=fit.ms.device).manual_seed(7)
    z = torch.randn(fit.ms.n + 1, generator=gen, dtype=fit.ms.dtype,
                    device=fit.ms.device)
    w = ct.gibbs_w(fit.ms, st.leveldata, st.w, st.tausq_inv, st.XB, z)
    return fit, data, w


def proposals(theta, bounds, mcmcsd, draws):
    """numpy (draws, nt) proposals at covariance mcmcsd I, the same U."""
    th = torch.as_tensor(theta, dtype=torch.float64)
    b = torch.as_tensor(bounds, dtype=torch.float64)
    U = np.random.default_rng(0).normal(size=(draws, len(theta)))
    out = []
    for u in U:
        x = tt.transf_fwd(th, b) + np.sqrt(mcmcsd) * torch.as_tensor(u)
        out.append(tt.clamp_bounds(tt.transf_back(x, b), b)[0].numpy())
    return np.stack(out)


def port_terms(fit, w, prop):
    ms, st = fit.ms, fit.state
    p = torch.as_tensor(prop, dtype=ms.dtype, device=ms.device)
    ld, ok, qn, qc = ct.sweep(ms, p, w, quad_prev=st.leveldata,
                              decision_only=True)
    b = torch.as_tensor(fit.bounds, dtype=ms.dtype, device=ms.device)
    jac = tt.calc_jacobian(p, st.theta, b)
    return dict(new_logdet=float(ld), ok=bool(ok), q_new=float(qn),
                q_cur=float(qc), jacobian=float(jac),
                logdetCi=float(st.logdetCi))


def jax_model(fit, data):
    """The JAX package's model and its start (leveldata, logdetCi) on the
    port's tree arguments."""
    import jax

    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from spamtree_tpu.model import core as cj
    from spamtree_tpu.model.params import make_theta_spec
    from spamtree_tpu.tree.partition import make_tree
    from spamtree_tpu.tree.schedule import build_schedule

    tree = make_tree(data["coords"], np.isfinite(data["y"]), data["mv"],
                     axis_cell_size=5, K=2,
                     rng=np.random.default_rng(data["seed"]))
    dt = jnp.float64 if fit.ms.dtype == torch.float64 else jnp.float32
    return cj.ModelStatic(build_schedule(tree), data["coords"], data["mv"],
                          data["y"], data["X"], make_theta_spec(2, 2).spec,
                          dtype=dt)


def jax_terms_fn(ms_j, theta0, w):
    """prop -> the JAX package's decision terms against theta0."""
    import jax
    import jax.numpy as jnp

    from spamtree_tpu.model import core as cj
    from spamtree_tpu.model.transforms import calc_jacobian

    dt = ms_j.dtype
    th0 = jnp.asarray(theta0, dt)
    wj = jnp.asarray(w, dt)
    ld0, _, lg0, ok0 = jax.jit(lambda t: cj.sweep(ms_j, t, wj))(th0)
    assert bool(ok0)
    dec = jax.jit(lambda t: cj.sweep(ms_j, t, wj, quad_prev=ld0,
                                     decision_only=True))

    def terms(prop, bounds):
        p = jnp.asarray(prop, dt)
        ld, ok, qn, qc = dec(p)
        jac = calc_jacobian(p, th0, jnp.asarray(bounds, dt))
        return dict(new_logdet=float(ld), ok=bool(ok), q_new=float(qn),
                    q_cur=float(qc), jacobian=float(jac),
                    logdetCi=float(lg0))

    return terms


def log_accept(t):
    return (t["new_logdet"] + t["q_new"] - t["logdetCi"] - t["q_cur"]
            + t["jacobian"])


def refused_by(t, dtype):
    """Why a u = 0 draw refuses the proposal: "ok" (a Cholesky failed),
    "underflow" (exp(min(l, 0)) is 0 in the type), or "" (it installs)."""
    if not t["ok"]:
        return "ok"
    la = torch.tensor(min(log_accept(t), 0.0), dtype=dtype)
    return "underflow" if not float(torch.exp(la)) > 0 else ""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n_per_q", type=int, default=12500)
    ap.add_argument("--dtype", nargs="+", default=["float64", "float32"])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--port-only", action="store_true")
    ap.add_argument("--draws", type=int, default=8)
    ap.add_argument("--mcmcsd", type=float, nargs="+",
                    default=[1e-4, 1e-2, 1e-12])
    a = ap.parse_args(argv)
    rows = []
    for dname in a.dtype:
        dtype = getattr(torch, dname)
        fit, data, w = start(a.n_per_q, dtype, a.device)
        theta0 = fit.state.theta.double().cpu().numpy()
        jt = (None if a.port_only else
              jax_terms_fn(jax_model(fit, data), theta0, w.cpu().numpy()))
        for s in a.mcmcsd:
            for k, prop in enumerate(proposals(theta0, fit.bounds, s,
                                               a.draws)):
                row = dict(n=fit.ms.n, dtype=dname, mcmcsd=s, draw=k)
                for side, f in (("port", lambda p: port_terms(fit, w, p)),
                                ("jax", None if jt is None else
                                 lambda p: jt(p, fit.bounds))):
                    if f is None:
                        continue
                    t = f(prop)
                    row[side] = t | dict(log_accept=log_accept(t),
                                         refused_by=refused_by(t, dtype))
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
