"""Readings that set the limits of ``correct``: the program's sound runs,
the lower-precision control and planted faults, several seeds in one
process.

    python3 -m benchmark.control --workload c3_biv1e5_single \\
        --seeds 11,12,13 --seconds 30 --mode sound|tf32|<fault>

Each seed runs the cell as ``benchmark.run`` does (``--trace 0``) and
prints one JSON line: the seed, the mode and every compared number, or the
error where the run raised (a control that crashes has failed).  Modes:

- ``sound``: the program as it is;
- ``tf32``: the control, float32 products in TF32 (``allow_tf32`` and
  ``set_float32_matmul_precision("high")``, set after the program's import
  has pinned them off);
- ``tf32_window``: the same control switched on when the window starts, so
  that the set-up (whose initial factors fail in TF32) runs in float32 and
  the window's proposals and predictions in TF32;
- ``ref_tf32``: the reference put in the program's place, computed in
  float32 with the inputs of its products rounded to TF32 (on the card and
  here alike; cuBLAS keeps small products in FP32 FMA whatever
  ``allow_tf32`` says): the fit cells' log-determinant term and
  quadratic form of the chain's last state, and the predict cell's draws at
  the new sites, as the reference computes them at that precision, judged
  against the float64 reference;
- a fault planted in the timed path: ``pred_zero`` (the predicted rows
  zeroed where the prediction is made: the fit's kept iterations, or
  ``spamtree_predict``'s draws), ``state_unchanged`` (the iteration returns
  its state unchanged), ``yhat_no_noise`` (yhat without its noise: the
  fit's host yhat, or ``spamtree_predict``'s), ``half_draws``
  (``spamtree_predict`` computes half its draws and repeats them for the
  rest), ``half_blocks`` (kernel K1 leaves out the second half of each
  batch of blocks, whose factors come back as the identity; from the window
  on), ``margins_swapped`` (the model's covariance reads each row's margin
  as the other one's, everywhere), ``w_no_data`` (w's Gibbs update reads
  the residual y - X beta as 0, so w ignores the data), ``beta_zero``
  (the conjugate tail draws tau^2 but returns beta as 0), ``half_chains``
  (batched chains C/2 and above keep their w at every iteration; eager
  steps only, so on the CPU).
"""

import argparse
import json
import sys
import time
import traceback

FAULTS = ("pred_zero", "state_unchanged", "yhat_no_noise", "half_draws",
          "half_blocks", "margins_swapped", "w_no_data", "beta_zero", "half_chains")


def tf32_on(on: bool = True):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")


def ref_in_tf32(run):
    """``ref_tf32``: the state's numbers replaced by the reference's in
    float32 with TF32 products."""
    import numpy as np
    import torch

    from benchmark.reference import density

    check = run.check_fit

    def check_tf32(spec, inputs, st, dr, tree, *a, **k):
        dev = torch.device(a[-1] if a else k["device"])
        order, cs, mvs, ys = run._sorted(inputs)
        blocks = density.Blocks(tree)
        coords = torch.as_tensor(cs, dtype=torch.float32, device=dev)
        mv = torch.as_tensor(mvs, device=dev)
        st = dict(st, logdet=np.array(st["logdet"]), quad=np.array(st["quad"]))
        tf32_on()
        try:
            for c in range(st["chains"]):
                try:
                    st["logdet"][c], st["quad"][c] = density.loglik_parts(
                        blocks, torch.as_tensor(st["theta"][c], device=dev),
                        int(mvs.max()) + 1, coords, mv,
                        torch.as_tensor(st["w"][c], device=dev), tf32=True)
                except (RuntimeError, np.linalg.LinAlgError):
                    st["logdet"][c] = st["quad"][c] = float("nan")
        finally:
            tf32_on(False)
        return check(spec, inputs, st, dr, tree, *a, **k)
    run.check_fit = check_tf32
    check_p = run.check_predict

    def check_predict_tf32(*a, **k):
        tf32_on()
        try:
            return check_p(*a, stand_in=torch.float32, **k)
        finally:
            tf32_on(False)
    run.check_predict = check_predict_tf32


def at_window(run, on, off):
    """Call ``on()`` as the window starts (the fit cells' chain call after
    the warm-up, the predict cell's first ``spamtree_predict`` call);
    returns ``reset()``, to call before each seed, which calls ``off()``."""
    from spamtree_tpu_torch import api

    runner, calls = run._runner, [0]

    def counted(chains):
        fn = runner(chains)

        def call(*a, **k):
            calls[0] += 1
            if calls[0] == 2:
                on()
            return fn(*a, **k)
        return call
    run._runner = counted
    predict = api.spamtree_predict

    def predict_at_window(*a, **k):
        on()
        return predict(*a, **k)
    api.spamtree_predict = predict_at_window

    def reset():
        calls[0] = 0
        off()
    return reset


def half_blocks(run):
    """``half_blocks`` from the window on (set-up's tuner fails with it):
    returns the per-seed reset."""
    import torch

    from spamtree_tpu_torch.ops import linalg

    k1 = linalg.inv_chol

    def half(a, *args, **k):
        out = k1(a, *args, **k)
        lo = out.shape[0] - out.shape[0] // 2
        eye = torch.eye(out.shape[-1], dtype=out.dtype, device=out.device)
        return torch.cat([out[:lo], eye.expand_as(out[lo:])])

    def on():
        linalg.inv_chol = half

    def off():
        linalg.inv_chol = k1
    return at_window(run, on, off)


def plant(fault: str):
    """Break the timed path underneath the harness (see the module doc)."""
    import numpy as np
    import torch

    from spamtree_tpu_torch import api
    from spamtree_tpu_torch.model import core, mcmc

    if fault == "pred_zero":
        def zeroed(fn):
            def f(ms, *a, **k):
                out = fn(ms, *a, **k)
                return torch.where(ms.pred_rows.hit, 0.0, out)
            return f
        mcmc.predict = zeroed(mcmc.predict)
        mcmc.predict_recompute = zeroed(mcmc.predict_recompute)
        core.predict_recompute = zeroed(core.predict_recompute)
    elif fault == "state_unchanged":
        # graphed (the card) and eager (the CPU) iterations
        mcmc.StepRunner.step = lambda self, predicting, ran=None: self.state
        mcmc.make_step = lambda *a, **k: (
            lambda state, draws, predicting, ran=None: state)
    elif fault == "yhat_no_noise":
        orig = mcmc._make_yhat_host

        class Zeros:
            def standard_normal(self, shape, dtype=None):
                return np.zeros(shape, dtype=dtype)

        mcmc._make_yhat_host = lambda ms, rng: orig(ms, Zeros())
        predict = api.spamtree_predict

        def no_noise(fit, y, x, coords, coords_new, x_new, mv_id=None,
                     mv_id_new=None, **k):
            out = predict(fit, y, x, coords, coords_new, x_new, mv_id=mv_id,
                          mv_id_new=mv_id_new, **k)
            labels = np.unique(mv_id)
            m0 = np.searchsorted(labels, mv_id_new)
            beta = np.moveaxis(np.asarray(fit["beta_mcmc"]), 1, 0)
            xb = np.einsum("np,spq->snq", x_new, beta[out["draw_indices"]])
            out["yhat_pred"] = xb[:, np.arange(len(m0)), m0] + out["w_pred"]
            return out
        api.spamtree_predict = no_noise
    elif fault == "half_draws":
        orig = api.predict_draws

        def half(st, runner, seed, chunk=32, verbose=False):
            k = (len(st.sel) + 1) // 2
            w = orig(st._replace(sel=st.sel[:k]), runner, seed, chunk,
                     verbose)
            return np.concatenate([w, w])[:len(st.sel)]
        api.predict_draws = half
    elif fault == "margins_swapped":
        cov, diag = core.pairwise_cov, core.pairwise_cov_diag

        def swap(m, spec):
            return (spec.q - 1) - m

        core.pairwise_cov = lambda c1, m1, c2, m2, params, spec: cov(
            c1, swap(m1, spec), c2, swap(m2, spec), params, spec)
        core.pairwise_cov_diag = lambda c, m, params, spec: diag(
            c, swap(m, spec), params, spec)
    elif fault == "w_no_data":
        gibbs_w = mcmc.gibbs_w

        def no_data(ms, leveldata, w, tausq_inv, XB, z, y=None, **k):
            return gibbs_w(ms, leveldata, w, tausq_inv, XB, z, y=XB, **k)
        mcmc.gibbs_w = no_data
    elif fault == "beta_zero":
        tail = mcmc.gibbs_beta_tausq

        def zero(*a, **k):
            tausq_inv, beta, XB = tail(*a, **k)
            return tausq_inv, torch.zeros_like(beta), torch.zeros_like(XB)
        mcmc.gibbs_beta_tausq = zero
    elif fault == "half_chains":
        make_step = mcmc.make_step

        def frozen(*a, **k):
            step = make_step(*a, **k)

            def f(state, draws, predicting, ran=None):
                h = state.w.shape[0] // 2
                w = state.w[h:].clone()
                new = step(state, draws, predicting, ran)
                return new._replace(w=torch.cat([new.w[:h], w]))
            return f
        mcmc.make_step = frozen
    else:
        raise ValueError(f"unknown fault {fault!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--mode", default="sound",
                    choices=("sound", "tf32", "tf32_window", "ref_tf32")
                    + FAULTS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from benchmark import run

    run._cache_dirs(run.ROOT)
    spec = run.load_spec(run.ROOT, args.workload)
    import spamtree_tpu_torch  # noqa: F401  (pins f32 first)

    reset = None
    if args.mode == "tf32":
        tf32_on()
    elif args.mode == "tf32_window":
        reset = at_window(run, tf32_on, lambda: tf32_on(False))
    elif args.mode == "half_blocks":
        reset = half_blocks(run)
    elif args.mode == "ref_tf32":
        ref_in_tf32(run)
    elif args.mode != "sound":
        plant(args.mode)
    for seed in (int(s) for s in args.seeds.split(",")):
        if reset is not None:
            reset()
        t0 = time.time()
        line = dict(workload=args.workload, mode=args.mode, seed=seed)
        try:
            out = run.run_cell(spec, seed, args.seconds, False, args.device)
            line.update(correct=out["correct"],
                        numbers={k: v["value"]
                                 for k, v in out["checks"].items()},
                        metrics={k: v["value"]
                                 for k, v in out["metrics"].items()})
        except Exception as e:  # a control that crashes has failed
            line.update(correct=False, error=repr(e)[:500],
                        trace=traceback.format_exc()[-1500:])
        line["seconds"] = time.time() - t0
        print(json.dumps(line), flush=True)
        run._free(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
