"""k1_wide_roofline: kernel K1's 128-thread form (``ops.chol.inv_chol`` at
96 < S <= ``chol.MAX_S``, float32) at the cell's own shapes, as a share of
its roofline, in %: one call per reference level of the frozen schedule
whose S lies in that range, (B, S) random SPD blocks from ``--seed`` (C * B
for C chains), captured in a CUDA graph, replayed 3 times to warm up and
then 20 times between CUDA events, so that no host launch time enters; the
sum of the bounds (the larger of bytes over 3.35 TB/s and operations over
67 TFLOP/s, by the frozen ``inv_chol_cost``) over the sum of the times.  A
program whose K1 stops at 96 rows reports nothing.  Moves
chain_iters_per_s."""

SOURCE = "device_trace"
LAYER = "ops.chol (K1, 96 < S <= 128)"
MOVES = "chain_iters_per_s"
WIDE_FROM = 96  # the 32/64/96-thread forms' largest S
WARM, REPS = 3, 20


def measure(ctx):
    import torch

    from benchmark.reference import cost
    from spamtree_tpu_torch.ops import chol

    sched = ctx.get("sched")
    if sched is None or torch.device(ctx["device"]).type != "cuda":
        return
    C = ctx.get("chains", 1)
    gen = torch.Generator(device="cuda").manual_seed(ctx["seed"] % 2 ** 63)
    bound = took = 0.0
    for lvl in sched.levels:
        if not lvl.is_ref or not WIDE_FROM < lvl.S <= chol.MAX_S:
            continue
        B, S = C * lvl.B, lvl.S
        a = torch.randn(B, S, S, generator=gen, device="cuda")
        a = a @ a.transpose(1, 2) / S + torch.eye(S, device="cuda")
        chol.inv_chol(a)  # builds the kernel outside the capture
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            chol.inv_chol(a)
        for _ in range(WARM):
            g.replay()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(REPS):
            g.replay()
        t1.record()
        torch.cuda.synchronize()
        took += t0.elapsed_time(t1) / 1e3 / REPS
        bound += cost.roofline_s(*cost.inv_chol_cost(B, S, False, 4))
        del g
    if took > 0:
        ctx["k1_wide_roofline"] = 100.0 * bound / took


def read(ctx):
    return ctx.get("k1_wide_roofline")
