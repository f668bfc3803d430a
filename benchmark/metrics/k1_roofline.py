"""k1_roofline: kernel K1 (``ops.chol.inv_chol``) at the cell's own shapes,
as a share of its roofline, in %: one call per reference level of the
frozen schedule, (B, S) blocks (C * B for C chains), timed with CUDA events
over 20 calls after 3 warm-up ones; the sum of the bounds (the larger of
bytes over 3.35 TB/s and operations over 67 TFLOP/s, by the frozen
``inv_chol_cost``) over the sum of the times.  Moves chain_iters_per_s."""

SOURCE = "device_trace"
LAYER = "ops.chol (K1)"
MOVES = "chain_iters_per_s"
REPS = 20


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
        if not lvl.is_ref or not 1 <= lvl.S <= chol.MAX_S:
            continue
        B, S = C * lvl.B, lvl.S
        a = torch.randn(B, S, S, generator=gen, device="cuda")
        a = a @ a.transpose(1, 2) / S + torch.eye(S, device="cuda")
        for _ in range(3):
            chol.inv_chol(a)
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(REPS):
            chol.inv_chol(a)
        t1.record()
        torch.cuda.synchronize()
        took += t0.elapsed_time(t1) / 1e3 / REPS
        bound += cost.roofline_s(*cost.inv_chol_cost(B, S, False, 4))
    if took > 0:
        ctx["k1_roofline"] = 100.0 * bound / took


def read(ctx):
    return ctx.get("k1_roofline")
