"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over set-up and the
window, read when the window closes, in GiB.  Every cell."""

SOURCE = "host_clock"
LAYER = None  # end to end


def read(ctx):
    b = ctx.get("peak_bytes")
    return b / 2 ** 30 if b else None
