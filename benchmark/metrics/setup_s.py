"""setup_s: seconds from the process's start to the window's first call:
imports, CUDA context, kernel libraries, data, ``prepare_fit``, warm-up
(and the predict cell's fit).  Every cell."""

SOURCE = "host_clock"
LAYER = None  # end to end


def read(ctx):
    return ctx.get("setup_s")
