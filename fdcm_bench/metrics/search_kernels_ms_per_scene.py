"""Device milliseconds a scene of the search's kernels: the window kernels
(K1 ``window_kernel``, K5 ``window_v2_kernel``, K6 ``window_v3_kernel``),
the tiled stack copy they read (``tile_kernel``) and the walks' decisions
over a scored window (``decide_kernel``), summed over the traced window's
device operations, over the scenes completed in the window."""

KERNELS = ("window_kernel", "window_v2_kernel", "window_v3_kernel", "tile_kernel",
           "decide_kernel")


def read(run):
    if run.trace is None or not run.record.done:
        return None
    spent = run.trace.kernel_s(KERNELS)
    if spent is None:
        return None
    return 1e3 * spent / len(run.record.done)
