"""Blocking copies between host and card on the program's main path
(counters ``copies.h2d`` and ``copies.d2h`` of
``openfdcm_tpu_torch.profiling.counts()``, their change over the window)
over the requests completed in it.  None without the counters' change."""


def read(run):
    counts = getattr(run, "counts", None)
    if not counts or not run.record.done or "copies.h2d" not in counts:
        return None
    return (counts["copies.h2d"] + counts["copies.d2h"]) / len(run.record.done)
