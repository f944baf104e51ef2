"""Device milliseconds a scene of the DT3 build: the device time of every
operation launched inside a ``build.*`` program span (seed scatter, column
pass and K2, mask, K3, K4 and their glue), over the scenes completed in
the window.  Unlike ``build_ms_per_scene`` it needs no synchronize.  None
without the program's spans, or when no operation could be traced to its
launch."""


def read(run):
    trace = run.trace
    if trace is None or not getattr(trace, "program_spans", None) or not run.record.done:
        return None
    spent = sum(s for name, s in trace.charge().items() if name.startswith("build."))
    return 1e3 * spent / len(run.record.done) if spent else None
