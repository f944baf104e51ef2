"""Share of the traced window in which the device idled while the host was
inside the walks: the idle gaps named by a ``walks.*`` program span
(``walks.loop``, ``walks.straggler``, ``walks.sync``), in % of the window.
Reads ``walks_idle_pct.batch`` and ``walks_idle_pct.latency`` alike; None
without the program's spans in the trace (`progtrace.ProgramTrace`)."""


def read(run):
    trace = run.trace
    if trace is None or not getattr(trace, "program_spans", None) or trace.window_s <= 0:
        return None
    return 100.0 * trace.idle_by_prefix("walks.") / trace.window_s
