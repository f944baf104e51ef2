"""Share of the traced window in which the device idled while the host was
collecting results: the idle gaps named by a ``collect.*`` program span
(``collect.copy``, ``collect.rows``, ``collect.match``), in % of the
window.  Reads ``collect_idle_pct.batch`` and ``.latency`` alike; None
without the program's spans in the trace."""


def read(run):
    trace = run.trace
    if trace is None or not getattr(trace, "program_spans", None) or trace.window_s <= 0:
        return None
    return 100.0 * trace.idle_by_prefix("collect.") / trace.window_s
