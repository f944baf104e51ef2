"""Mean wait of a served request before its dispatch: the ``serve.queue``
program spans (submit to the start of the ``MatcherService`` dispatch that
served it), ms.  None without such spans."""


def read(run):
    trace = run.trace
    waits = [s[2] - s[1] for s in getattr(trace, "program_spans", None) or ()
             if s[0] == "serve.queue"]
    return 1e-6 * sum(waits) / len(waits) if waits else None
