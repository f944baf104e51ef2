"""Requests a ``MatcherService`` dispatch carried: requests completed in
the window over the service's ``dispatches`` in it."""


def read(run):
    if not run.dispatches:
        return None
    return len(run.record.done) / run.dispatches
