"""Device-to-host syncs of the walks (``matching.optimize.host_sync.count``)
over the requests completed in the window."""


def read(run):
    if not run.record.done:
        return None
    return run.host_syncs / len(run.record.done)
