"""Wall milliseconds a scene of the search on the device pairs (candidates,
the window kernel on the tiled copy, the walks and their host syncs, the
penalty and top-k), from the program's ``StageTimer`` stage
``search_topk_devpairs``, over the scenes completed in the window."""


def read(run):
    if not run.stages or "search_topk_devpairs" not in run.stages or not run.record.done:
        return None
    return 1e3 * run.stages["search_topk_devpairs"] / len(run.record.done)
