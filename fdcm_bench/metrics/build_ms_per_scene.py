"""Wall milliseconds a scene of the DT3 build
(``pipeline.build_featuremap_batch``), from the program's ``StageTimer``
stage ``build_featuremap`` (each stage ends in a device synchronize, so in
the traced run only), over the scenes completed in the window."""


def read(run):
    if not run.stages or "build_featuremap" not in run.stages or not run.record.done:
        return None
    return 1e3 * run.stages["build_featuremap"] / len(run.record.done)
