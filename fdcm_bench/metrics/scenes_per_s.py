"""Scenes completed in the window over the window's length; the clock
stops once the last call's results are on the host."""


def read(run):
    return len(run.record.done) / run.record.seconds
