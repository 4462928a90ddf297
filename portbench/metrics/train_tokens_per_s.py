"""Sequence positions (batch × maxLen) of the steps completed in the
window, over its seconds."""


def read(run):
    return run.counts["positions"] / run.window_s if run.window_s > 0 else None
