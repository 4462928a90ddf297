"""Users whose top-k answer the window returned, over its seconds."""


def read(run):
    return run.counts["users"] / run.window_s if run.window_s > 0 else None
