"""Ratings × ALS iterations completed in the window, over its seconds."""


def read(run):
    return run.counts["ratings_iterations"] / run.window_s if run.window_s > 0 else None
