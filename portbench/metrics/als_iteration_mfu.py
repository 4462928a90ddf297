"""The ALS iterations' operations (``costs/als_iteration.py``) over the
seconds of the untraced rest of the window and the card's f32 peak, in %."""

from portbench.costs import als_iteration, peaks


def read(run):
    its = run.rest_counts.get("iterations", 0)
    if not its or run.rest_s <= 0:
        return None
    s = run.shapes
    flops = als_iteration.flops(s["n_ratings"], s["n_users"], s["n_items"], s["rank"]) * its
    return 100.0 * flops / (run.rest_s * peaks.F32_FLOP_S)
