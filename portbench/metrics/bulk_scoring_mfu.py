"""Bulk scoring's operations, 2 · users · items · rank, over the seconds of
the untraced rest of the window and the card's f32 peak, in %."""

from portbench.costs import kernel1, peaks


def read(run):
    users = run.rest_counts.get("users", 0)
    if not users or run.rest_s <= 0:
        return None
    s = run.shapes
    flops = kernel1.cost(users, s["n_items"], s["rank"], s["k"])[0]
    return 100.0 * flops / (run.rest_s * peaks.F32_FLOP_S)
