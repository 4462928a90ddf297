"""Kernel 2's share of its roofline: the least time of the traced
iterations' normal equations (``costs/kernel2.py``) over the kernel's device
time there, in %."""

from portbench.costs import kernel2, peaks


def read(run):
    seconds, counts = run.kernel_seconds("kernel2")
    if not seconds or not counts.get("iterations"):
        return None
    s = run.shapes
    bound, _ = peaks.bound_s(*kernel2.cost(s["n_ratings"], s["n_users"], s["n_items"], s["rank"]))
    return 100.0 * bound * counts["iterations"] / seconds
