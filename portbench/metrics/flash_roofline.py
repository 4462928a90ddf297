"""Kernels 4-6's share of their roofline: the least time of each traced
layer's causal attention forward and backward (``costs/attention.py``) over
the three kernels' device time there, in %."""

from portbench.costs import attention, peaks


def read(run):
    seconds, counts = run.kernel_seconds("flash")
    if not seconds or not counts.get("steps"):
        return None
    s = run.shapes
    bound, _ = peaks.bound_s(*attention.cost(s["batch"] * s["n_heads"], s["t"],
                                             s["d"] // s["n_heads"]))
    return 100.0 * bound * s["n_layers"] * counts["steps"] / seconds
