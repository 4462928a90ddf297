"""Kernel 1's share of its roofline: the least time of the traced
launches for their real users (``costs/kernel1.py``) over the kernel's
device time there, in %."""

from portbench.costs import kernel1, peaks


def read(run):
    seconds, counts = run.kernel_seconds("kernel1")
    if not seconds or not counts.get("chunk_users"):
        return None
    s = run.shapes
    bound = sum(n * peaks.bound_s(*kernel1.cost(users, s["n_items"], s["rank"], s["k"]))[0]
                for users, n in counts["chunk_users"].items())
    return 100.0 * bound / seconds
