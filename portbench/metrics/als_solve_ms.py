"""Device ms an iteration of the kernels ``_solve_normal_equations``
launches (the profiler's trace, by the range the probe puts around the
function), both half-steps, over the traced iterations."""


def read(run):
    p, its = run.profile, run.trace_counts.get("iterations")
    if p is None or not its:
        return None
    s = p.device_s_under("portbench.solve")
    return 1e3 * s / its if s > 0 else None
