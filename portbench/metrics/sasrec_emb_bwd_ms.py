"""Device ms a step of the ``emb[seq]`` gather's backward: the kernels the
autograd node ``IndexBackward0`` launched in the traced stretch (the
profiler, by op), over the steps traced."""


def read(run):
    p = run.profile
    if p is None or not p.units:
        return None
    s = p.device_s_under("IndexBackward0")
    return 1e3 * s / p.units if s > 0 else None
