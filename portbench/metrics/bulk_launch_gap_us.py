"""Mean device idle µs between two consecutive kernel-1 launches in the
traced stretch (the profiler's trace): from one ``score_select``'s end to
the next one's start, less any device work between them (the readback's
copies). It is the fast path's host work between dispatches as the device
sees it. The profiler's host overhead stretches that work, so it reads
above an untraced run's gap."""


def read(run):
    p = run.profile
    if p is None:
        return None
    names = run.kernels.get("kernel1", ((), ()))[0]
    gaps = p.idle_between(names)
    return sum(gaps) / len(gaps) if gaps else None
