"""The device's idle share in the untraced rest of the window of
SASRec training steps, in %: 1 - the busy time (the union of device
activity) a unit in the traced stretch, times the rest's units, over the
rest's seconds (``Run.idle_percent``)."""


def read(run):
    return run.idle_percent()
