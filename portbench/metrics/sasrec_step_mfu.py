"""The SASRec steps' model operations (``costs/sasrec_step.py``) over the
seconds of the untraced rest of the window and the card's f32 peak, in %."""

from portbench.costs import peaks, sasrec_step


def read(run):
    steps = run.rest_counts.get("steps", 0)
    if not steps or run.rest_s <= 0:
        return None
    s = run.shapes
    per_step = sasrec_step.flops(s["batch"], s["t"], s["d"], s["n_layers"], s["n_items"],
                                 run.rest_counts["loss_positions"] / steps)
    return 100.0 * per_step * steps / (run.rest_s * peaks.F32_FLOP_S)
