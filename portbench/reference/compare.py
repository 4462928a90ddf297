"""The numbers that decide ``correct``: each a gap between what the program
produced and what the reference works out, on a scale the reference sets.
Each is compared with its cell's limit (``limits/<workload>.json``)."""

from __future__ import annotations

import math

import numpy as np
import torch

INF = float("inf")


def factor_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The worst row's distance from the reference, over the larger of that
    row's reference norm and the median row norm (rows near zero would
    otherwise be judged by their rounding alone)."""
    ref = reference.double()
    norms = ref.norm(dim=1)
    scale = torch.clamp(norms, min=float(norms.median()) or 1.0)
    if program.shape != reference.shape:
        return INF
    d = (program.double() - ref).norm(dim=1) / scale
    return float(d.max()) if torch.isfinite(d).all() else INF


def topk_gaps(idx: torch.Tensor, val: torch.Tensor,
              ref_scores: torch.Tensor) -> tuple[float, float]:
    """(rank gap, value gap) of answers ``idx``/``val`` (B, k) against the
    reference's scores (B, n_items) of the same users, each over the row's
    best reference score in magnitude:

    * rank gap: how far the j-th answer's reference score lies below the
      reference's j-th best, at the worst j; an answer that repeats an item
      or names none is infinitely far;
    * value gap: how far a returned score lies from its item's reference
      score."""
    b, k = idx.shape
    n = ref_scores.shape[1]
    if val.shape != idx.shape or ref_scores.shape[0] != b:
        return INF, INF
    idx = idx.long()
    if bool(((idx < 0) | (idx >= n)).any()):
        return INF, INF
    sorted_idx = idx.sort(dim=1).values
    if bool((sorted_idx[:, 1:] == sorted_idx[:, :-1]).any()):
        return INF, INF
    best = ref_scores.topk(k, dim=1).values
    got = ref_scores.gather(1, idx)
    scale = best[:, :1].abs().clamp_min(1e-30)
    rank = ((best - got) / scale).max()
    value = ((val.to(ref_scores.dtype) - got).abs() / scale).max()
    out = float(rank), float(value)
    return tuple(x if math.isfinite(x) else INF for x in out)


def leaf_norm_gap(program: dict, reference: dict, leaves=None) -> float:
    """The worst leaf's gap between the program's norm and the reference's
    (not the norm of their difference), over the larger of the leaf's
    reference norm and the median leaf's."""
    names = list(reference) if leaves is None else list(leaves)
    if not names:
        return INF
    median = float(np.median([reference[k] for k in reference]))
    worst = 0.0
    for k in names:
        if k not in program or not math.isfinite(program[k]):
            return INF
        worst = max(worst, abs(program[k] - reference[k]) / max(reference[k], median, 1e-30))
    return worst


def moving_leaves(grad_norms: dict) -> list:
    """Leaves whose reference gradient is above a thousandth of the median
    leaf's: the others move under Adam by rounding alone."""
    median = float(np.median(list(grad_norms.values())))
    return [k for k, g in grad_norms.items() if g >= 1e-3 * median]


def train_numbers(program: dict, reference: dict) -> dict:
    """A training cell's three numbers: the worst step's relative loss gap,
    the first gradient's worst leaf, and the change's worst moving leaf."""
    lp, lr = program["losses"], reference["losses"]
    if len(lp) != len(lr):
        loss = INF
    else:
        loss = max((abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lp, lr)), default=INF)
        loss = loss if math.isfinite(loss) else INF
    return {
        "loss_gap": loss,
        "grad_gap": leaf_norm_gap(program["grad_norms"], reference["grad_norms"]),
        "change_gap": leaf_norm_gap(program["change_norms"], reference["change_norms"],
                                    moving_leaves(reference["grad_norms"])),
    }


def train_details(program: dict, reference: dict, top: int = 3) -> dict:
    """What a training cell's numbers are made of: each step's loss gap and
    the leaves with the widest gradient and change gaps."""
    median_g = float(np.median(list(reference["grad_norms"].values())))
    median_c = float(np.median(list(reference["change_norms"].values())))

    def worst(kind, median, names):
        gaps = {k: abs(program[kind].get(k, INF) - reference[kind][k])
                / max(reference[kind][k], median, 1e-30) for k in names}
        return sorted(((k, gaps[k]) for k in gaps), key=lambda kv: -kv[1])[:top]

    return {
        "loss_gap_by_step": [abs(a - b) / max(abs(b), 1e-30)
                             for a, b in zip(program["losses"], reference["losses"])],
        "grad_gap_worst_leaves": worst("grad_norms", median_g, list(reference["grad_norms"])),
        "change_gap_worst_leaves": worst("change_norms", median_c,
                                         moving_leaves(reference["grad_norms"])),
        "leaves_left_out_of_change": sorted(set(reference["grad_norms"])
                                            - set(moving_leaves(reference["grad_norms"]))),
    }
