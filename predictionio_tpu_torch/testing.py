"""The comparison rule of the port's checks, shared by the tests and
``chip_smoke.py``; no serving code calls it.

Two top-k results agree when their values agree within float rounding and
their indices agree, except where the dot products' summation order may
swap two near-equal scores. Inputs whose every dot product is exact
(integer-valued factors) must agree bit for bit, tie order included.
"""

from __future__ import annotations

import numpy as np


def topk_mismatches(
    got_v: np.ndarray,
    got_i: np.ndarray,
    ref_v: np.ndarray,
    ref_i: np.ndarray,
    tol: float = 1e-5,
) -> list[str]:
    """Why two (B, k) top-k results disagree beyond float rounding; empty
    when they agree.

    The rule of the port's comparisons, stated once: values agree within
    ``rtol = atol = tol``; indices agree exactly, except that a position
    may hold another index where the reference value there has a
    neighbour within the tolerance (two scores the dot products' summation
    order can swap) and the two values at that position agree. Pass
    ``tol=0`` for inputs whose every dot product is exact (integer-valued
    factors): indices, tie order included, must then be identical.
    """
    got_v, got_i = np.asarray(got_v, np.float64), np.asarray(got_i)
    ref_v, ref_i = np.asarray(ref_v, np.float64), np.asarray(ref_i)
    if got_v.shape != ref_v.shape or got_i.shape != ref_i.shape:
        return [f"shape {got_v.shape}/{got_i.shape} vs {ref_v.shape}/{ref_i.shape}"]
    out = []
    slack = tol + tol * np.abs(ref_v)
    bad_v = np.abs(got_v - ref_v) > slack
    for r, c in zip(*np.nonzero(bad_v)):
        out.append(f"row {r} slot {c}: value {got_v[r, c]} vs {ref_v[r, c]}")
    for r, c in zip(*np.nonzero(got_i != ref_i)):
        row = ref_v[r]
        near = [
            j for j in (c - 1, c + 1)
            if 0 <= j < row.shape[0] and abs(row[j] - row[c]) <= slack[r, c]
        ]
        boundary = c == row.shape[0] - 1 and tol > 0
        if tol == 0 or not (near or boundary):
            out.append(
                f"row {r} slot {c}: index {got_i[r, c]} vs {ref_i[r, c]}"
            )
    return out
