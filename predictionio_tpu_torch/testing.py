"""The comparison rules of the port's checks, shared by the tests and
``chip_smoke.py``; neither serving nor training code calls them.

Two top-k results agree when their values agree within float rounding and
their indices agree, except where the dot products' summation order may
swap two near-equal scores. Inputs whose every dot product is exact
(integer-valued factors) must agree bit for bit, tie order included.

Two sets of normal equations agree when each entry of ``A`` and ``b``
differs by at most ``rtol`` times the sum of the absolute values of the
products behind it (the bound a change of summation order can reach, which
grows with the bucket width) plus ``atol``, and ``cnt`` is equal.

On the card the training kernel is held to two such rules, set from the
gaps measured on an H100 at the ML-25M shape and on the edge cases
(``PERF.md`` §6): against the same operands summed in float64
(``train_normal_eq_reference(..., accumulate=torch.float64)``) the kernel
stayed within 5.6e-7 of the summed magnitudes, and the plain version
within 8.7e-5, because its float32 sums run over whole rows of up to
96,168 slots. Each rule leaves room above its reading.
"""

from __future__ import annotations

import numpy as np
import torch

# kernel vs float64 sums (18× its largest reading)
KERNEL_VS_FLOAT64_RTOL = 1e-5
# kernel vs the float32 plain version (3.4× the plain version's reading)
KERNEL_VS_PLAIN_RTOL = 3e-4


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


def normal_eq_magnitudes(idx, rat, msk, V, v_scale=None, *, implicit, alpha):
    """``(Σ|x_k·y_l|, Σ|z_k·w|)`` per output of the training kernel: the
    plain version on the absolute values of its operands (rounding to bf16
    commutes with the sign, and ``msk`` is 1/0)."""
    from predictionio_tpu_torch.ops.train_kernel import train_normal_eq_reference

    A, b, _ = train_normal_eq_reference(
        idx, rat.abs(), msk, V.abs(), v_scale, implicit=implicit, alpha=abs(alpha)
    )
    return A, b


def normal_eq_mismatches(got, ref, magnitudes, rtol=1e-4, atol=1e-6) -> list[str]:
    """Why two ``(A, b, cnt)`` results disagree beyond summation order;
    empty when they agree. ``magnitudes`` comes from
    :func:`normal_eq_magnitudes` on the same inputs."""
    out = []
    for name, g, r, m in zip(("A", "b"), got[:2], ref[:2], magnitudes):
        excess = (g - r).abs() - (rtol * m + atol)
        if bool((excess > 0).any()) or not bool(torch.isfinite(g).all()):
            worst = int(excess.reshape(-1).argmax())
            out.append(
                f"{name}: entry {worst} differs by "
                f"{float((g - r).reshape(-1)[worst])} (allowed "
                f"{float(rtol * m.reshape(-1)[worst] + atol)})"
            )
    if not torch.equal(got[2], ref[2]):
        out.append(f"cnt differs at {int((got[2] != ref[2]).sum())} rows")
    return out
