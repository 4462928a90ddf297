"""The comparison rules of the port's checks, shared by the tests and
``chip_smoke.py``; neither serving nor training code calls them.

Two top-k results agree when their values agree within float rounding and
their indices agree, except where the dot products' summation order may
swap two near-equal scores. Inputs whose every dot product is exact
(integer-valued factors) must agree bit for bit, tie order included.

Two LLR top-k lists agree (``llr_topk_mismatches``) when each value is
within ``llr_atol(T) + LLR_RTOL·|v|`` of the float64 LLR computed from the
same exact counts, and each index is the float64 reference's, except where
the two items' float64 values lie within twice that tolerance of each
other: each side may stand that far off the float64 value. The absolute
part is ``LLR_ULPS`` ulp of ``T·ln T`` in float32: every entropy term holds
it, and ``log`` differs in the last bit between XLA, torch's CPU and
CUDA's ``logf``, so the cancellation leaves a few of its ulp.

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


LLR_RTOL = 1e-5
LLR_ULPS = 8


def llr_atol(total: float) -> float:
    """``LLR_ULPS`` float32 ulp of ``T·ln T`` (ROADMAP §3's LLR rule)."""
    t = float(total)
    return LLR_ULPS * float(np.spacing(np.float32(t * np.log(t)))) if t > 1 else 0.0


def llr_reference64(C, primary_counts, secondary_counts, total) -> np.ndarray:
    """Dunning's G² in float64 from exact counts: ``C`` (p, s), the distinct
    user counts of the two sides, ``T`` users (the formula of
    ``models.cooccurrence.llr_cross_scores``)."""
    C = np.asarray(C, np.float64)
    pc = np.asarray(primary_counts, np.float64)[:, None]
    sc = np.asarray(secondary_counts, np.float64)[None, :]
    k11, k12, k21 = C, np.maximum(pc - C, 0), np.maximum(sc - C, 0)
    k22 = np.maximum(float(total) - pc - sc + C, 0)

    def xlogx(x):
        return np.where(x > 0, x * np.log(np.where(x > 0, x, 1.0)), 0.0)

    def entropy(*ks):
        return xlogx(sum(ks)) - sum(xlogx(k) for k in ks)

    h = entropy(k11 + k12, k21 + k22) + entropy(k11 + k21, k12 + k22) - entropy(k11, k12, k21, k22)
    return np.where(C > 0, 2.0 * np.maximum(h, 0.0), 0.0)


def llr_topk_mismatches(got_i, got_v, ref_scores, atol: float,
                        rtol: float = LLR_RTOL) -> list[str]:
    """Why one indicator's top-k (``got_i``, ``got_v``, scores floored at 0
    as the models store them) breaks the LLR rule against ``ref_scores``,
    the float64 scores of every primary item for that indicator (-1 where
    the item may not be listed: the diagonal, padding); empty when it
    holds. The reference order is value descending, then smaller index."""
    got_i = np.asarray(got_i, np.int64)
    got_v = np.asarray(got_v, np.float64)
    ref = np.asarray(ref_scores, np.float64)
    order = np.lexsort((np.arange(len(ref)), -ref))[: len(got_i)]
    out = []
    for c, (g, r) in enumerate(zip(got_i, order)):
        tol = atol + rtol * abs(ref[r])
        if not 0 <= g < len(ref):
            out.append(f"slot {c}: index {g} out of range")
            continue
        if abs(got_v[c] - max(ref[g], 0.0)) > atol + rtol * abs(ref[g]):
            out.append(f"slot {c}: value {got_v[c]} vs float64 {ref[g]} (item {g})")
        if g != r and abs(ref[g] - ref[r]) > 2 * tol:
            out.append(f"slot {c}: item {g} ({ref[g]}) vs {r} ({ref[r]})")
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


def warm_cpu_math() -> None:
    """Run torch's vectorized CPU transcendentals once, before any check.

    With torch 2.13.0+cpu and eight intra-op threads, the first parallel
    ``exp`` or ``log`` of a process returned values up to ~1.5e-4 relative
    off in about one process in fifty; single threaded, and from the second
    call on, they were exact to the last bit or two. A check whose first
    transcendental is that call fails a 1e-5 rule for a reason outside the
    code under test (``chip_smoke.py``'s SASRec parity phase holds a CPU
    training to the card's at 1e-4 and can fail so), so the tests and
    ``chip_smoke.py`` make the first call here. ROADMAP §3 logs the
    finding."""
    for dtype in (torch.float32, torch.float64):
        x = torch.linspace(0.01, 30.0, 1 << 17, dtype=dtype)
        for op in (torch.exp, torch.log, torch.log1p, torch.expm1):
            op(x)
        torch.logaddexp(x, x)
