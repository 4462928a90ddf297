"""Ring attention: exact attention with the sequence split over a mesh axis.

Counterpart of ``predictionio_tpu/parallel/ring.py``. The sequence axis is
cut into one block a placement of the axis; each placement keeps its query
block while the key/value blocks go round the ring (:func:`~predictionio_tpu_
torch.parallel.mesh.ppermute`), and each merges its queries' attention over
every block it meets:

* :func:`_ring_attention_block` is the dense ring, the online-softmax update
  (running max ``m``, denominator ``l``, numerator ``o``) over lists of the
  placements' blocks, with causal masks by GLOBAL block offsets, so the
  result equals whole-sequence attention; :func:`ring_attention` wraps it.
  SASRec's ``seq_parallel`` loss runs it, as the JAX package does;
* :func:`ring_flash_attention` runs the flash kernels instead of the dense
  score tile: a ``torch.autograd.Function`` whose forward launches kernel 4
  (``ops/flash_attention.flash_block_fwd``) once per live (query block, key
  block) pair — the diagonal block causal, past blocks full, future blocks
  skipped under a causal mask, so n(n+1)/2 launches causal and n² full — and
  merges the (o, lse) pairs with ``logaddexp`` in float32. Its backward sends
  k and v round the ring once more with their dk/dv accumulators and calls
  ``flash_block_bwd`` (kernels 5 and 6, one launch each per live pair) with
  the saved GLOBAL o and lse, so each pair gives exactly its share of the
  gradients;
* :func:`full_attention` is dense attention on one device.

Every function takes whole (..., T, D) tensors (or host arrays), cuts them
into blocks on the axis's placements (the first placement of every other
axis) and returns the whole result on the first placement. A length the
axis does not divide raises, as do flash blocks that do not divide the
local length.

There is one dense implementation in the port: :func:`full_attention` is
the output of the flash kernel's plain version
(:func:`~predictionio_tpu_torch.ops.flash_attention.flash_attention_reference`),
which scales q before the product as the kernel does; the JAX function
scales the product, a difference of float32 rounding.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.ops import flash_attention as _fa
from predictionio_tpu_torch.ops.flash_attention import flash_attention_reference
from predictionio_tpu_torch.parallel.mesh import MeshContext, ppermute

NEG_INF = -1e30


def axis_devices(ctx: MeshContext, axis: str) -> list[torch.device]:
    """The placements along ``axis``, every other axis at its first index."""
    names = ctx.mesh.axis_names
    if axis not in names:
        return [ctx.device]
    index = [0] * len(names)
    index[names.index(axis)] = slice(None)
    return list(ctx.mesh.devices[tuple(index)])


def _blocks(x, devices: Sequence[torch.device]) -> list[torch.Tensor]:
    """(..., T, D) → one contiguous (..., T/n, D) block a placement."""
    x = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
    return [b.contiguous().to(d) for b, d in zip(torch.chunk(x, len(devices), dim=-2), devices)]


def _check_length(t: int, n: int) -> None:
    if t % n:
        raise ValueError(f"sequence length {t} not divisible by {n} shards")


def _ring_attention_block(
    q: Sequence[torch.Tensor],
    k: Sequence[torch.Tensor],
    v: Sequence[torch.Tensor],
    causal: bool,
    scale: Optional[float] = None,
    devices: Optional[Sequence[torch.device]] = None,
) -> list[torch.Tensor]:
    """The dense ring over the n placements' blocks: q, k, v are lists of
    (..., T_local, D) blocks, placement j holding block j; returns the
    placements' (..., T_local, D) outputs. Differentiable (torch ops and
    :func:`ppermute`)."""
    n = len(q)
    t_local, d = q[0].shape[-2], q[0].shape[-1]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    o = [torch.zeros_like(qj) for qj in q]
    m = [torch.full(qj.shape[:-1], NEG_INF, dtype=qj.dtype, device=qj.device) for qj in q]
    l = [torch.zeros(qj.shape[:-1], dtype=qj.dtype, device=qj.device) for qj in q]
    kb, vb = list(k), list(v)
    for step in range(n):
        for j in range(n):
            # the block placement j holds started at placement (j - step) % n
            src = (j - step) % n
            s = torch.einsum("...qd,...kd->...qk", q[j], kb[j]) * scale
            if causal:
                q_pos = j * t_local + torch.arange(t_local, device=s.device)
                k_pos = src * t_local + torch.arange(t_local, device=s.device)
                s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                                torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m[j], s.amax(-1))
            # rescale the accumulators to the new max
            alpha = torch.exp(m[j] - m_new)
            p = torch.exp(s - m_new[..., None])
            l[j] = l[j] * alpha + p.sum(-1)
            o[j] = o[j] * alpha[..., None] + torch.einsum("...qk,...kd->...qd", p, vb[j])
            m[j] = m_new
        kb, vb = ppermute(kb, devices), ppermute(vb, devices)
    return [oj / torch.clamp(lj, min=1e-30)[..., None] for oj, lj in zip(o, l)]


def ring_attention(
    ctx: MeshContext,
    q,
    k,
    v,
    axis: str = "data",
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact attention with the sequence split over mesh axis ``axis``: the
    dense ring. q/k/v (..., T, D), T divisible by the axis size; returns
    (..., T, D) on the first placement."""
    devices = axis_devices(ctx, axis)
    _check_length(q.shape[-2], len(devices))
    out = _ring_attention_block(
        _blocks(q, devices), _blocks(k, devices), _blocks(v, devices), causal, scale, devices
    )
    return torch.cat([o.to(devices[0]) for o in out], dim=-2)


# -- ring + the flash kernels ------------------------------------------------


def _pair_causal(src: int, j: int, causal: bool) -> Optional[bool]:
    """A ring step by block relation: past → full (False), self → diagonal
    causal (True), future → skipped (None); without a mask every pair is
    full."""
    if not causal:
        return False
    if src == j:
        return True
    return False if src < j else None


def _ring_flash_fwd_impl(q, k, v, causal, scale, devices):
    """The forward over lists of blocks: one ``flash_block_fwd`` a live
    pair, merged in float32 with ``logaddexp``. Returns the placements'
    (o in q's dtype, lse float32) lists."""
    n = len(q)
    o = [torch.zeros(qj.shape, dtype=torch.float32, device=qj.device) for qj in q]
    lse = [torch.full(qj.shape[:-1], NEG_INF, dtype=torch.float32, device=qj.device) for qj in q]
    kb, vb = list(k), list(v)
    for step in range(n):
        for j in range(n):
            pair = _pair_causal((j - step) % n, j, causal)
            if pair is None:  # a skipped block adds exp(NEG_INF - lse) = 0
                continue
            o_b, lse_b = _fa.flash_block_fwd(q[j], kb[j], vb[j], pair, scale)
            lse_b = lse_b.to(torch.float32)
            lse_new = torch.logaddexp(lse[j], lse_b)
            o[j] = (o[j] * torch.exp(lse[j] - lse_new)[..., None]
                    + o_b.to(torch.float32) * torch.exp(lse_b - lse_new)[..., None])
            lse[j] = lse_new
        kb, vb = ppermute(kb, devices), ppermute(vb, devices)
    return [oj.to(qj.dtype) for oj, qj in zip(o, q)], lse


def _ring_flash_bwd_impl(q, k, v, o, lse, do, causal, scale, devices):
    """The ring backward: k and v go round once more with their dk/dv
    accumulators (float32), each live pair adding its ``flash_block_bwd``
    share computed with the pair's global o and lse; after n steps every
    accumulator is back with its block's placement."""
    n = len(q)
    dq = [torch.zeros(qj.shape, dtype=torch.float32, device=qj.device) for qj in q]
    dk = [torch.zeros(kj.shape, dtype=torch.float32, device=kj.device) for kj in k]
    dv = [torch.zeros(vj.shape, dtype=torch.float32, device=vj.device) for vj in v]
    kb, vb = list(k), list(v)
    for step in range(n):
        for j in range(n):
            pair = _pair_causal((j - step) % n, j, causal)
            if pair is None:
                continue
            dq_c, dk_c, dv_c = _fa.flash_block_bwd(q[j], kb[j], vb[j], o[j], lse[j], do[j], pair,
                                                   scale)
            dq[j] = dq[j] + dq_c.to(torch.float32)
            dk[j] = dk[j] + dk_c.to(torch.float32)
            dv[j] = dv[j] + dv_c.to(torch.float32)
        kb, vb, dk, dv = (ppermute(x, devices) for x in (kb, vb, dk, dv))
    return ([x.to(q[0].dtype) for x in dq], [x.to(k[0].dtype) for x in dk],
            [x.to(v[0].dtype) for x in dv])


class _RingFlash(torch.autograd.Function):
    """The JAX ``_ring_flash`` custom VJP: the forward saves the blocks, o
    and the global lse; the backward is the ring backward."""

    @staticmethod
    def forward(fctx, q, k, v, devices, causal, scale):
        qb, kb, vb = (_blocks(x, devices) for x in (q, k, v))
        ob, lse = _ring_flash_fwd_impl(qb, kb, vb, causal, scale, devices)
        fctx.save_for_backward(*qb, *kb, *vb, *ob, *lse)
        fctx.n, fctx.devices, fctx.causal, fctx.scale = len(devices), devices, causal, scale
        return torch.cat([x.to(devices[0]) for x in ob], dim=-2)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(fctx, do):
        n, saved = fctx.n, fctx.saved_tensors
        qb, kb, vb, ob, lse = (list(saved[i * n:(i + 1) * n]) for i in range(5))
        dob = _blocks(do, fctx.devices)
        dq, dk, dv = _ring_flash_bwd_impl(qb, kb, vb, ob, lse, dob, fctx.causal, fctx.scale,
                                          fctx.devices)
        first = fctx.devices[0]
        return (*(torch.cat([x.to(first) for x in g], dim=-2) for g in (dq, dk, dv)),
                None, None, None)


def _check_flash_blocks(q, n: int, block_q: Optional[int], block_k: Optional[int]):
    t = q.shape[-2]
    _check_length(t, n)
    t_local = t // n
    bq = min(block_q or _fa.BLOCK_Q, t_local)
    bk = min(block_k or _fa.BLOCK_K, t_local)
    if t_local % bq or t_local % bk:
        raise ValueError(f"flash block sizes ({bq}, {bk}) must divide local block length {t_local}")


def ring_flash_attention(
    ctx: MeshContext,
    q,
    k,
    v,
    axis: str = "data",
    causal: bool = False,
    scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Exact attention, sequence split over ``axis``, the flash kernels
    inside: the contract of :func:`ring_attention`, forward and backward
    (the ring backward). ``block_q``/``block_k`` are the JAX package's
    block sizes, checked against the local length as it checks them (the
    port's kernels tile themselves). On CUDA blocks every live pair
    launches kernel 4 (and 5, 6 in the backward) or raises; on CPU blocks
    their plain versions run."""
    devices = axis_devices(ctx, axis)
    _check_flash_blocks(q, len(devices), block_q, block_k)
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    q, k, v = (torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
               for x in (q, k, v))
    return _RingFlash.apply(q, k, v, tuple(devices), bool(causal), float(scale))


def full_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Dense softmax attention, q/k/v (..., T, D) → (..., T_q, D), any
    length, on any device."""
    return flash_attention_reference(q, k, v, causal, scale)[0]
