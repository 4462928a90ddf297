"""Causal attention of one layer, forward and backward together (kernels
4-6), f32: ``bh`` batch·head rows of length ``t`` at head size ``d``.

Bytes: the forward reads q, k, v and writes o; the backward reads q, k, v,
o and do and writes dq, dk, dv: 12·bh·t·d·4 B. What one implementation keeps
besides (the log-sum-exp, the row term, split scratch) is not counted, nor
is a product recomputed. Operations: the forward's two products and the
backward's four, each over the causal half of the t × t scores:
6·bh·t²·d."""


def cost(bh: int, t: int, d: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one layer's attention forward and backward."""
    flops = 6.0 * bh * t * t * d
    nbytes = 12.0 * bh * t * d * 4.0
    return flops, nbytes
