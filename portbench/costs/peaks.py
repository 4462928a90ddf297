"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity, at its full
700 W power limit) and the least time a piece of work could take.

f32 work is held against the TF32 tensor-core rate, 495 TFLOP/s, not the
67 TFLOP/s of the f32 units: an f32-accurate product may run on the tensor
cores (3xTF32 does, in kernels 4-6), so a share taken at the lower rate
could pass 100% after a legitimate change. A share is then the share of the
fastest rate f32-accurate work can be given on this card."""

HBM_BYTES_S = 3.35e12
F32_FLOP_S = 495e12


def bound_s(flops: float, nbytes: float) -> tuple[float, str]:
    """(seconds, what bounds it): the larger of bytes over the memory rate
    and operations over the f32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / F32_FLOP_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
