"""Parallel helpers: the JAX package's ``predictionio_tpu.parallel`` names
the port has. ``MeshContext`` and ``make_mesh`` wait for the multi-GPU
slice (ROADMAP §1 item 10)."""

from predictionio_tpu_torch.parallel.mesh import pad_to_multiple

__all__ = ["pad_to_multiple"]
