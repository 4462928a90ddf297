"""Parallel helpers: the JAX package's ``predictionio_tpu.parallel`` names,
the port's own objects (the mesh in one process)."""

from predictionio_tpu_torch.parallel.mesh import MeshContext, make_mesh, pad_to_multiple

__all__ = ["MeshContext", "make_mesh", "pad_to_multiple"]
