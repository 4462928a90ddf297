"""DeviceContext: the compute context handed through the DASE pipeline.

The port's context is :class:`~predictionio_tpu_torch.parallel.mesh.
MeshContext` (the JAX package's ``parallel/mesh.py`` ``MeshContext``);
``DeviceContext`` is that class under the name the port's entry points have
always used. ``DeviceContext.create(device=...)`` gives a mesh of one
placement, ``ctx.device``, which is where one-device work runs; an explicit
``devices=`` list (repeats allowed) gives the sharded paths their
placements.

The device is ``cuda`` unless the caller asks for the CPU explicitly
(``device="cpu"``, as the CPU tests do). A context that asks for CUDA on a
machine without it raises: serving never carries on on the CPU by itself.
"""

from __future__ import annotations

from predictionio_tpu_torch.parallel.mesh import MeshContext

DeviceContext = MeshContext

__all__ = ["DeviceContext", "MeshContext"]
