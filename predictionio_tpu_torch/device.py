"""DeviceContext: the compute context handed through the DASE pipeline.

Counterpart of ``predictionio_tpu/parallel/mesh.py`` ``MeshContext``: where
the JAX package carries a device mesh and placement helpers, the port runs
on ONE card and carries the ``torch.device`` to place tensors on. There is
no mesh and no sharding in this slice.

The device is ``cuda`` unless the caller asks for the CPU explicitly
(``device="cpu"``, as the CPU tests do). A context that asks for CUDA on a
machine without it raises: serving never carries on on the CPU by itself.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch


@dataclasses.dataclass
class DeviceContext:
    device: torch.device
    # free-form deployment settings recorded on EngineInstance.mesh_conf;
    # the device itself is never read from here, so a conf written by a
    # CPU test cannot send a deployment on the card to the CPU
    conf: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def create(
        conf: Optional[dict] = None,
        device: Union[str, torch.device, None] = None,
    ) -> "DeviceContext":
        dev = torch.device(device if device is not None else "cuda")
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DeviceContext: no CUDA device is available; pass "
                    "device='cpu' to run the plain PyTorch versions"
                )
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.type != "cpu":
            raise ValueError(f"unsupported device {dev}")
        return DeviceContext(device=dev, conf=dict(conf or {}))

    @property
    def n_devices(self) -> int:
        return 1

    def replicate(self, x: np.ndarray) -> torch.Tensor:
        """Host array → contiguous tensor on the context's device."""
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
