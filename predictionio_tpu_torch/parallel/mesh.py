"""The device mesh in one process: named axes over ``torch.device``
placements, and the four collectives the sharded paths use.

Counterpart of ``predictionio_tpu/parallel/mesh.py``. Where the JAX package
carries a :class:`jax.sharding.Mesh` and lets ``shard_map`` run one program
per device, the port carries an array of ``torch.device`` placements with
the same axis names (``data``, ``model``, ``host``) and runs the per-block
work as a loop over the placements' blocks:

* :func:`make_mesh` with no devices takes the distinct cards
  ``torch.cuda.device_count()`` gives (one on a one-card machine); an
  explicit ``devices=`` may repeat a device, so ``["cpu"] * 4`` or
  ``[cuda:0] * 4`` gives four placements on one device. That is how the
  tests (and ``chip_smoke.py`` on one card) give S shards S places, as the
  JAX tests do on eight host-platform CPU devices;
* :meth:`MeshContext.place` cuts a tensor along a spec into the blocks of
  the placements, flat in the mesh's row-major order; an axis the spec does
  not name replicates, and a repeated device holds one tensor for every
  placement that needs the same block;
* :func:`all_gather`, :func:`ppermute`, :func:`all_to_all` and
  :func:`psum` take and give lists of blocks, one per placement. They are
  tensor ops (``to``, ``stack``, ``cat``, ``+``), so autograd differentiates
  through them as the JAX collectives transpose;
* :attr:`MeshContext.spans_processes` is False: every placement is in this
  process. Meshes across processes (``torch.distributed``) come with ROADMAP
  §1 item 10's many-process half.

:class:`MeshContext` is also the port's one-device context
(``device.DeviceContext`` is this class): ``ctx.device`` is the first
placement, and :meth:`MeshContext.create` with ``device=`` gives a mesh of
that one device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Sequence, Union

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
# the cross-host dimension of a 2-D (host, data) pod mesh
HOST_AXIS = "host"

DeviceLike = Union[str, torch.device]


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= max(n, 1) — static-shape padding."""
    return max(1, math.ceil(max(n, 1) / m)) * m


def resolve_device(device: DeviceLike) -> torch.device:
    """A ``torch.device`` the port places on: ``cpu``, or ``cuda`` with its
    index; ``cuda`` without a card raises (nothing runs on the CPU by
    itself)."""
    dev = torch.device(device)
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
    return dev


def default_devices() -> list[torch.device]:
    """The distinct cards of this process, ``cuda:0`` first."""
    if not torch.cuda.is_available():
        resolve_device("cuda")  # raises, naming device='cpu'
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Placements in an array with named axes (``jax.sharding.Mesh``'s
    ``devices``, ``axis_names``, ``shape`` and ``size``)."""

    devices: np.ndarray  # object array of torch.device, one dim an axis
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def make_mesh(
    axes: Optional[Mapping[str, int]] = None,
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """Build a Mesh. Default: one ``data`` axis over every card.

    ``axes={"data": -1, "model": 2}`` lets one axis be inferred (-1) from
    the device count. ``devices`` may repeat a device.
    """
    devs = [resolve_device(d) for d in devices] if devices is not None else default_devices()
    n = len(devs)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    axes = dict(axes) if axes is not None else {DATA_AXIS: n}
    known = 1
    infer_key = None
    for k, v in axes.items():
        if v == -1:
            if infer_key is not None:
                raise ValueError("only one mesh axis may be -1")
            infer_key = k
        else:
            known *= v
    if infer_key is not None:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        axes[infer_key] = n // known
    total = math.prod(axes.values())
    if total != n:
        raise ValueError(f"mesh axes {axes} need {total} devices, have {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(tuple(axes.values())), tuple(axes.keys()))


def misaligned_pod_row(devices: Sequence[Any], host_groups: int) -> Optional[int]:
    """First host row whose devices span more than one process, else None.

    Folding ``devices`` row-major into ``host_groups`` rows, every row must
    be process-pure for the two-tier merge's on-host tier to stay on the
    host. A placement carries its process as ``process_index`` (0 for a
    ``torch.device``: every placement of this process)."""
    per_row = len(devices) // host_groups
    for g in range(host_groups):
        row = devices[g * per_row:(g + 1) * per_row]
        if len({getattr(d, "process_index", 0) for d in row}) > 1:
            return g
    return None


# -- the collectives, on lists of blocks (one per placement) -----------------


def all_gather(blocks: Sequence[torch.Tensor], device: DeviceLike) -> torch.Tensor:
    """The blocks stacked on ``device``: (n, *block.shape) — what
    ``lax.all_gather`` gives every device, here given to the one that
    merges."""
    dev = torch.device(device)
    return torch.stack([b.to(dev) for b in blocks])


def ppermute(
    blocks: Sequence[torch.Tensor],
    devices: Optional[Sequence[DeviceLike]] = None,
    shift: int = 1,
) -> list[torch.Tensor]:
    """The ring step ``perm = [(j, (j + shift) % n)]``: placement j receives
    the block of placement ``j - shift``, moved to ``devices[j]``."""
    n = len(blocks)
    out = [blocks[(j - shift) % n] for j in range(n)]
    if devices is not None:
        out = [b.to(torch.device(d)) for b, d in zip(out, devices)]
    return out


def all_to_all(
    blocks: Sequence[torch.Tensor],
    split_dim: int,
    concat_dim: int,
    devices: Optional[Sequence[DeviceLike]] = None,
) -> list[torch.Tensor]:
    """Tiled ``lax.all_to_all``: each block is cut into n chunks along
    ``split_dim``; placement j receives chunk j of every block, concatenated
    in placement order along ``concat_dim``."""
    n = len(blocks)
    chunks = [torch.chunk(b, n, dim=split_dim) for b in blocks]
    if any(len(c) != n or c[0].shape != c[-1].shape for c in chunks):
        raise ValueError(f"dim {split_dim} of {tuple(blocks[0].shape)} does not split {n} ways")
    out = []
    for j in range(n):
        dev = torch.device(devices[j]) if devices is not None else blocks[j].device
        out.append(torch.cat([chunks[i][j].to(dev) for i in range(n)], dim=concat_dim))
    return out


def psum(
    blocks: Sequence[torch.Tensor],
    devices: Optional[Sequence[DeviceLike]] = None,
) -> list[torch.Tensor]:
    """The sum of the blocks, in placement order, given to every placement
    (on ``devices[j]``, else the first block's device)."""
    dev0 = blocks[0].device
    total = blocks[0]
    for b in blocks[1:]:
        total = total + b.to(dev0)
    if devices is None:
        return [total] * len(blocks)
    return [total.to(torch.device(d)) for d in devices]


@dataclasses.dataclass
class MeshContext:
    """The compute context handed through the DASE pipeline (the JAX
    package's ``MeshContext``): the mesh, placement helpers, and ``conf``,
    the free-form deployment settings recorded on ``EngineInstance.
    mesh_conf`` (the device itself is never read from there when the
    caller names one, so a conf written by a CPU test cannot send a
    deployment on the card to the CPU)."""

    mesh: Mesh
    conf: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def create(
        conf: Optional[dict] = None,
        axes: Optional[Mapping[str, int]] = None,
        devices: Optional[Sequence[DeviceLike]] = None,
        device: Optional[DeviceLike] = None,
    ) -> "MeshContext":
        """``device=`` gives the one-device mesh (the port's entry points
        take ``device="cpu"`` this way); ``devices=`` an explicit mesh,
        repeats allowed; neither, every card. ``axes`` (or the conf's
        ``mesh_axes`` when no ``device`` is named) shape the mesh."""
        conf = dict(conf or {})
        if device is not None:
            if devices is not None:
                raise ValueError("pass device= or devices=, not both")
            devices = [device]
        elif axes is None and "mesh_axes" in conf:
            axes = {k: int(v) for k, v in conf["mesh_axes"].items()}
        return MeshContext(mesh=make_mesh(axes=axes, devices=devices), conf=conf)

    # -- placement helpers -------------------------------------------------
    @property
    def device(self) -> torch.device:
        """The first placement: where one-device work runs."""
        return self.mesh.devices.flat[0]

    @property
    def devices(self) -> list[torch.device]:
        """Every placement, in the mesh's row-major order."""
        return list(self.mesh.devices.flat)

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    def axis_size(self, axis: str) -> int:
        return self.mesh.shape.get(axis, 1)

    def submesh(self, n_devices: int, axis: str = DATA_AXIS) -> "MeshContext":
        """A context over the first ``n_devices`` placements, one ``axis``
        (a plan of S shards serves on the first S placements)."""
        if n_devices == self.mesh.size and self.mesh.axis_names == (axis,):
            return self
        if n_devices > self.mesh.size:
            raise ValueError(f"submesh of {n_devices} devices from a {self.mesh.size}-device mesh")
        return MeshContext(
            mesh=make_mesh(axes={axis: n_devices}, devices=self.devices[:n_devices]),
            conf=dict(self.conf),
        )

    def pod_submesh(self, n_shards: int, host_groups: int) -> "MeshContext":
        """A 2-D ``(host, data)`` context over the first ``n_shards``
        placements: ``host_groups`` rows of ``n_shards // host_groups``.
        A row whose placements span processes is refused, as the JAX
        package refuses it (callers fall back to the flat merge)."""
        if host_groups < 1 or n_shards % host_groups:
            raise ValueError(f"host_groups={host_groups} must divide n_shards={n_shards}")
        if n_shards > self.mesh.size:
            raise ValueError(
                f"pod submesh of {n_shards} devices from a {self.mesh.size}-device mesh"
            )
        devs = self.devices[:n_shards]
        bad = misaligned_pod_row(devs, host_groups)
        if bad is not None:
            raise ValueError(
                f"pod host row {bad} spans processes: {host_groups} host groups of "
                f"{n_shards // host_groups} shards do not align with the per-process "
                "device layout"
            )
        return MeshContext(
            mesh=make_mesh(axes={HOST_AXIS: host_groups, DATA_AXIS: n_shards // host_groups},
                           devices=devs),
            conf=dict(self.conf),
        )

    @property
    def spans_processes(self) -> bool:
        """Every placement of a port mesh lives in this process."""
        return False

    def place(self, x, *spec: Any) -> list[torch.Tensor]:
        """The per-placement blocks of ``x`` (a host array or a tensor)
        under ``spec``, flat in row-major mesh order.

        ``spec[d]`` names the axis (or a tuple of axes, major first) that
        dimension d is split over, or None; axes the spec does not name
        replicate. Placements that share a device and a block share one
        tensor, so ``place(x)`` gives the same tensor to every placement of
        a repeated device."""
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        names, shape = self.mesh.axis_names, self.mesh.devices.shape
        if len(spec) > t.dim():
            raise ValueError(f"spec {spec} is longer than the array's {t.dim()} dims")
        cache: dict = {}
        out = []
        for coord in np.ndindex(*shape):
            sl = [slice(None)] * t.dim()
            key = []
            for dim, ax in enumerate(spec):
                if ax is None:
                    continue
                idx, n = 0, 1
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    i = names.index(a)
                    idx, n = idx * shape[i] + coord[i], n * shape[i]
                if t.shape[dim] % n:
                    raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split {n} ways")
                step = t.shape[dim] // n
                sl[dim] = slice(idx * step, (idx + 1) * step)
                key.append((dim, idx))
            dev = self.mesh.devices[coord]
            k = (tuple(key), dev)
            if k not in cache:
                cache[k] = t[tuple(sl)].contiguous().to(dev)
            out.append(cache[k])
        return out

    def replicate(self, x: np.ndarray) -> torch.Tensor:
        """Host array → contiguous tensor on the first placement (one-device
        work; :meth:`place` gives every placement its copy)."""
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)


def device_get_global(x) -> np.ndarray:
    """Device → host. In one process every block is addressable, so this is
    a plain copy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
