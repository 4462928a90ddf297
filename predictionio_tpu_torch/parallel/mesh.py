"""The device mesh: named axes over ``torch.device`` placements, in one
process or across the processes of a launch, and the four collectives the
sharded paths use.

Counterpart of ``predictionio_tpu/parallel/mesh.py``. Where the JAX package
carries a :class:`jax.sharding.Mesh` and lets ``shard_map`` run one program
per device, the port carries an array of placements with the same axis
names (``data``, ``model``, ``host``) and runs the per-block work as a loop
over this process's blocks:

* :func:`make_mesh` with no devices takes the distinct cards
  ``torch.cuda.device_count()`` gives (one on a one-card machine); an
  explicit ``devices=`` may repeat a device, so ``["cpu"] * 4`` or
  ``[cuda:0] * 4`` gives four placements on one device. That is how the
  tests (and ``chip_smoke.py`` on one card) give S shards S places, as the
  JAX tests do on eight host-platform CPU devices;
* under a launch (``parallel/distributed.py`` initialized with N > 1
  processes) :meth:`MeshContext.create` spans the processes: the global
  placements are each process's own placements in process order, as
  :class:`Placement` records (``process_index``, ``device``), and
  :attr:`MeshContext.spans_processes` is True. Every process names the same
  local placements (one by default, its card or the CPU);
* :meth:`MeshContext.place` cuts a tensor along a spec into the blocks of
  this process's placements, flat in the mesh's row-major order; an axis
  the spec does not name replicates, and a repeated device holds one tensor
  for every placement that needs the same block;
* :func:`all_gather`, :func:`ppermute`, :func:`all_to_all` and
  :func:`psum` take and give lists of blocks, one per placement of this
  process. In one process they are tensor ops (``to``, ``stack``, ``cat``,
  ``+``), so autograd differentiates through them as the JAX collectives
  transpose. Given a ``ctx`` whose mesh spans processes they run their
  cross-process body: every process's blocks are gathered through
  :func:`~predictionio_tpu_torch.parallel.distributed.gather_blocks`
  (gloo, staged through host memory) and the same tensor ops then run on
  the gathered list, in placement order, so the result equals the
  one-process mesh of the same placements bit for bit.

:class:`MeshContext` is also the port's one-device context
(``device.DeviceContext`` is this class): ``ctx.device`` is the first
placement of this process, and :meth:`MeshContext.create` with ``device=``
gives a mesh of that one device (one placement a process under a launch).
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


@dataclasses.dataclass(frozen=True)
class Placement:
    """A placement of a mesh that spans processes: the process that holds
    it and its device there (another process's device as that process
    names it)."""

    process_index: int
    device: torch.device

    @property
    def type(self) -> str:
        return self.device.type

    def __str__(self) -> str:
        return f"p{self.process_index}:{self.device}"


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
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return _mesh_of(devs, axes)


def _mesh_of(devs: list, axes: Optional[Mapping[str, int]]) -> Mesh:
    """A mesh over placements already resolved (``Placement`` records or
    devices), shaped by ``axes`` as :func:`make_mesh` shapes it."""
    n = len(devs)
    axes = dict(axes) if axes is not None else {DATA_AXIS: n}
    infer = [k for k, v in axes.items() if v == -1]
    if len(infer) > 1:
        raise ValueError("only one mesh axis may be -1")
    known = math.prod(v for v in axes.values() if v != -1)
    if infer:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        axes[infer[0]] = n // known
    if math.prod(axes.values()) != n:
        raise ValueError(f"mesh axes {axes} need {math.prod(axes.values())} devices, have {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(tuple(axes.values())), tuple(axes.keys()))


def misaligned_pod_row(devices: Sequence[Any], host_groups: int) -> Optional[int]:
    """First host row whose devices span more than one process, else None.

    Folding ``devices`` row-major into ``host_groups`` rows, every row must
    be process-pure for the two-tier merge's on-host tier to stay on the
    host. A placement carries its process as ``process_index`` (a
    :class:`Placement`; a ``torch.device`` is a placement of this process,
    0)."""
    per_row = len(devices) // host_groups
    for g in range(host_groups):
        row = devices[g * per_row:(g + 1) * per_row]
        if len({getattr(d, "process_index", 0) for d in row}) > 1:
            return g
    return None


# -- the collectives, on lists of blocks (one per placement) -----------------


def _spanning(ctx) -> bool:
    return ctx is not None and ctx.spans_processes


def _global_blocks(blocks: Sequence[torch.Tensor], ctx) -> list[torch.Tensor]:
    """Every placement's block in global placement order (host tensors for
    the other processes' blocks, this process's own blocks as given)."""
    from predictionio_tpu_torch.parallel import distributed

    gathered = distributed.gather_blocks(blocks)
    lo, hi = ctx.local_range
    return gathered[:lo] + list(blocks) + gathered[hi:]


def all_gather(blocks: Sequence[torch.Tensor], device: DeviceLike, *, ctx=None) -> torch.Tensor:
    """The blocks stacked on ``device``: (n, *block.shape) — what
    ``lax.all_gather`` gives every device, here given to the one that
    merges. With a ``ctx`` spanning processes ``blocks`` are this process's
    and every process gets all n."""
    dev = torch.device(device)
    if _spanning(ctx):
        blocks = _global_blocks(blocks, ctx)
    return torch.stack([b.to(dev) for b in blocks])


def ppermute(
    blocks: Sequence[torch.Tensor],
    devices: Optional[Sequence[DeviceLike]] = None,
    shift: int = 1,
    *,
    ctx=None,
) -> list[torch.Tensor]:
    """The ring step ``perm = [(j, (j + shift) % n)]``: placement j receives
    the block of placement ``j - shift``, moved to ``devices[j]`` (this
    process's placements only, with a ``ctx`` spanning processes)."""
    if _spanning(ctx):
        every = _global_blocks(blocks, ctx)
        n = len(every)
        lo, hi = ctx.local_range
        out = [every[(j - shift) % n] for j in range(lo, hi)]
        devs = devices if devices is not None else [b.device for b in blocks]
        return [b.to(torch.device(d)) for b, d in zip(out, devs)]
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
    *,
    ctx=None,
) -> list[torch.Tensor]:
    """Tiled ``lax.all_to_all``: each block is cut into n chunks along
    ``split_dim``; placement j receives chunk j of every block, concatenated
    in placement order along ``concat_dim`` (this process's placements
    only, with a ``ctx`` spanning processes)."""
    if _spanning(ctx):
        every = _global_blocks(blocks, ctx)
        lo, hi = ctx.local_range
    else:
        every, lo, hi = list(blocks), 0, len(blocks)
    n = len(every)
    chunks = [torch.chunk(b, n, dim=split_dim) for b in every]
    if any(len(c) != n or c[0].shape != c[-1].shape for c in chunks):
        raise ValueError(f"dim {split_dim} of {tuple(every[0].shape)} does not split {n} ways")
    out = []
    for k, j in enumerate(range(lo, hi)):
        dev = torch.device(devices[k]) if devices is not None else blocks[k].device
        out.append(torch.cat([chunks[i][j].to(dev) for i in range(n)], dim=concat_dim))
    return out


def psum(
    blocks: Sequence[torch.Tensor],
    devices: Optional[Sequence[DeviceLike]] = None,
    *,
    ctx=None,
) -> list[torch.Tensor]:
    """The sum of the blocks, in placement order, given to every placement
    (on ``devices[j]``, else the first block's device); with a ``ctx``
    spanning processes, the sum of every process's blocks."""
    dev0 = blocks[0].device
    n_local = len(blocks)
    if _spanning(ctx):
        blocks = _global_blocks(blocks, ctx)
    total = blocks[0].to(dev0)
    for b in blocks[1:]:
        total = total + b.to(dev0)
    if devices is None:
        return [total] * n_local
    return [total.to(torch.device(d)) for d in devices]


@dataclasses.dataclass
class MeshContext:
    """The compute context handed through the DASE pipeline (the JAX
    package's ``MeshContext``): the mesh, placement helpers, and ``conf``,
    the free-form deployment settings recorded on ``EngineInstance.
    mesh_conf`` (the device itself is never read from there when the
    caller names one, so a conf written by a CPU test cannot send a
    deployment on the card to the CPU). ``process_index`` is this
    process's place in a launch; a mesh that spans processes holds
    :class:`Placement` records."""

    mesh: Mesh
    conf: dict = dataclasses.field(default_factory=dict)
    process_index: int = 0

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
        ``mesh_axes`` when no ``device`` is named) shape the mesh.

        Under a launch of N > 1 processes these are this process's
        placements, and the mesh spans every process's placements in
        process order (each process names the same local placements)."""
        conf = dict(conf or {})
        if device is not None:
            if devices is not None:
                raise ValueError("pass device= or devices=, not both")
            devices = [device]
        elif axes is None and "mesh_axes" in conf:
            axes = {k: int(v) for k, v in conf["mesh_axes"].items()}
        from predictionio_tpu_torch.parallel import distributed

        pid, n_proc = distributed.process_slot()
        if n_proc == 1:
            return MeshContext(mesh=make_mesh(axes=axes, devices=devices), conf=conf)
        local = [resolve_device(d) for d in devices] if devices is not None else default_devices()
        placements = [Placement(p, d) for p in range(n_proc) for d in local]
        return MeshContext(
            mesh=_mesh_of(placements, axes), conf=conf, process_index=pid)

    # -- placement helpers -------------------------------------------------
    @property
    def spans_processes(self) -> bool:
        """True when some placement lives in another process."""
        return any(isinstance(d, Placement) and d.process_index != self.process_index
                   for d in self.mesh.devices.flat)

    @property
    def local_devices(self) -> list[torch.device]:
        """This process's placements' devices, in mesh order."""
        return [d.device if isinstance(d, Placement) else d
                for d in self.mesh.devices.flat
                if getattr(d, "process_index", self.process_index) == self.process_index]

    @property
    def local_range(self) -> tuple[int, int]:
        """The flat interval of this process's placements (process-major)."""
        idx = [i for i, d in enumerate(self.mesh.devices.flat)
               if getattr(d, "process_index", self.process_index) == self.process_index]
        if not idx or idx[-1] - idx[0] + 1 != len(idx):
            raise ValueError("this process's placements are not one contiguous run")
        return idx[0], idx[-1] + 1

    @property
    def device(self) -> torch.device:
        """This process's first placement: where one-device work runs."""
        return self.local_devices[0]

    @property
    def devices(self) -> list:
        """Every placement, in the mesh's row-major order (``torch.device``
        in one process, :class:`Placement` records across processes)."""
        return list(self.mesh.devices.flat)

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    def axis_size(self, axis: str) -> int:
        return self.mesh.shape.get(axis, 1)

    def _sub(self, axes: Mapping[str, int], devs: list) -> "MeshContext":
        return MeshContext(mesh=_mesh_of(devs, axes), conf=dict(self.conf),
                           process_index=self.process_index)

    def local(self) -> "MeshContext":
        """A one-process context over this process's placements (work that
        each process of a launch does on its own, like its share of a batch
        predict)."""
        if not self.spans_processes:
            return self
        return MeshContext(mesh=make_mesh(devices=self.local_devices), conf=dict(self.conf))

    def submesh(self, n_devices: int, axis: str = DATA_AXIS) -> "MeshContext":
        """A context over the first ``n_devices`` placements, one ``axis``
        (a plan of S shards serves on the first S placements)."""
        if n_devices == self.mesh.size and self.mesh.axis_names == (axis,):
            return self
        if n_devices > self.mesh.size:
            raise ValueError(f"submesh of {n_devices} devices from a {self.mesh.size}-device mesh")
        return self._sub({axis: n_devices}, self.devices[:n_devices])

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
        return self._sub({HOST_AXIS: host_groups, DATA_AXIS: n_shards // host_groups}, devs)

    def place(self, x, *spec: Any) -> list[torch.Tensor]:
        """This process's per-placement blocks of ``x`` (a host array or a
        tensor) under ``spec``, flat in row-major mesh order.

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
            dev = self.mesh.devices[coord]
            if isinstance(dev, Placement):
                if dev.process_index != self.process_index:
                    continue
                dev = dev.device
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
            k = (tuple(key), dev)
            if k not in cache:
                cache[k] = t[tuple(sl)].contiguous().to(dev)
            out.append(cache[k])
        return out

    def replicate(self, x: np.ndarray) -> torch.Tensor:
        """Host array → contiguous tensor on the first placement (one-device
        work; :meth:`place` gives every placement its copy)."""
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)


def device_get_global(x, ctx=None) -> np.ndarray:
    """Device → host. A tensor is copied; a list of this process's blocks
    (one per placement, cut along dim 0) is concatenated in placement
    order, every process's blocks when ``ctx`` spans processes."""
    if isinstance(x, (list, tuple)):
        blocks = _global_blocks(x, ctx) if _spanning(ctx) else list(x)
        return torch.cat([b.detach().cpu() for b in blocks]).numpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
