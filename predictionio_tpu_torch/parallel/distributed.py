"""Many processes: the ``torch.distributed`` runtime over gloo.

Counterpart of ``predictionio_tpu/parallel/distributed.py``. The launch
contract is the JAX package's (one process per host or per rank, the same
program):

    PIO_COORDINATOR=host0:1234 PIO_NUM_PROCESSES=4 PIO_PROCESS_ID=2 pio train ...

:func:`initialize` joins ``torch.distributed.init_process_group("gloo",
init_method="tcp://<coordinator>")`` and then waits at a barrier, the JAX
code's ``sync_global_devices``: every process leaves the rendezvous
together, so kernel builds and data loads happen after the first
collective, never before it.

The transport is gloo, here and on the card. NCCL refuses two ranks on one
card, and gloo's CUDA support is little more than ``broadcast`` and
``all_reduce``, so every cross-process collective of the port stages its
blocks through host memory (:func:`gather_blocks`): the card's blocks are
copied to pinned host tensors, the gloo call runs on those, and the caller
copies the result back to its placement. :data:`STATS` counts the bytes
copied into host memory and the calls. On a machine with one card the ranks
of a launch time-slice that card.

On one process nothing is initialized, :func:`process_slot` is ``(0, 1)``
and every helper is the identity.
"""

from __future__ import annotations

import datetime as _dt
import glob
import logging
import os
import re
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

_initialized = False
# the rendezvous' collective deadline (seconds): a peer that died fails the
# survivors' next collective within this, rather than hanging them
_TIMEOUT_S = 300.0

# cross-process traffic, host-staged: bytes copied into host memory (a
# card's blocks and the gathered blocks), gloo calls made and the seconds
# spent in them (staging included)
STATS = {"staged_bytes": 0, "calls": 0, "seconds": 0.0}
_stats_lock = threading.Lock()


def reset_stats() -> None:
    with _stats_lock:
        STATS.update(staged_bytes=0, calls=0, seconds=0.0)


def _note(nbytes: int, seconds: float = 0.0) -> None:
    with _stats_lock:
        STATS["staged_bytes"] += int(nbytes)
        STATS["calls"] += 1
        STATS["seconds"] += seconds


def is_multihost_env() -> bool:
    return "PIO_COORDINATOR" in os.environ


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the gloo process group from the arguments or ``PIO_*``; True
    when this process is part of a launch. Safe to call unconditionally:
    without a coordinator it returns False and touches nothing."""
    global _initialized
    coordinator_address = coordinator_address or os.environ.get("PIO_COORDINATOR")
    if coordinator_address is None:
        return False
    if _initialized:
        return True
    if num_processes is None:
        num_processes = int(os.environ.get("PIO_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("PIO_PROCESS_ID", "0"))
    import torch.distributed as dist

    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=_dt.timedelta(seconds=_TIMEOUT_S),
    )
    _initialized = True
    # leave the rendezvous together: the first collective must not wait
    # out one process's kernel build or data load
    dist.barrier()
    logger.info(
        "torch.distributed (gloo) initialized: process %d/%d via %s",
        process_id, num_processes, coordinator_address,
    )
    return True


def shutdown() -> None:
    """Leave the process group (tests that initialize in a spawned child)."""
    global _initialized
    if _initialized:
        import torch.distributed as dist

        dist.destroy_process_group()
        _initialized = False


def is_initialized() -> bool:
    return _initialized


def process_index() -> int:
    if not _initialized:
        return 0
    import torch.distributed as dist

    return dist.get_rank()


def num_processes() -> int:
    if not _initialized:
        return 1
    import torch.distributed as dist

    return dist.get_world_size()


def barrier() -> None:
    """Wait for every process (a no-op in one process)."""
    if _initialized and num_processes() > 1:
        import torch.distributed as dist

        dist.barrier()


def gather_blocks(blocks: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Every process's ``blocks`` in process order, on the host: the one
    cross-process transport of the port's collectives.

    Each process passes the same number of blocks of one shape and dtype.
    CUDA blocks are copied once into a pinned host buffer (gloo gets host
    tensors only), and the gathered blocks land in pinned buffers too; the
    result stays on the host and the caller moves it to its placement.
    Returns ``n_processes * len(blocks)`` CPU tensors."""
    import torch.distributed as dist

    if not blocks:
        raise ValueError("gather_blocks needs at least one block")
    t0 = time.perf_counter()
    n = num_processes()
    on_card = blocks[0].device.type == "cuda"
    shape = (len(blocks), *blocks[0].shape)
    host = torch.empty(shape, dtype=blocks[0].dtype, pin_memory=on_card)
    for j, b in enumerate(blocks):
        host[j].copy_(b.detach())
    outs = [torch.empty(shape, dtype=host.dtype, pin_memory=on_card) for _ in range(n)]
    dist.all_gather(outs, host)
    nbytes = host.numel() * host.element_size()
    # the bytes this call copies into host memory: its own blocks off the
    # card, and every process's blocks off the wire (the caller's copy of
    # the result to its placement is not counted here)
    _note(nbytes * (1 + n) if on_card else nbytes * n, time.perf_counter() - t0)
    return [b for o in outs for b in o.unbind(0)]


def broadcast_object(obj, src: int = 0):
    """``obj`` of process ``src`` on every process."""
    if num_processes() == 1:
        return obj
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=src)
    _note(0)
    return box[0]


# rows gathered per reduction slab: bounds the transient (n_hosts, slab)
# stack so reducing a large block on N hosts never holds N copies
_HOST_SUM_SLAB_ELEMS = 16_777_216


def _allgather_host(x: np.ndarray) -> np.ndarray:
    parts = gather_blocks([torch.from_numpy(np.ascontiguousarray(x))])
    return np.stack([p.numpy() for p in parts])


def host_sum(x):
    """Sum identically shaped per-host arrays across processes (the JAX
    package's ``host_sum``): gathered and summed in process order, in row
    slabs of :data:`_HOST_SUM_SLAB_ELEMS` elements so the peak is one extra
    slab per peer. One process: the identity."""
    x = np.asarray(x)
    if num_processes() == 1:
        return x
    if x.size <= _HOST_SUM_SLAB_ELEMS:
        return _allgather_host(x).sum(axis=0)
    flat = np.ascontiguousarray(x).reshape(-1)
    out = np.empty_like(flat)
    for s in range(0, flat.size, _HOST_SUM_SLAB_ELEMS):
        piece = np.ascontiguousarray(flat[s:s + _HOST_SUM_SLAB_ELEMS])
        out[s:s + _HOST_SUM_SLAB_ELEMS] = _allgather_host(piece).sum(axis=0)
    return out.reshape(x.shape)


def process_slot() -> tuple[int, int]:
    """(process_index, num_processes) under an active launch, (0, 1)
    otherwise: the one multi-process rule every distributed reader and
    writer shares."""
    if is_initialized() and num_processes() > 1:
        return process_index(), num_processes()
    return 0, 1


def _remove_quiet(path: str) -> None:
    try:
        os.remove(path)
    except FileNotFoundError:
        pass


def shard_output_path(base_path: str) -> tuple[int, int, str]:
    """The distributed writer's output contract (batch predict).

    Returns ``(process_index, num_processes, path this process writes)``:
    ``<base>.part-<i>`` under a launch, the plain base in one process. It
    also removes exactly the stale outputs no current process rewrites
    (part-j for j ≥ N and the plain base under a launch, on the
    coordinator; every part in one process), so consumers globbing
    ``<base>*`` never mix runs."""
    pid, n = process_slot()
    stale = [
        p for p in glob.glob(glob.escape(base_path) + ".part-*")
        if re.search(r"\.part-(\d+)$", p)
    ]
    if n > 1:
        out = f"{base_path}.part-{pid}"
        for p in stale:
            if int(re.search(r"\.part-(\d+)$", p).group(1)) >= n:
                _remove_quiet(p)
        if pid == 0:
            _remove_quiet(base_path)
    else:
        out = base_path
        for p in stale:
            _remove_quiet(p)
    return pid, n, out


def run_id() -> Optional[str]:
    """The launch-scoped id ``pio launch`` gives every worker: it scopes
    the rendezvous blobs (``parallel/ingest.py``) so a crashed run's
    leftovers never merge into a fresh one."""
    return os.environ.get("PIO_RUN_ID")


def is_coordinator() -> bool:
    return process_index() == 0


def should_write_storage() -> bool:
    """True when this process owns metadata and model writes: every process
    reads and trains, exactly one (the coordinator) records instances and
    blobs, as one Spark application does in the reference."""
    return not _initialized or is_coordinator()
