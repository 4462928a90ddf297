"""Mid-training checkpoints: a sealed numpy-dict state store + step state.

Counterpart of ``predictionio_tpu/core/checkpoint.py`` (parity role: MLlib
ALS's ``setCheckpointInterval``, here persisting progress):

* :func:`dataset_digest` — the JAX package's digest, bit for bit (sha1 over
  the same bytes, the first 48 bits);
* :func:`save_state` / :func:`restore_state` — a tree of dicts, lists and
  arrays written as one ``np.savez`` payload inside the persistence
  checksum envelope (:func:`~predictionio_tpu_torch.core.persistence.
  seal_blob_file`), where the JAX package writes an orbax checkpoint. A torn
  or bit-flipped file reads as :class:`~predictionio_tpu_torch.core.
  persistence.ModelIntegrityError`, never as a half-loaded state. Tensors
  are saved as host numpy arrays;
* :class:`CheckpointManager` — ``<dir>/step_<n>/`` per save with the
  ``step_<n>.fp.npy`` fingerprint sidecar and ``keep=2`` retention;
* :func:`resume_from`, :func:`validate_interval` and :func:`save_due` —
  the resume policy and save cadence both trainers share.

The two packages cannot read each other's steps: a JAX step holds an
orbax tree, a port step a sealed ``state.blob``. :func:`resume_from`
skips a step it cannot read with a warning and starts from an older one
or fresh (ROADMAP §3).
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import re
import shutil
from typing import Any, Optional

import numpy as np

from predictionio_tpu_torch.core.persistence import (
    ModelIntegrityError,
    open_blob_file,
    seal_blob_file,
)

logger = logging.getLogger(__name__)

STATE_FILE = "state.blob"
_TREE_KEY = "__tree__"


def dataset_digest(*arrays) -> int:
    """Order-sensitive dataset digest for checkpoint fingerprints: sha1
    over the raw bytes of each array in sequence, truncated to 48 bits so
    the value stays exact inside the float64 fingerprint arrays. A
    permuted dataset gets another digest (element sums would not)."""
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).data)
    return int(h.hexdigest()[:12], 16)


def _host(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):  # a torch tensor, on any device
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree, arrays: dict) -> Any:
    """The tree's structure as JSON-able nodes; leaves go to ``arrays``."""
    if isinstance(tree, dict):
        return {"d": {str(k): _flatten(v, arrays) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"l": [_flatten(v, arrays) for v in tree]}
    if tree is None:
        return {"n": 0}
    key = f"a{len(arrays)}"
    arrays[key] = _host(tree)
    return {"a": key}


def _unflatten(node, arrays) -> Any:
    if "d" in node:
        return {k: _unflatten(v, arrays) for k, v in node["d"].items()}
    if "l" in node:
        return [_unflatten(v, arrays) for v in node["l"]]
    if "n" in node:
        return None
    return arrays[node["a"]]


def save_state(path: str, tree: Any) -> None:
    """Write a tree of dicts, lists and arrays (numpy or torch) to
    ``path``, sealed: the old file or the new, never a torn one."""
    arrays: dict = {}
    structure = _flatten(tree, arrays)
    arrays[_TREE_KEY] = np.frombuffer(json.dumps(structure).encode(), np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    seal_blob_file(path, buf.getvalue())


def restore_state(path: str) -> Any:
    """The tree :func:`save_state` wrote, as host numpy arrays. Raises
    :class:`ModelIntegrityError` on a torn or altered file, ``OSError``
    when it is missing."""
    payload = open_blob_file(path)
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    return _unflatten(json.loads(arrays.pop(_TREE_KEY).tobytes()), arrays)


class CheckpointManager:
    """Step-numbered checkpoints: ``<dir>/step_<n>/`` per save."""

    STEP_RE = re.compile(r"^step_(\d+)$")

    def __init__(self, directory: str, keep: int = 2):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def steps(self) -> list[int]:
        return sorted(
            int(m.group(1))
            for m in map(self.STEP_RE.match, os.listdir(self.directory)) if m
        )

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _fp_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.fp.npy")

    def save(self, step: int, tree: Any) -> None:
        """Persist a step, its fingerprint sidecar (when the tree carries a
        ``fingerprint``), and drop the oldest steps beyond ``keep``."""
        d = self._step_dir(step)
        os.makedirs(d, exist_ok=True)
        save_state(os.path.join(d, STATE_FILE), tree)
        # resume_from rejects a foreign step by its sidecar without
        # restoring the full state
        if isinstance(tree, dict) and tree.get("fingerprint") is not None:
            np.save(self._fp_path(step), np.asarray(tree["fingerprint"]))
        steps = self.steps()
        for old in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)
            try:
                os.remove(self._fp_path(old))
            except FileNotFoundError:
                pass

    def saved_fingerprint(self, step: int):
        """The sidecar fingerprint for ``step``, or None if absent."""
        try:
            return np.load(self._fp_path(step))
        except (FileNotFoundError, ValueError):
            return None

    def restore(self, step: Optional[int] = None) -> Any:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return restore_state(os.path.join(self._step_dir(step), STATE_FILE))


def _same(a, want: np.ndarray) -> bool:
    a = np.asarray(a)
    return a.shape == want.shape and bool(np.allclose(a, want))


def resume_from(manager: CheckpointManager, fingerprint, max_step: int):
    """The fingerprint-gated resume policy shared by the trainers.

    Returns ``(start_step, host_state)`` for the LARGEST checkpoint step
    <= ``max_step`` whose stored fingerprint matches, or ``(0, None)``. A
    leftover step from a longer run does not disable resume from a valid
    earlier one; a foreign, stale, torn or unreadable step is skipped with
    a warning, never loaded.
    """
    want = np.asarray(fingerprint)
    skipped_high = []
    for step in sorted(manager.steps(), reverse=True):
        if step > max_step:
            skipped_high.append(step)
            continue
        side = manager.saved_fingerprint(step)
        if side is not None and not _same(side, want):
            logger.warning(
                "checkpoint step %d under %s does not match this "
                "config/dataset; ignoring", step, manager.directory,
            )
            continue
        try:
            state = manager.restore(step)
        except (ModelIntegrityError, OSError, ValueError, KeyError) as e:
            logger.warning(
                "checkpoint step %d under %s is unreadable (%s); ignoring",
                step, manager.directory, e,
            )
            continue
        if isinstance(state, dict) and _same(state.get("fingerprint"), want):
            logger.info(
                "resuming from checkpoint step %d under %s", step, manager.directory,
            )
            return step, state
        logger.warning(
            "checkpoint step %d under %s does not match this config/dataset; "
            "ignoring", step, manager.directory,
        )
    if skipped_high:
        logger.warning(
            "checkpoint steps %s under %s exceed the requested %d; "
            "starting fresh", skipped_high, manager.directory, max_step,
        )
    return 0, None


def validate_interval(interval: int) -> None:
    if interval < 1:
        raise ValueError(f"checkpoint_interval must be >= 1, got {interval}")


def save_due(step_done: int, interval: int, total_steps: int) -> bool:
    """The save cadence both trainers follow: every ``interval`` completed
    steps, plus always at the end of the run."""
    return step_done % interval == 0 or step_done == total_steps
