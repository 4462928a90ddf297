"""Model persistence: the sealed MODELDATA blob and its three slot kinds.

Counterpart of ``predictionio_tpu/core/persistence.py`` (parity:
``controller/PersistentModel.scala`` + ``BaseAlgorithm.makePersistentModel``
+ the manifest dispatch of ``controller/Engine.scala:241-250``): a model is
auto-pickled into MODELDATA, saved by its own ``PersistentModel.save``
behind a manifest, or retrained on deploy (:data:`RETRAIN`).

A blob pickles the PORT's classes (``predictionio_tpu_torch.models.als.
ALSModel``). A blob written by the JAX package names the JAX package's
classes and does not load here. Generation quarantine waits for the canary
slice.
"""

from __future__ import annotations

import abc
import hashlib
import importlib
import os
import pickle
from typing import Any

# Content-checksum envelope around the MODELDATA blob: magic + version +
# sha256(payload) + payload. Deploy verifies the digest before unpickling,
# so a torn or bit-flipped blob is a clean ModelIntegrityError, never a
# pickle crash deep in deserialization. Pickles start with b"\x80", so an
# un-enveloped blob never collides with the magic and loads as-is.
_ENVELOPE_MAGIC = b"PIOM1"
_DIGEST_LEN = 32  # sha256


class ModelIntegrityError(Exception):
    """The stored model blob fails its content checksum (torn write,
    media corruption); the blob must not be deserialized."""


def seal_model_blob(payload: bytes) -> bytes:
    """Wrap a serialized-models payload in the checksum envelope."""
    return _ENVELOPE_MAGIC + hashlib.sha256(payload).digest() + payload


def open_model_blob(blob: bytes) -> bytes:
    """Verify and strip the envelope; raises :class:`ModelIntegrityError`
    on digest mismatch. Blobs without the magic pass through unchanged."""
    if not blob.startswith(_ENVELOPE_MAGIC):
        return blob
    header_len = len(_ENVELOPE_MAGIC) + _DIGEST_LEN
    if len(blob) < header_len:
        raise ModelIntegrityError(
            f"model blob shorter than its envelope header ({len(blob)} bytes)"
        )
    digest = blob[len(_ENVELOPE_MAGIC):header_len]
    payload = blob[header_len:]
    if hashlib.sha256(payload).digest() != digest:
        raise ModelIntegrityError(
            "model blob checksum mismatch (torn write or corruption)"
        )
    return payload


def seal_blob_file(path: str, payload: bytes) -> None:
    """Atomically write ``payload`` to ``path`` inside the checksum
    envelope (tmp + fsync + rename: a crash mid-write leaves the old file
    or none, never a torn blob)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(seal_model_blob(payload))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def open_blob_file(path: str) -> bytes:
    """Read and verify a :func:`seal_blob_file` artifact; raises
    :class:`ModelIntegrityError` on checksum mismatch, ``OSError`` when
    missing."""
    with open(path, "rb") as f:
        return open_model_blob(f.read())


class _RetrainSentinel:
    def __repr__(self) -> str:
        return "RETRAIN"


RETRAIN = _RetrainSentinel()


class PersistentModel(abc.ABC):
    """Self-persisting model (parity: trait PersistentModel/Loader)."""

    @abc.abstractmethod
    def save(self, instance_id: str, params: Any) -> bool:
        """Persist; return True to store a manifest (False ⇒ auto-pickle)."""

    @classmethod
    @abc.abstractmethod
    def load(cls, instance_id: str, params: Any, ctx) -> "PersistentModel":
        """Rebuild at deploy time."""


def class_path(obj_or_cls) -> str:
    cls = obj_or_cls if isinstance(obj_or_cls, type) else type(obj_or_cls)
    return f"{cls.__module__}.{cls.__qualname__}"


def resolve_class(path: str):
    """Import ``pkg.mod.Class`` (the Python replacement for JVM reflection)."""
    module_name, _, cls_name = path.rpartition(".")
    obj: Any = importlib.import_module(module_name)
    for part in cls_name.split("."):
        obj = getattr(obj, part)
    return obj


def serialize_models(
    instance_id: str, algorithms: list, models: list, algo_params: list
) -> bytes:
    """Build the MODELDATA blob (parity: Engine.makeSerializableModels:284).

    Each slot is one of ``("pickle", blob)``, ``("manifest", class_path)`` or
    ``("retrain", None)``.
    """
    slots = []
    for algo, model, params in zip(algorithms, models, algo_params):
        if isinstance(model, PersistentModel):
            if model.save(instance_id, params):
                slots.append(("manifest", class_path(model)))
            else:
                slots.append(("pickle", algo.make_serializable_model(model)))
            continue
        serializable = algo.make_serializable_model(model)
        if serializable is RETRAIN or isinstance(serializable, _RetrainSentinel):
            slots.append(("retrain", None))
        else:
            slots.append(("pickle", serializable))
    return pickle.dumps(slots, protocol=pickle.HIGHEST_PROTOCOL)


def deserialize_models(
    blob: bytes, instance_id: str, algorithms: list, algo_params: list, ctx
) -> tuple[list, list[int]]:
    """Rebuild models at deploy; returns (models, indices_needing_retrain).

    Parity: ``Engine.prepareDeploy`` (``Engine.scala:198-267``).
    """
    slots = pickle.loads(blob)
    models: list = []
    retrain_idx: list[int] = []
    for i, ((kind, payload), algo, params) in enumerate(
        zip(slots, algorithms, algo_params)
    ):
        if kind == "pickle":
            models.append(algo.load_serializable_model(ctx, payload))
        elif kind == "manifest":
            cls = resolve_class(payload)
            # manifest loaders return HOST-form models; route through the
            # algorithm's load hook so deploy-side state binds to THIS ctx
            models.append(
                algo.load_serializable_model(ctx, cls.load(instance_id, params, ctx))
            )
        elif kind == "retrain":
            models.append(None)
            retrain_idx.append(i)
        else:
            raise ValueError(f"unknown model slot kind {kind!r}")
    return models, retrain_idx
