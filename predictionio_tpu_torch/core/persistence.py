"""Model persistence: the sealed MODELDATA blob and its three slot kinds.

Counterpart of ``predictionio_tpu/core/persistence.py`` (parity:
``controller/PersistentModel.scala`` + ``BaseAlgorithm.makePersistentModel``
+ the manifest dispatch of ``controller/Engine.scala:241-250``): a model is
auto-pickled into MODELDATA, saved by its own ``PersistentModel.save``
behind a manifest, or retrained on deploy (:data:`RETRAIN`).

A blob pickles the PORT's classes (``predictionio_tpu_torch.models.als.
ALSModel``). The sqlite store is shared with the JAX package, so a blob, a
manifest or an ``engineFactory`` the JAX package wrote can reach the port;
none of them may import ``predictionio_tpu`` (and with it jax) into this
process. :data:`JAX_COUNTERPARTS` maps each JAX class such a record can
name to the port's class, :func:`load_models_blob` unpickles through that
table, and :func:`resolve_class` resolves dotted paths through it. Any
other ``predictionio_tpu`` path, and any jax, orbax or ml_dtypes one, is
refused with an error that names it.

Generation quarantine: a generation that failed ONLINE verification (a
canary rollback) gets a sealed receipt under
``<PIO_FS_BASEDIR>/quarantine/<engine-key>/<id>.json``, in the JAX
package's layout and envelope, so either package reads the other's
receipts. Every newest-COMPLETED selection walks past those ids.
"""

from __future__ import annotations

import abc
import dataclasses
import hashlib
import importlib
import importlib.util
import io
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


# ---------------------------------------------------------------------------
# Generation quarantine: durable receipts for generations that failed ONLINE
# verification (canary rollback, soak-watchdog rollback). A receipt is a
# sealed JSON blob under <PIO_FS_BASEDIR>/quarantine/<engine-key>/<id>.json;
# newest-COMPLETED selection (workflow.get_latest_completed_instance), the
# query server's cold-start fallback, fleet.roll() targets and future
# canaries all consult the set so a bad generation is never auto-deployed
# twice. Receipts seal through the same checksum envelope as model blobs;
# a torn/corrupt receipt still QUARANTINES its id (fail-safe: the filename
# carries the id, so an unreadable receipt can only over-block, never
# silently re-admit a known-bad generation).


def _engine_key(engine_id: str, engine_version: str, engine_variant: str) -> str:
    import re

    raw = f"{engine_id}-{engine_version}-{engine_variant}"
    return re.sub(r"[^A-Za-z0-9_.-]", "_", raw)


def quarantine_dir(
    engine_id: str = "default",
    engine_version: str = "default",
    engine_variant: str = "default",
) -> str:
    """Receipt directory for one engine key (created lazily by writes)."""
    import os

    from predictionio_tpu_torch.utils.fs import pio_base_dir

    return os.path.join(
        pio_base_dir(),
        "quarantine",
        _engine_key(engine_id, engine_version, engine_variant),
    )


def _receipt_path(dirname: str, instance_id: str) -> str:
    import os
    import re

    safe = re.sub(r"[^A-Za-z0-9_.-]", "_", instance_id)
    return os.path.join(dirname, f"{safe}.json")


def write_quarantine_receipt(
    instance_id: str,
    reason: str,
    engine_id: str = "default",
    engine_version: str = "default",
    engine_variant: str = "default",
    epoch: int = 0,
    details: dict | None = None,
) -> str:
    """Durably quarantine ``instance_id``; returns the receipt path.

    The receipt is sealed (checksum envelope) and published atomically
    (tmp + fsync + rename), so a crash mid-write leaves either no receipt
    or a whole one — and callers that must not lose the quarantine on
    crash write their intent to a journal FIRST and re-issue this call on
    resume (it is idempotent: re-writing an existing receipt keeps the
    earliest epoch's verdict by simply overwriting with equivalent data).
    """
    import json
    import os
    import time

    dirname = quarantine_dir(engine_id, engine_version, engine_variant)
    os.makedirs(dirname, exist_ok=True)
    path = _receipt_path(dirname, instance_id)
    receipt = {
        "instanceId": instance_id,
        "reason": reason,
        "epoch": int(epoch),
        "quarantinedAt": time.time(),
        "engineId": engine_id,
        "engineVersion": engine_version,
        "engineVariant": engine_variant,
        "details": details or {},
    }
    seal_blob_file(path, json.dumps(receipt, sort_keys=True).encode("utf-8"))
    from predictionio_tpu_torch.utils.fs import fsync_dir

    fsync_dir(dirname)
    return path


def read_quarantine_receipts(
    engine_id: str = "default",
    engine_version: str = "default",
    engine_variant: str = "default",
) -> list[dict]:
    """All receipts for one engine key, unreadable ones included.

    A receipt that fails its checksum (torn write the atomic protocol
    should prevent, or media corruption) is surfaced as
    ``{"instanceId": <from filename>, "reason": "unreadable-receipt"}`` —
    quarantine fails SAFE: a damaged receipt blocks the generation rather
    than re-admitting it.
    """
    import json
    import os

    dirname = quarantine_dir(engine_id, engine_version, engine_variant)
    try:
        names = sorted(os.listdir(dirname))
    except OSError:
        return []
    receipts: list[dict] = []
    for name in names:
        if not name.endswith(".json"):
            continue
        path = os.path.join(dirname, name)
        try:
            receipts.append(json.loads(open_blob_file(path).decode("utf-8")))
        except (ModelIntegrityError, OSError, ValueError):
            receipts.append(
                {"instanceId": name[: -len(".json")],
                 "reason": "unreadable-receipt"}
            )
    return receipts


def quarantined_instance_ids(
    engine_id: str = "default",
    engine_version: str = "default",
    engine_variant: str = "default",
) -> set:
    """The ids no selection path may auto-deploy."""
    return {
        str(r.get("instanceId"))
        for r in read_quarantine_receipts(engine_id, engine_version,
                                          engine_variant)
        if r.get("instanceId")
    }


def is_quarantined(
    instance_id: str,
    engine_id: str = "default",
    engine_version: str = "default",
    engine_variant: str = "default",
) -> bool:
    import os

    dirname = quarantine_dir(engine_id, engine_version, engine_variant)
    return os.path.exists(_receipt_path(dirname, instance_id))


def clear_quarantine(
    instance_id: str,
    engine_id: str = "default",
    engine_version: str = "default",
    engine_variant: str = "default",
) -> bool:
    """Operator-only release of a quarantined generation (``pio canary
    quarantine --release``); returns False when no receipt existed."""
    import os

    dirname = quarantine_dir(engine_id, engine_version, engine_variant)
    try:
        os.unlink(_receipt_path(dirname, instance_id))
    except OSError:
        return False
    from predictionio_tpu_torch.utils.fs import fsync_dir

    fsync_dir(dirname)
    return True


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


_JAX = "predictionio_tpu"
_PORT = "predictionio_tpu_torch"

# The JAX package's classes a MODELDATA blob, a manifest or an engine.json
# can name, and the port's counterpart of each. Blobs hold host arrays
# only (numpy), so the port's class reads their state as it is.
JAX_COUNTERPARTS = {
    f"{_JAX}.models.als.ALSModel": f"{_PORT}.models.als.ALSModel",
    f"{_JAX}.models.als.ALSConfig": f"{_PORT}.models.als.ALSConfig",
    f"{_JAX}.data.bimap.BiMap": f"{_PORT}.data.bimap.BiMap",
    f"{_JAX}.models.sequential.SASRecModel": f"{_PORT}.models.sequential.SASRecModel",
    f"{_JAX}.models.sequential.SASRecConfig": f"{_PORT}.models.sequential.SASRecConfig",
    # an auto-mode ALSModel's IVF index and its cluster partition; a model
    # whose sharding_plan is set is still refused (ALSModel.__setstate__)
    f"{_JAX}.ops.ivf.IVFIndex": f"{_PORT}.ops.ivf.IVFIndex",
    f"{_JAX}.serving.sharding.ShardingPlan": f"{_PORT}.serving.sharding.ShardingPlan",
    # the other templates' models (ROADMAP §1 item 11)
    f"{_JAX}.models.cooccurrence.CooccurrenceModel":
        f"{_PORT}.models.cooccurrence.CooccurrenceModel",
    f"{_JAX}.models.naive_bayes.MultinomialNBModel":
        f"{_PORT}.models.naive_bayes.MultinomialNBModel",
    f"{_JAX}.models.naive_bayes.CategoricalNBModel":
        f"{_PORT}.models.naive_bayes.CategoricalNBModel",
    f"{_JAX}.models.random_forest.RandomForestModel":
        f"{_PORT}.models.random_forest.RandomForestModel",
    f"{_JAX}.models.random_forest.RFConfig": f"{_PORT}.models.random_forest.RFConfig",
    f"{_JAX}.models.markov_chain.MarkovChainModel":
        f"{_PORT}.models.markov_chain.MarkovChainModel",
    f"{_JAX}.models.binary_vectorizer.BinaryVectorizer":
        f"{_PORT}.models.binary_vectorizer.BinaryVectorizer",
    f"{_JAX}.templates.universal.URModel": f"{_PORT}.templates.universal.URModel",
    f"{_JAX}.templates.similarproduct.SimilarALSModel":
        f"{_PORT}.templates.similarproduct.SimilarALSModel",
    f"{_JAX}.templates.similarproduct.SimilarCooccurrenceModel":
        f"{_PORT}.templates.similarproduct.SimilarCooccurrenceModel",
    f"{_JAX}.templates.ecommerce.ECommModel": f"{_PORT}.templates.ecommerce.ECommModel",
    f"{_JAX}.templates.similaruser.SimilarUserModel":
        f"{_PORT}.templates.similaruser.SimilarUserModel",
    # a pypio-saved instance's engine factory
    f"{_JAX}.pypio.PythonEngine": f"{_PORT}.pypio.PythonEngine",
}

# JAX classes that have no counterpart yet, with why
_REFUSED = {
    f"{_JAX}.models.als.CheckpointedALSModel": (
        "a checkpoint-mode instance of the JAX package keeps its factors in an "
        "orbax checkpoint, which predictionio_tpu_torch cannot read (it does not "
        "import orbax); retrain it with the port, or publish it in auto mode"
    ),
}

# top-level packages the port never imports (rule 1)
_FOREIGN = (_JAX, "jax", "jaxlib", "orbax", "ml_dtypes", "flax", "optax")


class ForeignClassError(ImportError):
    """A stored record names a class of the JAX package (or of jax) that
    has no counterpart in the port."""


def port_path(path: str) -> str:
    """The port's dotted path for ``path``: a JAX class of
    :data:`JAX_COUNTERPARTS` or a ``predictionio_tpu.templates.*`` name maps
    to the port's; any other ``predictionio_tpu``, jax or orbax path raises
    :class:`ForeignClassError` naming it. Every other path is returned as is."""
    top = path.split(".", 1)[0]
    if top not in _FOREIGN:
        return path
    if path in JAX_COUNTERPARTS:
        return JAX_COUNTERPARTS[path]
    if path in _REFUSED:
        raise ForeignClassError(f"{path}: {_REFUSED[path]}")
    if path.startswith(f"{_JAX}.templates."):
        module_name = _PORT + path[len(_JAX):].rpartition(".")[0]
        if importlib.util.find_spec(module_name) is not None:
            return _PORT + path[len(_JAX):]
        raise ForeignClassError(
            f"{path}: the template has no counterpart in predictionio_tpu_torch"
        )
    raise ForeignClassError(
        f"{path} is a class of {top}, which predictionio_tpu_torch does not "
        "import, and it has no counterpart in the port"
    )


def resolve_class(path: str):
    """Import ``pkg.mod.Class`` (the Python replacement for JVM reflection),
    after :func:`port_path`: a JAX-package path resolves to the port's
    counterpart or raises, never importing the JAX package."""
    module_name, _, cls_name = port_path(path).rpartition(".")
    obj: Any = importlib.import_module(module_name)
    for part in cls_name.split("."):
        obj = getattr(obj, part)
    return obj


class _PortUnpickler(pickle.Unpickler):
    """Resolves every global of a blob through :func:`port_path`."""

    def find_class(self, module: str, name: str):
        path = port_path(f"{module}.{name}")
        module, _, name = path.rpartition(".")
        return super().find_class(module, name)


def load_models_blob(blob: bytes) -> Any:
    """Unpickle a MODELDATA blob (the slot list, or a model inside it)
    without importing the JAX package: see :func:`port_path`."""
    try:
        return _PortUnpickler(io.BytesIO(blob)).load()
    except ForeignClassError as e:
        raise ForeignClassError(f"model blob refused: {e}") from None


def reconcile_state(obj, state: dict, drop: tuple = ()) -> None:
    """Set a dataclass's pickled ``state`` on ``obj`` when the writer's
    class had other fields (the JAX package's, or an older port's):
    missing fields take their defaults, the extra fields named in ``drop``
    go, and any other extra field must be None. Unpickling runs no
    ``__init__``, so the caller normalizes what ``__post_init__`` would."""
    fields = {f.name: f for f in dataclasses.fields(obj)}
    state = dict(state)
    for name, f in fields.items():
        if name in state:
            continue
        if f.default is not dataclasses.MISSING:
            state[name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            state[name] = f.default_factory()
    for key in [k for k in state if k not in fields]:
        value = state.pop(key)
        if key not in drop and value is not None:
            raise ValueError(
                f"{type(obj).__name__} state has field {key!r} = {value!r}, "
                "which the port's class does not have"
            )
    obj.__dict__.update(state)


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
    slots = load_models_blob(blob)
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
