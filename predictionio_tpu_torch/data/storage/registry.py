"""Storage registry: env-var configured driver discovery.

Counterpart of ``predictionio_tpu/data/storage/registry.py`` with the same
configuration contract (parity: ``Storage.scala:146-466``):

* ``PIO_STORAGE_SOURCES_<NAME>_TYPE`` — driver type of source <NAME>; any
  other key after the type becomes a constructor kwarg
  (``PIO_STORAGE_SOURCES_FS_PATH=/data/models`` → ``path=...``).
* ``PIO_STORAGE_REPOSITORIES_{METADATA,EVENTDATA,MODELDATA}_SOURCE`` —
  binds each repository to a named source.

The drivers, as in the JAX package: ``sqlite`` (every repository, the
zero-config default), ``memory`` (every repository), ``localfs`` (models),
``postgres`` (every repository, over the v3 wire protocol; ``TYPE=jdbc``
with a ``postgresql://`` URL resolves to it, any other JDBC URL raises),
``s3`` (models, SigV4 over HTTP), ``network`` (every repository, a remote
``pio storageserver`` that many hosts share) and ``parquet`` (events: the
columnar store on the port's own Parquet codec, by default under
``$PIO_FS_BASEDIR/parquet/<source>``). An environment that names no
source gets source ``DEFAULT`` of type sqlite, the file ``default.sqlite``
under ``PIO_FS_BASEDIR``. Any other type raises, never falling back to a
local store.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

from predictionio_tpu_torch.data.storage import (
    base, localfs, memory, network, parquet, postgres, s3, sqlite,
)

METADATA = "METADATA"
EVENTDATA = "EVENTDATA"
MODELDATA = "MODELDATA"

# driver type → DAO name → factory(source_name, **kwargs)
DRIVERS: dict[str, dict[str, Callable]] = {
    "memory": {
        "LEvents": memory.MemoryLEvents,
        "PEvents": memory.MemoryPEvents,
        "Models": memory.MemoryModels,
        "Apps": memory.MemoryApps,
        "AccessKeys": memory.MemoryAccessKeys,
        "Channels": memory.MemoryChannels,
        "EngineInstances": memory.MemoryEngineInstances,
        "EvaluationInstances": memory.MemoryEvaluationInstances,
        "Sequences": memory.MemorySequences,
    },
    "sqlite": {
        "LEvents": sqlite.SqliteLEvents,
        "PEvents": sqlite.SqlitePEvents,
        "Models": sqlite.SqliteModels,
        "Apps": sqlite.SqliteApps,
        "AccessKeys": sqlite.SqliteAccessKeys,
        "Channels": sqlite.SqliteChannels,
        "EngineInstances": sqlite.SqliteEngineInstances,
        "EvaluationInstances": sqlite.SqliteEvaluationInstances,
        "Sequences": sqlite.SqliteSequences,
    },
    "parquet": {"LEvents": parquet.ParquetLEvents, "PEvents": parquet.ParquetPEvents},
    "localfs": {"Models": localfs.LocalFSModels},
    "s3": {"Models": s3.S3Models},
    "postgres": {
        "LEvents": postgres.PostgresLEvents,
        "PEvents": postgres.PostgresPEvents,
        "Models": postgres.PostgresModels,
        "Apps": postgres.PostgresApps,
        "AccessKeys": postgres.PostgresAccessKeys,
        "Channels": postgres.PostgresChannels,
        "EngineInstances": postgres.PostgresEngineInstances,
        "EvaluationInstances": postgres.PostgresEvaluationInstances,
        "Sequences": postgres.PostgresSequences,
    },
    "network": {
        "LEvents": network.NetworkLEvents,
        "PEvents": network.NetworkPEvents,
        "Models": network.NetworkModels,
        "Apps": network.NetworkApps,
        "AccessKeys": network.NetworkAccessKeys,
        "Channels": network.NetworkChannels,
        "EngineInstances": network.NetworkEngineInstances,
        "EvaluationInstances": network.NetworkEvaluationInstances,
        "Sequences": network.NetworkSequences,
    },
}


def _is_postgres_jdbc_url(url: str) -> bool:
    """A ``TYPE=jdbc`` source whose URL (``jdbc:`` prefix optional) is a
    postgres one maps to the wire driver; the one rule DAO resolution and
    ``pio status`` share."""
    return url.removeprefix("jdbc:").startswith(("postgresql://", "postgres://"))


class StorageError(Exception):
    pass


class Storage:
    """Facade over the configured sources/repositories (object Storage)."""

    _instance: Optional["Storage"] = None

    def __init__(self, env: Optional[dict] = None):
        self.env = dict(env) if env is not None else dict(os.environ)
        self._sources = self._parse_sources()
        self._repos = self._parse_repositories()
        self._dao_cache: dict[tuple[str, str], object] = {}

    # Singleton used by services; tests construct their own with fake env.
    @classmethod
    def instance(cls) -> "Storage":
        if cls._instance is None:
            cls._instance = Storage()
        return cls._instance

    @classmethod
    def reset_instance(cls) -> None:
        cls._instance = None

    # -- env parsing (parity: Storage.scala:158-223) -----------------------
    def _parse_sources(self) -> dict[str, dict]:
        prefix = "PIO_STORAGE_SOURCES_"
        sources: dict[str, dict] = {}
        for k, v in self.env.items():
            if not k.startswith(prefix):
                continue
            rest = k[len(prefix):]
            if "_" not in rest:
                continue
            name, attr = rest.split("_", 1)
            sources.setdefault(name, {})[attr.lower()] = v
        out = {n: a for n, a in sources.items() if "type" in a}
        if not out:
            # zero-config default: sqlite under PIO_FS_BASEDIR
            out["DEFAULT"] = {"type": "sqlite"}
        return out

    def _parse_repositories(self) -> dict[str, str]:
        repos: dict[str, str] = {}
        for repo in (METADATA, EVENTDATA, MODELDATA):
            src = self.env.get(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE")
            if src is None:
                src = next(iter(self._sources))
            if src not in self._sources:
                raise StorageError(
                    f"repository {repo} references undefined source {src}"
                )
            repos[repo] = src
        return repos

    def repository_bindings(self) -> dict[str, tuple[str, str]]:
        """repository → (source name, driver type), for ``pio status``; a
        ``TYPE=jdbc`` source with a postgres URL shows as ``jdbc→postgres``."""
        out = {}
        for repo, source in self._repos.items():
            t = self._sources[source].get("type")
            if t == "jdbc" and _is_postgres_jdbc_url(self._sources[source].get("url", "")):
                t = "jdbc→postgres"
            out[repo] = (source, t)
        return out

    # -- DAO resolution (parity: Storage.getDataObject:310-359) ------------
    def get_data_object(self, repo: str, dao: str):
        key = (repo, dao)
        if key in self._dao_cache:
            return self._dao_cache[key]
        source_name = self._repos[repo]
        attrs = dict(self._sources[source_name])
        type_name = attrs.pop("type")
        if type_name == "jdbc":
            if not _is_postgres_jdbc_url(attrs.get("url", "")):
                # no quiet local fallback for a networked JDBC source
                raise StorageError(
                    f"source {source_name!r}: TYPE=jdbc without a "
                    "postgresql:// URL names a client/server SQL database "
                    "this build does not speak. Use TYPE=postgres with "
                    f"PIO_STORAGE_SOURCES_{source_name}_URL=postgresql://"
                    "user:pass@host/db, TYPE=sqlite for a single-host "
                    "file store, or TYPE=network against `pio "
                    "storageserver` for a shared data plane."
                )
            type_name = "postgres"
        if type_name not in DRIVERS:
            raise StorageError(f"unknown storage type {type_name!r}")
        if dao not in DRIVERS[type_name]:
            raise StorageError(
                f"storage type {type_name!r} does not implement {dao} "
                f"(required by repository {repo})"
            )
        obj = DRIVERS[type_name][dao](source_name=source_name, **attrs)
        self._dao_cache[key] = obj
        return obj

    # -- typed accessors (parity: Storage.getMetaDataApps etc.) ------------
    def get_l_events(self) -> base.LEvents:
        return self.get_data_object(EVENTDATA, "LEvents")

    def get_p_events(self) -> base.PEvents:
        return self.get_data_object(EVENTDATA, "PEvents")

    def get_model_data_models(self) -> base.Models:
        return self.get_data_object(MODELDATA, "Models")

    def get_meta_data_apps(self) -> base.Apps:
        return self.get_data_object(METADATA, "Apps")

    def get_meta_data_access_keys(self) -> base.AccessKeys:
        return self.get_data_object(METADATA, "AccessKeys")

    def get_meta_data_channels(self) -> base.Channels:
        return self.get_data_object(METADATA, "Channels")

    def get_meta_data_engine_instances(self) -> base.EngineInstances:
        return self.get_data_object(METADATA, "EngineInstances")

    def get_meta_data_evaluation_instances(self) -> base.EvaluationInstances:
        return self.get_data_object(METADATA, "EvaluationInstances")

    def get_meta_data_sequences(self) -> base.Sequences:
        return self.get_data_object(METADATA, "Sequences")

    def resilience_stats(self) -> Optional[dict]:
        """Retry and breaker state merged over the cached network DAOs, or
        None when no network client is live (the obs bridge then renders
        nothing)."""
        merged: Optional[dict] = None
        for obj in list(self._dao_cache.values()):
            rs = getattr(getattr(obj, "_c", None), "resilience_stats", None)
            if not callable(rs):
                continue
            s = rs()
            if merged is None:
                merged = {"retries": 0, "retry_budget_tokens": None, "breakers": {}}
            merged["retries"] += s.get("retries") or 0
            tokens = s.get("retry_budget_tokens")
            if tokens is not None:
                prior = merged["retry_budget_tokens"]
                # the most exhausted client is the signal
                merged["retry_budget_tokens"] = tokens if prior is None else min(prior, tokens)
            merged["breakers"].update(s.get("breakers") or {})
        return merged

    # -- smoke check (parity: Storage.verifyAllDataObjects:372-394) --------
    def verify_all_data_objects(self) -> bool:
        """Touch every repository, then write, read and delete one event."""
        from predictionio_tpu_torch.data.event import Event

        self.get_meta_data_apps()
        self.get_meta_data_access_keys()
        self.get_meta_data_channels()
        self.get_meta_data_engine_instances()
        self.get_meta_data_evaluation_instances()
        self.get_model_data_models()
        levents = self.get_l_events()
        levents.init(0)
        eid = levents.insert(
            Event(event="$set", entity_type="pio_pr", entity_id="1",
                  properties={"pio_storage_verification": True}),
            0,
        )
        ok = levents.get(eid, 0) is not None
        levents.delete(eid, 0)
        levents.remove(0)
        return ok
