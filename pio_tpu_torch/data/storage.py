"""Storage locator — env-var driven backend registry.

Operational parity with reference data/.../storage/Storage.scala:124-391:

 * sources are declared as ``PIO_STORAGE_SOURCES_<NAME>_TYPE`` plus arbitrary
   ``PIO_STORAGE_SOURCES_<NAME>_<KEY>`` properties;
 * the three repositories bind to sources via
   ``PIO_STORAGE_REPOSITORIES_{METADATA,EVENTDATA,MODELDATA}_{NAME,SOURCE}``;
 * backends are discovered by type name (reference discovers
   ``<pkg>.StorageClient`` reflectively; we keep an explicit registry —
   ``register_backend`` — which third-party backends can extend).

When no env configuration exists we default everything to a sqlite source at
``$PIO_TPU_HOME/pio.db`` (reference fails instead; a zero-config default is
deliberate dev UX).

Copy of ``pio_tpu.data.storage`` without the PostgreSQL and MySQL backends
(``postgres``, ``postgresql``, ``mysql``), which are not ported yet: asking
for one raises the registry's "No storage backend registered" error.
"""

from __future__ import annotations

import importlib
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Callable

from pio_tpu_torch.data import dao as daomod
from pio_tpu_torch.resilience import CircuitBreaker, ResilientDAO


class StorageError(RuntimeError):
    pass


@dataclass(frozen=True)
class StorageClientConfig:
    """Reference Storage.scala:59,77 StorageClientConfig."""

    properties: dict[str, str] = field(default_factory=dict)
    parallel: bool = False
    test: bool = False


class Backend:
    """One storage source: a factory for DAO implementations.

    Backends subclass and override the DAOs they support; unsupported DAOs
    raise StorageError (reference: ES backend is metadata-only, HDFS/localfs
    are models-only — same shape here).
    """

    def __init__(self, config: StorageClientConfig):
        self.config = config

    def apps(self) -> daomod.AppsDAO:
        raise StorageError(f"{type(self).__name__} does not support Apps")

    def access_keys(self) -> daomod.AccessKeysDAO:
        raise StorageError(f"{type(self).__name__} does not support AccessKeys")

    def channels(self) -> daomod.ChannelsDAO:
        raise StorageError(f"{type(self).__name__} does not support Channels")

    def engine_instances(self) -> daomod.EngineInstancesDAO:
        raise StorageError(f"{type(self).__name__} does not support EngineInstances")

    def engine_manifests(self) -> daomod.EngineManifestsDAO:
        raise StorageError(f"{type(self).__name__} does not support EngineManifests")

    def evaluation_instances(self) -> daomod.EvaluationInstancesDAO:
        raise StorageError(
            f"{type(self).__name__} does not support EvaluationInstances"
        )

    def models(self) -> daomod.ModelsDAO:
        raise StorageError(f"{type(self).__name__} does not support Models")

    def events(self) -> daomod.EventsDAO:
        raise StorageError(f"{type(self).__name__} does not support Events")

    def close(self) -> None:
        pass


# type name -> "module:ClassName" (lazy import so optional deps stay optional)
_BACKEND_REGISTRY: dict[str, str] = {
    "memory": "pio_tpu_torch.data.backends.memory:MemoryBackend",
    "sqlite": "pio_tpu_torch.data.backends.sqlite:SqliteBackend",
    "jdbc": "pio_tpu_torch.data.backends.sqlite:SqliteBackend",  # operational alias
    "localfs": "pio_tpu_torch.data.backends.localfs:LocalFSBackend",
    # native C++ append-only log (the HBase-analog event store)
    "eventlog": "pio_tpu_torch.data.backends.eventlog:EventLogBackend",
    "hbase": "pio_tpu_torch.data.backends.eventlog:EventLogBackend",  # operational alias
    # networked client for the storage server (multi-host shared store)
    "remote": "pio_tpu_torch.data.backends.remote:RemoteBackend",
    # entity-hash-sharded composite over N storage servers (the
    # reference's HBase region-distribution role, HBEventsUtil.scala:74)
    "sharded": "pio_tpu_torch.data.backends.sharded:ShardedBackend",
    # R-way replicated event store: quorum writes + hinted handoff +
    # anti-entropy scrub (the reference's HBase replication role)
    "replicated": "pio_tpu_torch.data.backends.replicated:ReplicatedBackend",
}


def register_backend(type_name: str, target: str) -> None:
    """Register ``type_name`` -> "module:ClassName" (plugin point; replaces
    the reference's reflective class-name convention, Storage.scala:212-322).
    """
    _BACKEND_REGISTRY[type_name.lower()] = target


def _load_backend_class(type_name: str) -> type[Backend]:
    target = _BACKEND_REGISTRY.get(type_name.lower())
    if target is None:
        raise StorageError(
            f"No storage backend registered for type '{type_name}'. "
            f"Known: {sorted(_BACKEND_REGISTRY)}"
        )
    mod_name, _, cls_name = target.partition(":")
    mod = importlib.import_module(mod_name)
    return getattr(mod, cls_name)


REPOSITORIES = ("METADATA", "EVENTDATA", "MODELDATA")


@dataclass(frozen=True)
class SourceSpec:
    name: str
    type: str
    properties: dict[str, str]


def _default_home() -> str:
    return os.environ.get(
        "PIO_TPU_HOME", os.path.join(os.path.expanduser("~"), ".pio_tpu")
    )


def parse_env(env: dict[str, str] | None = None) -> tuple[
    dict[str, SourceSpec], dict[str, str]
]:
    """Parse PIO_STORAGE_* env vars (reference Storage.scala:124-193).

    Returns (sources by name, repository -> source name).
    """
    env = dict(os.environ if env is None else env)
    src_prefix = "PIO_STORAGE_SOURCES_"
    repo_prefix = "PIO_STORAGE_REPOSITORIES_"

    raw_sources: dict[str, dict[str, str]] = {}
    for k, v in env.items():
        if not k.startswith(src_prefix):
            continue
        rest = k[len(src_prefix):]
        name, _, prop = rest.partition("_")
        if not name or not prop:
            continue
        raw_sources.setdefault(name, {})[prop] = v

    sources: dict[str, SourceSpec] = {}
    for name, props in raw_sources.items():
        t = props.get("TYPE")
        if not t:
            continue
        sources[name] = SourceSpec(
            name=name,
            type=t,
            properties={k: v for k, v in props.items() if k != "TYPE"},
        )

    repos: dict[str, str] = {}
    for repo in REPOSITORIES:
        src = env.get(f"{repo_prefix}{repo}_SOURCE")
        if src:
            repos[repo] = src

    if not sources and not repos:
        # zero-config default: one sqlite source for everything
        home = _default_home()
        sources["DEFAULT"] = SourceSpec(
            name="DEFAULT",
            type="sqlite",
            properties={"PATH": os.path.join(home, "pio.db")},
        )
        repos = {r: "DEFAULT" for r in REPOSITORIES}
    return sources, repos


class Storage:
    """Storage access facade (reference Storage.scala:360-391 repo getters).

    One instance per process is typical (module-level singleton via
    ``get_storage``); construct directly with an env dict for tests.
    """

    def __init__(self, env: dict[str, str] | None = None, test: bool = False,
                 resilience: bool | None = None):
        self.sources, self.repositories = parse_env(env)
        self.test = test
        self._clients: dict[str, Backend] = {}
        self._lock = threading.Lock()
        # resilience wrapping (retry + circuit breaker + deadline + chaos
        # point per DAO call). Default ON; PIO_TPU_RESILIENCE=off (or the
        # explicit arg) disables for raw-backend benchmarking.
        if resilience is None:
            resilience = os.environ.get(
                "PIO_TPU_RESILIENCE", "on").lower() not in (
                    "off", "0", "false", "no")
        self.resilience_enabled = resilience
        # one breaker per storage SOURCE (not per DAO): every repository
        # bound to a source shares its failure history, mirroring how a
        # dead backend takes out all of its DAOs at once
        self.breakers: dict[str, CircuitBreaker] = {}

    def _client(self, source_name: str) -> Backend:
        with self._lock:
            if source_name not in self._clients:
                spec = self.sources.get(source_name)
                if spec is None:
                    raise StorageError(
                        f"Undefined storage source '{source_name}'. "
                        f"Defined: {sorted(self.sources)}"
                    )
                cls = _load_backend_class(spec.type)
                self._clients[source_name] = cls(
                    StorageClientConfig(properties=spec.properties, test=self.test)
                )
            return self._clients[source_name]

    def _repo_source(self, repo: str) -> str:
        src = self.repositories.get(repo)
        if src is None:
            raise StorageError(
                f"Repository {repo} is not configured "
                f"(set PIO_STORAGE_REPOSITORIES_{repo}_SOURCE)"
            )
        return src

    def _repo_client(self, repo: str) -> Backend:
        return self._client(self._repo_source(repo))

    def breaker_for(self, source_name: str) -> CircuitBreaker:
        """The circuit breaker fronting one storage source (created on
        first use; `pio doctor` and /readyz read `self.breakers`)."""
        with self._lock:
            br = self.breakers.get(source_name)
            if br is None:
                br = CircuitBreaker(f"storage.{source_name}")
                self.breakers[source_name] = br
            return br

    def _dao(self, repo: str, getter: Callable[[Backend], Any]):
        """Resolve a DAO and, unless resilience is disabled, front it
        with retry + the source's breaker + deadline/chaos hooks."""
        src = self._repo_source(repo)
        dao = getter(self._client(src))
        if not self.resilience_enabled:
            return dao
        return ResilientDAO(
            dao, breaker=self.breaker_for(src), point=f"storage.{src}"
        )

    # -- reference Storage.scala:360-391 ------------------------------------
    def get_metadata_apps(self) -> daomod.AppsDAO:
        return self._dao("METADATA", lambda b: b.apps())

    def get_metadata_access_keys(self) -> daomod.AccessKeysDAO:
        return self._dao("METADATA", lambda b: b.access_keys())

    def get_metadata_channels(self) -> daomod.ChannelsDAO:
        return self._dao("METADATA", lambda b: b.channels())

    def get_metadata_engine_instances(self) -> daomod.EngineInstancesDAO:
        return self._dao("METADATA", lambda b: b.engine_instances())

    def get_metadata_engine_manifests(self) -> daomod.EngineManifestsDAO:
        return self._dao("METADATA", lambda b: b.engine_manifests())

    def get_metadata_evaluation_instances(self) -> daomod.EvaluationInstancesDAO:
        return self._dao("METADATA", lambda b: b.evaluation_instances())

    def get_model_data_models(self) -> daomod.ModelsDAO:
        return self._dao("MODELDATA", lambda b: b.models())

    def get_events(self) -> daomod.EventsDAO:
        """The L/PEvents DAO (one API — columnarization for training lives in
        pio_tpu_torch.data.eventstore)."""
        return self._dao("EVENTDATA", lambda b: b.events())

    def verify_all(self) -> list[str]:
        """Touch every repository DAO; returns a list of error strings
        (reference Storage.verifyAllDataObjects:335-358)."""
        errors = []
        checks: list[tuple[str, Callable[[], Any]]] = [
            ("METADATA/Apps", self.get_metadata_apps),
            ("METADATA/AccessKeys", self.get_metadata_access_keys),
            ("METADATA/Channels", self.get_metadata_channels),
            ("METADATA/EngineInstances", self.get_metadata_engine_instances),
            ("METADATA/EngineManifests", self.get_metadata_engine_manifests),
            ("METADATA/EvaluationInstances", self.get_metadata_evaluation_instances),
            ("MODELDATA/Models", self.get_model_data_models),
            ("EVENTDATA/Events", self.get_events),
        ]
        for name, fn in checks:
            try:
                fn()
            except Exception as e:  # noqa: BLE001 - diagnostic walk
                errors.append(f"{name}: {e}")
        return errors

    def close(self) -> None:
        with self._lock:
            for c in self._clients.values():
                c.close()
            self._clients.clear()


_storage_singleton: Storage | None = None
_singleton_lock = threading.Lock()


def get_storage() -> Storage:
    global _storage_singleton
    with _singleton_lock:
        if _storage_singleton is None:
            _storage_singleton = Storage()
        return _storage_singleton


def set_storage(storage: Storage | None) -> None:
    """Swap the process-wide storage (tests, CLI --env overrides)."""
    global _storage_singleton
    with _singleton_lock:
        _storage_singleton = storage
