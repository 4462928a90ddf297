"""Multi-tenant serving: tenant registry, per-tenant QoS, A/B splits.

Counterpart of ``predictionio_tpu/serving/tenancy.py``, line for line: the
same ``PIO_TENANTS`` config, the same admission order and the same
``hashlib`` bucketing, so a (tenant, user) pair lands on the same variant
under either package. The reference platform hosts MANY apps behind one
event+query surface (apps, access keys, channels); this is the layer that
lets one deployment serve several:

* :class:`TenantSpec` — one tenant's contract: access key, traffic
  weight, qps quota, latency SLO, engine variant, and optional weighted
  A/B variant splits.
* :class:`TenantRegistry` — the runtime the query server and fleet
  router consult per request: access-key authentication, fair-share
  admission (per-tenant inflight caps derived from traffic weights ×
  ``PIO_TENANT_BURST``), token-bucket quota shedding (503 +
  ``Retry-After``), a per-tenant circuit breaker (one tenant's failing
  backend fails fast WITHOUT opening any other tenant's breaker — the
  chaos-isolation contract tested via the ``client:tenant:<id>`` fault
  site), per-variant online metrics, and per-tenant pressure signals
  for the autoscaler.
* :func:`pick_variant` — deterministic weighted A/B bucketing: the
  variant is a pure function of ``(tenant, user key)``, so the same
  user lands on the same variant on every replica and across restarts
  (no sticky-session state to lose).

Admission layers UNDER the existing global gates: a request must pass
its tenant's breaker, quota, and inflight share before it contends for
the server-wide ``max_inflight`` slot — one tenant saturating its
quota is shed at its own cap while other tenants' latency is
untouched.

Everything here is stdlib-only: the router imports it in the fleet's
front-end process, which opens no CUDA context.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from typing import Any, Callable, Iterable, Optional

from predictionio_tpu_torch.common.resilience import CircuitBreaker
from predictionio_tpu_torch.utils.profiling import LatencyHistogram

#: variant label used for tenants with no A/B split configured
DEFAULT_VARIANT = "-"


@dataclasses.dataclass(frozen=True)
class VariantSpec:
    """One arm of a tenant's A/B split.  ``engine_variant`` optionally
    routes this arm to a differently-trained engine variant; None serves
    the tenant's (or server's) default deployment."""

    name: str
    weight: float = 1.0
    engine_variant: Optional[str] = None

    def to_dict(self) -> dict:
        out: dict = {"name": self.name, "weight": self.weight}
        if self.engine_variant is not None:
            out["engineVariant"] = self.engine_variant
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "VariantSpec":
        return cls(
            name=str(d["name"]),
            weight=float(d.get("weight", 1.0)),
            engine_variant=d.get("engineVariant"),
        )


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's serving contract (the registry's unit of config)."""

    tenant_id: str
    access_key: str
    weight: float = 1.0
    quota_qps: Optional[float] = None
    slo_ms: Optional[float] = None
    engine_variant: Optional[str] = None
    variants: tuple[VariantSpec, ...] = ()

    def validate(self) -> None:
        if not self.tenant_id:
            raise ValueError("tenant_id must be non-empty")
        if not self.access_key:
            raise ValueError(f"tenant {self.tenant_id}: empty access_key")
        if self.weight <= 0:
            raise ValueError(f"tenant {self.tenant_id}: weight must be > 0")
        if self.quota_qps is not None and self.quota_qps <= 0:
            raise ValueError(
                f"tenant {self.tenant_id}: quota_qps must be > 0 or absent"
            )
        if self.slo_ms is not None and self.slo_ms <= 0:
            raise ValueError(
                f"tenant {self.tenant_id}: slo_ms must be > 0 or absent"
            )
        seen = set()
        for v in self.variants:
            if v.weight <= 0:
                raise ValueError(
                    f"tenant {self.tenant_id}: variant {v.name!r} weight "
                    "must be > 0"
                )
            if v.name in seen:
                raise ValueError(
                    f"tenant {self.tenant_id}: duplicate variant {v.name!r}"
                )
            seen.add(v.name)

    def to_dict(self) -> dict:
        out: dict = {
            "tenantId": self.tenant_id,
            "accessKey": self.access_key,
            "weight": self.weight,
        }
        if self.quota_qps is not None:
            out["quotaQps"] = self.quota_qps
        if self.slo_ms is not None:
            out["sloMs"] = self.slo_ms
        if self.engine_variant is not None:
            out["engineVariant"] = self.engine_variant
        if self.variants:
            out["variants"] = [v.to_dict() for v in self.variants]
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "TenantSpec":
        spec = cls(
            tenant_id=str(d.get("tenantId") or d.get("tenant_id") or ""),
            access_key=str(d.get("accessKey") or d.get("access_key") or ""),
            weight=float(d.get("weight", 1.0)),
            quota_qps=(
                float(d["quotaQps"]) if d.get("quotaQps") is not None else None
            ),
            slo_ms=float(d["sloMs"]) if d.get("sloMs") is not None else None,
            engine_variant=d.get("engineVariant"),
            variants=tuple(
                VariantSpec.from_dict(v) for v in d.get("variants", [])
            ),
        )
        spec.validate()
        return spec


def pick_variant(
    tenant_id: str, user_key: str, variants: Iterable[VariantSpec],
    salt: str = "",
) -> str:
    """Deterministic weighted A/B bucketing.

    The bucket is a pure function of ``(tenant, salt, user key)`` — a
    sha256 digest mapped to [0, 1) and walked down the cumulative
    variant weights — so the same user hits the same variant on every
    replica and across restarts, with no session state.  An empty user
    key still buckets deterministically (all anonymous traffic lands on
    one arm rather than flapping per request).
    """
    arms = list(variants)
    if not arms:
        return DEFAULT_VARIANT
    digest = hashlib.sha256(
        f"{tenant_id}\x1f{salt}\x1f{user_key}".encode()
    ).digest()
    # 8 bytes of digest → uniform fraction in [0, 1)
    frac = int.from_bytes(digest[:8], "big") / float(1 << 64)
    total = sum(v.weight for v in arms)
    acc = 0.0
    for v in arms:
        acc += v.weight / total
        if frac < acc:
            return v.name
    return arms[-1].name


@dataclasses.dataclass(frozen=True)
class Admission:
    """One admit() verdict.  ``reason`` is None when admitted, else one
    of ``quota`` / ``inflight`` / ``breaker``."""

    ok: bool
    reason: Optional[str] = None
    retry_after_s: float = 1.0


class _TenantState:
    """Runtime counters for one tenant (guarded by the registry lock,
    except the per-variant latency histograms which lock themselves)."""

    def __init__(self, spec: TenantSpec, cap: int, burst: float):
        self.spec = spec
        self.cap = cap
        self.inflight = 0
        # token bucket: `burst` seconds of quota banked at full rate
        self.tokens = (
            spec.quota_qps * burst if spec.quota_qps is not None else 0.0
        )
        self.token_cap = self.tokens
        self.last_refill: Optional[float] = None
        self.breaker = CircuitBreaker(
            f"tenant:{spec.tenant_id}", failure_threshold=5,
            reset_timeout_s=5.0,
        )
        self.admitted = 0
        self.shed = {"quota": 0, "inflight": 0, "breaker": 0}
        self.slo_violations = 0
        # variant → online comparison stats (the A/B readout)
        self.variant_stats: dict[str, dict] = {}

    def variant_entry(self, variant: str) -> dict:
        entry = self.variant_stats.get(variant)
        if entry is None:
            entry = {"requests": 0, "errors": 0, "latency": LatencyHistogram()}
            self.variant_stats[variant] = entry
        return entry


class TenantRegistry:
    """Thread-safe tenant runtime: auth, fair-share admission, quotas,
    per-tenant breakers, A/B bucketing, and stats."""

    def __init__(
        self,
        specs: Iterable[TenantSpec],
        total_inflight: int = 256,
        burst: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        specs = list(specs)
        if not specs:
            raise ValueError("a tenant registry needs at least one tenant")
        for s in specs:
            s.validate()
        ids = [s.tenant_id for s in specs]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate tenant ids in {ids}")
        keys = [s.access_key for s in specs]
        if len(set(keys)) != len(keys):
            raise ValueError("tenants must have distinct access keys")
        if burst is None:
            try:
                burst = float(os.environ.get("PIO_TENANT_BURST", 2.0))
            except (TypeError, ValueError):
                burst = 2.0
        self.burst = max(1.0, float(burst))
        self.total_inflight = int(total_inflight)
        self._clock = clock
        self._lock = threading.Lock()
        total_weight = sum(s.weight for s in specs)
        self._tenants: dict[str, _TenantState] = {}
        for s in specs:
            # fair share of the server's admission budget, scaled by the
            # burst factor so an under-subscribed server still lets one
            # tenant use idle capacity — but never the whole gate
            cap = max(
                1,
                min(
                    self.total_inflight,
                    int(round(
                        self.total_inflight * (s.weight / total_weight)
                        * self.burst
                    )),
                ),
            )
            self._tenants[s.tenant_id] = _TenantState(s, cap, self.burst)
        self._by_key = {s.access_key: s.tenant_id for s in specs}

    # -- config introspection ------------------------------------------------
    def specs(self) -> list[TenantSpec]:
        with self._lock:
            return [st.spec for st in self._tenants.values()]

    def engine_variants(self) -> set[str]:
        """Every engine variant the registry can route to (tenant-level
        and A/B-arm-level) — the query server pre-deploys these."""
        out: set[str] = set()
        with self._lock:
            for st in self._tenants.values():
                if st.spec.engine_variant:
                    out.add(st.spec.engine_variant)
                for v in st.spec.variants:
                    if v.engine_variant:
                        out.add(v.engine_variant)
        return out

    # -- auth ----------------------------------------------------------------
    def authenticate(self, access_key: Optional[str]) -> Optional[TenantSpec]:
        if not access_key:
            return None
        with self._lock:
            tid = self._by_key.get(access_key)
            return self._tenants[tid].spec if tid is not None else None

    def get(self, tenant_id: str) -> Optional[TenantSpec]:
        with self._lock:
            st = self._tenants.get(tenant_id)
            return st.spec if st is not None else None

    # -- admission -----------------------------------------------------------
    def _refill_locked(self, st: _TenantState, now: float) -> None:
        qps = st.spec.quota_qps
        if qps is None:
            return
        if st.last_refill is None:
            st.last_refill = now
            return
        st.tokens = min(
            st.token_cap, st.tokens + (now - st.last_refill) * qps
        )
        st.last_refill = now

    def admit(self, tenant_id: str) -> Admission:
        """Fair-share admission: breaker → quota token → inflight share.

        Runs BEFORE the server-wide gate, so one tenant saturating its
        quota sheds at its own cap and never consumes another tenant's
        slots.  Shed answers carry a quota-aware ``Retry-After``.
        """
        now = self._clock()
        with self._lock:
            st = self._tenants.get(tenant_id)
            if st is None:
                return Admission(False, "breaker", 1.0)
            if not st.breaker.allow():
                st.shed["breaker"] += 1
                return Admission(
                    False, "breaker",
                    round(st.breaker.reset_timeout_s, 2),
                )
            self._refill_locked(st, now)
            if st.spec.quota_qps is not None and st.tokens < 1.0:
                st.shed["quota"] += 1
                # when the next token lands — the honest backoff hint
                retry = (1.0 - st.tokens) / st.spec.quota_qps
                return Admission(False, "quota", round(max(retry, 0.05), 2))
            if st.inflight >= st.cap:
                st.shed["inflight"] += 1
                return Admission(
                    False, "inflight",
                    round(max(0.1, st.inflight / (2.0 * st.cap)), 2),
                )
            if st.spec.quota_qps is not None:
                st.tokens -= 1.0
            st.inflight += 1
            st.admitted += 1
            return Admission(True)

    def release(self, tenant_id: str) -> None:
        with self._lock:
            st = self._tenants.get(tenant_id)
            if st is not None and st.inflight > 0:
                st.inflight -= 1

    def record_result(
        self,
        tenant_id: str,
        variant: str,
        ok: bool,
        latency_s: float,
    ) -> None:
        """Close the loop on one admitted request: feed THIS tenant's
        breaker (isolation: no other tenant's breaker sees it), the
        per-variant online comparison, and the SLO ledger."""
        with self._lock:
            st = self._tenants.get(tenant_id)
            if st is None:
                return
            entry = st.variant_entry(variant or DEFAULT_VARIANT)
            entry["requests"] += 1
            if ok:
                st.breaker.record_success()
                entry["latency"].observe(latency_s)
                if (
                    st.spec.slo_ms is not None
                    and latency_s * 1e3 > st.spec.slo_ms
                ):
                    st.slo_violations += 1
            else:
                entry["errors"] += 1
                st.breaker.record_failure()

    # -- A/B -----------------------------------------------------------------
    def pick_variant(self, tenant_id: str, user_key: Any) -> str:
        spec = self.get(tenant_id)
        if spec is None or not spec.variants:
            return DEFAULT_VARIANT
        return pick_variant(
            tenant_id, str(user_key if user_key is not None else ""),
            spec.variants,
        )

    def variant_spec(self, tenant_id: str, variant: str) -> Optional[VariantSpec]:
        spec = self.get(tenant_id)
        if spec is None:
            return None
        for v in spec.variants:
            if v.name == variant:
                return v
        return None

    # -- signals -------------------------------------------------------------
    def pressure(self) -> dict[str, float]:
        """Per-tenant pressure in [0, 1] for the autoscaler: inflight
        saturation against the fair-share cap (quota sheds are a
        contract, not pressure — a quota-shed tenant must NOT scale the
        fleet up)."""
        with self._lock:
            return {
                tid: round(min(1.0, st.inflight / float(st.cap)), 4)
                for tid, st in self._tenants.items()
            }

    def stats(self) -> dict:
        """One consistent snapshot for ``/metrics`` bridges and CLI."""
        with self._lock:
            out: dict = {}
            for tid, st in self._tenants.items():
                variants = {}
                for name, entry in st.variant_stats.items():
                    lat: LatencyHistogram = entry["latency"]
                    variants[name] = {
                        "requests": entry["requests"],
                        "errors": entry["errors"],
                        "p50_ms": round(lat.quantile(0.50), 3),
                        "p99_ms": round(lat.quantile(0.99), 3),
                    }
                out[tid] = {
                    "weight": st.spec.weight,
                    "cap": st.cap,
                    "inflight": st.inflight,
                    "quota_qps": st.spec.quota_qps,
                    "tokens": round(st.tokens, 2),
                    "slo_ms": st.spec.slo_ms,
                    "slo_violations": st.slo_violations,
                    "admitted": st.admitted,
                    "shed": dict(st.shed),
                    "breaker": st.breaker.state,
                    "variants": variants,
                }
            return out


def extract_access_key(
    params: Optional[dict] = None,
    headers: Any = None,
    data: Optional[dict] = None,
) -> Optional[str]:
    """The access key for one request: query param first (the event
    server's idiom), then the request body's ``accessKey`` field (what
    the loadtest/scenario drivers rotate per tenant).  Body keys are
    auth metadata, not query semantics — the result-cache fingerprint
    excludes them and namespaces by tenant instead."""
    if params:
        key = params.get("accessKey")
        if key:
            return key
    if headers is not None:
        try:
            key = headers.get("X-PIO-Access-Key")
        except AttributeError:
            key = None
        if key:
            return key
    if isinstance(data, dict):
        key = data.get("accessKey")
        if isinstance(key, str) and key:
            return key
    return None


def registry_from_config(
    config: Any, total_inflight: int = 256
) -> TenantRegistry:
    """Build a registry from parsed JSON config: either a bare list of
    tenant dicts or ``{"tenants": [...]}``."""
    if isinstance(config, dict):
        config = config.get("tenants", [])
    if not isinstance(config, list):
        raise ValueError(
            "tenant config must be a list of tenants or "
            '{"tenants": [...]}'
        )
    return TenantRegistry(
        [TenantSpec.from_dict(d) for d in config],
        total_inflight=total_inflight,
    )


def tenants_from_env(total_inflight: int = 256) -> Optional[TenantRegistry]:
    """Build the tenant registry from ``PIO_TENANTS``: a path to a JSON
    config file, or (for tests/dev) the JSON itself inline.  None when
    unset — single-tenant open access, byte-identical to the
    pre-tenancy server."""
    raw = os.environ.get("PIO_TENANTS", "")
    raw = raw.strip()
    if not raw:
        return None
    if raw.startswith("{") or raw.startswith("["):
        config = json.loads(raw)
    else:
        with open(raw, "r", encoding="utf-8") as f:
            config = json.load(f)
    return registry_from_config(config, total_inflight=total_inflight)
