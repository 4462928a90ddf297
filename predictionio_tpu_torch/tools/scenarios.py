"""Traffic-scenario engine: time-varying load programs for ``pio loadtest``.

Counterpart of ``predictionio_tpu/tools/scenarios.py``, whole; its report
also gives ``issuedPerSec``, the rate the client really issued.

:func:`~predictionio_tpu_torch.tools.loadtest.run_loadtest` drives constant
closed-loop traffic; real serving load is diurnal, spiky, and
adversarial.  This module models that as a **scenario
program**: an ordered list of phases, each a time-varying arrival-rate
shape with optional workload-skew dynamics, compiled to a deterministic
open-loop arrival schedule and replayed against a live server with
per-phase SLO accounting (p50/p99/shed/error per segment).

DSL (``--scenario``): phases are ``;``-separated, each phase is
``kind:key=val,key=val``::

    steady:rate=30,duration=6;flash:base=30,peak=300,at=2,duration=12

Phase kinds:

* ``steady`` — constant ``rate`` req/s.
* ``ramp`` — linear ``start`` → ``end`` req/s over the phase.
* ``sine`` — diurnal shape: ``base + amp * sin(2πt/period)``, floored
  at 0 (one ``period`` = one compressed "day").
* ``flash`` — flash crowd: ``base`` until ``at`` seconds in, then a
  step to ``peak`` (default ``10 × base``) for ``hold`` seconds
  (default: the rest of the phase), then back to ``base``.
* ``zipfdrift`` — constant ``rate`` while the Zipf exponent of sampled
  keys drifts ``s0`` → ``s1`` (a hot set heating up or dissolving —
  stresses the skew-aware caches).
* ``mixshift`` — constant ``rate`` while the traffic mix between two
  tenant halves of the sample values shifts ``from`` → ``to`` (share
  of the first half).

Everything up to the actual HTTP replay is pure math on a simulated
clock — :meth:`ScenarioProgram.arrivals` and the payload schedule are
deterministic given the seed, which is what the tier-1 smoke tests
exercise without a single sleep.
"""

from __future__ import annotations

import http.client
import json
import math
import threading
import time
import urllib.parse
from dataclasses import dataclass, field
from typing import Optional

from predictionio_tpu_torch.tools.loadtest import zipf_mandelbrot_weights

KINDS = ("steady", "ramp", "sine", "flash", "zipfdrift", "mixshift")

#: Hard cap on one program's compiled arrival schedule — a typo'd
#: ``rate=30000`` should fail loudly, not allocate forever.
MAX_ARRIVALS = 200_000


@dataclass
class Phase:
    """One segment of a scenario program.  ``rate_at``/``zipf_s_at``/
    ``mix_at`` take the phase-local time in ``[0, duration_s)``."""

    kind: str
    duration_s: float
    params: dict = field(default_factory=dict)
    name: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown scenario kind {self.kind!r}; one of {KINDS}"
            )
        if self.duration_s <= 0:
            raise ValueError(f"phase {self.kind}: duration must be > 0")
        if not self.name:
            self.name = self.kind

    def _p(self, key: str, default=None) -> Optional[float]:
        v = self.params.get(key, default)
        return None if v is None else float(v)

    def rate_at(self, t: float) -> float:
        p = self._p
        if self.kind == "steady":
            return max(0.0, p("rate", 10.0))
        if self.kind == "ramp":
            frac = min(1.0, max(0.0, t / self.duration_s))
            return max(
                0.0, p("start", 1.0) + (p("end", 10.0) - p("start", 1.0)) * frac
            )
        if self.kind == "sine":
            base = p("base", 10.0)
            amp = p("amp", base * 0.5)
            period = p("period", self.duration_s)
            return max(0.0, base + amp * math.sin(2 * math.pi * t / period))
        if self.kind == "flash":
            base = p("base", 10.0)
            at = p("at", self.duration_s / 3.0)
            hold = p("hold", self.duration_s - at)
            if at <= t < at + hold:
                return max(0.0, p("peak", base * 10.0))
            return max(0.0, base)
        # zipfdrift / mixshift hold their rate constant; the *workload*
        # moves instead
        return max(0.0, p("rate", 10.0))

    def zipf_s_at(self, t: float) -> Optional[float]:
        if self.kind != "zipfdrift":
            return self._p("zipf_s")
        frac = min(1.0, max(0.0, t / self.duration_s))
        s0 = self._p("s0", 1.1)
        s1 = self._p("s1", 1.1)
        return s0 + (s1 - s0) * frac

    def mix_at(self, t: float) -> Optional[float]:
        """Share of the FIRST tenant half of the sample values, or None
        when this phase doesn't shift the mix."""
        if self.kind != "mixshift":
            return None
        frac = min(1.0, max(0.0, t / self.duration_s))
        lo = self._p("from", 0.9)
        hi = self._p("to", 0.1)
        return min(1.0, max(0.0, lo + (hi - lo) * frac))


class ScenarioProgram:
    """Phases glued end to end on one clock, compiled to arrivals."""

    def __init__(self, phases: list[Phase]):
        if not phases:
            raise ValueError("a scenario needs at least one phase")
        self.phases = list(phases)
        self._starts: list[float] = []
        acc = 0.0
        for ph in self.phases:
            self._starts.append(acc)
            acc += ph.duration_s
        self.duration_s = acc

    def phase_at(self, t: float) -> tuple[int, Phase, float]:
        """(index, phase, phase-local time) for global time ``t``;
        times past the end clamp to the last phase."""
        for i in range(len(self.phases) - 1, -1, -1):
            if t >= self._starts[i]:
                return i, self.phases[i], t - self._starts[i]
        return 0, self.phases[0], 0.0

    def rate_at(self, t: float) -> float:
        i, ph, lt = self.phase_at(t)
        return ph.rate_at(lt)

    def arrivals(self, max_requests: int = MAX_ARRIVALS) -> list:
        """The compiled schedule: ``[(t, phase_index), ...]`` — request
        n fires 1/rate after request n-1, rates sampled at emit time.
        Pure math, deterministic, no clock reads."""
        out: list[tuple[float, int]] = []
        t = 0.0
        while t < self.duration_s:
            i, ph, lt = self.phase_at(t)
            rate = ph.rate_at(lt)
            if rate <= 0.0:
                t += 0.05  # idle gap: re-sample the shape 20x/s
                continue
            out.append((t, i))
            if len(out) >= max_requests:
                raise ValueError(
                    f"scenario compiles to more than {max_requests} "
                    "arrivals; lower the rates or durations"
                )
            t += 1.0 / rate
        return out

    def describe(self) -> list[dict]:
        return [
            {
                "name": ph.name,
                "kind": ph.kind,
                "startS": round(self._starts[i], 3),
                "endS": round(self._starts[i] + ph.duration_s, 3),
                "params": {k: v for k, v in ph.params.items() if k != "name"},
            }
            for i, ph in enumerate(self.phases)
        ]


def parse_scenario(spec: str) -> ScenarioProgram:
    """``--scenario`` DSL → program.  Phases are ``;``-separated
    ``kind:key=val,key=val`` chunks; every numeric param is a float,
    ``name=`` labels the phase in the per-segment report."""
    phases = []
    for chunk in spec.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        kind, sep, rest = chunk.partition(":")
        kind = kind.strip()
        params: dict = {}
        name = ""
        if sep:
            for pair in rest.split(","):
                pair = pair.strip()
                if not pair:
                    continue
                k, psep, v = pair.partition("=")
                if not psep:
                    raise ValueError(
                        f"bad scenario token {pair!r} in {chunk!r}"
                    )
                k = k.strip()
                if k == "name":
                    name = v.strip()
                else:
                    params[k] = float(v)
        duration = params.pop("duration", 10.0)
        phases.append(
            Phase(kind=kind, duration_s=duration, params=params, name=name)
        )
    return ScenarioProgram(phases)


def _build_payloads(
    program: ScenarioProgram,
    arrivals: list,
    query: dict,
    samples: Optional[dict],
    seed: int,
    zipf_q: float,
) -> list:
    """Pre-draw every request body so worker interleaving can't change
    the workload (the same contract run_loadtest keeps).  Zipf weights
    are cached per (n, s rounded to 2 decimals) — a drift re-weighs at
    most ~100 times, not once per request."""
    if not samples:
        body = json.dumps(query).encode()
        return [body] * len(arrivals)
    import numpy as np

    rng = np.random.default_rng(seed)
    weight_cache: dict = {}
    out = []
    for i, (t, pidx) in enumerate(arrivals):
        ph = program.phases[pidx]
        lt = t - program._starts[pidx]
        q = dict(query)
        for fname, values in samples.items():
            share = ph.mix_at(lt)
            s = ph.zipf_s_at(lt)
            if share is not None and len(values) >= 2:
                half = len(values) // 2
                pool = values[:half] if rng.random() < share else values[half:]
                v = pool[int(rng.integers(len(pool)))]
            elif s is not None:
                key = (len(values), round(s, 2))
                if key not in weight_cache:
                    weight_cache[key] = zipf_mandelbrot_weights(
                        len(values), key[1], zipf_q
                    )
                v = values[int(rng.choice(len(values), p=weight_cache[key]))]
            else:
                v = values[i % len(values)]
            q[fname] = v
        out.append(json.dumps(q).encode())
    return out


def run_scenario(
    url: str,
    query: dict,
    program: ScenarioProgram,
    samples: Optional[dict] = None,
    concurrency: int = 16,
    timeout: float = 30.0,
    deadline_ms: Optional[float] = None,
    seed: int = 0,
    zipf_q: float = 50.0,
    slo_p99_ms: Optional[float] = None,
) -> dict:
    """Replay a scenario program against a live ``/queries.json``.

    Open-loop: requests fire at their compiled arrival times (a worker
    that falls behind fires immediately — lateness is reported, never
    silently absorbed into the shape).  503s count as ``shed`` and 504s
    as ``deadlineExceeded`` per phase, mirroring run_loadtest; with
    ``slo_p99_ms`` each phase gets a ``sloHeld`` verdict (p99 within
    bound AND zero errors) and the summary ANDs them.
    """
    arrivals = program.arrivals()
    payloads = _build_payloads(
        program, arrivals, query, samples, seed, zipf_q
    )
    parsed = urllib.parse.urlsplit(url)
    host = parsed.hostname
    port = parsed.port or (443 if parsed.scheme == "https" else 80)
    path = (parsed.path.rstrip("/") or "") + "/queries.json"
    conn_cls = (
        http.client.HTTPSConnection
        if parsed.scheme == "https"
        else http.client.HTTPConnection
    )
    headers = {"Content-Type": "application/json"}
    if deadline_ms is not None:
        headers["X-Request-Deadline"] = f"{deadline_ms:g}"

    nphase = len(program.phases)
    lock = threading.Lock()
    counter = {"next": 0}
    lat = [[] for _ in range(nphase)]  # successful latencies (s)
    shed = [0] * nphase
    deadline_x = [0] * nphase
    errors: list[list] = [[] for _ in range(nphase)]
    late = [0.0]  # worst scheduled-vs-actual fire lag
    last_fire = [0.0]  # when the last request actually left, from t0

    def worker(t0: float):
        conn = conn_cls(host, port, timeout=timeout)
        try:
            while True:
                with lock:
                    if counter["next"] >= len(arrivals):
                        return
                    i = counter["next"]
                    counter["next"] += 1
                sched_t, pidx = arrivals[i]
                delay = (t0 + sched_t) - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                else:
                    with lock:
                        late[0] = max(late[0], -delay)
                t1 = time.perf_counter()
                with lock:
                    last_fire[0] = max(last_fire[0], t1 - t0)
                try:
                    conn.request(
                        "POST", path, body=payloads[i], headers=headers
                    )
                    resp = conn.getresponse()
                    resp.read()
                    if resp.status == 503:
                        with lock:
                            shed[pidx] += 1
                        continue
                    if resp.status == 504:
                        with lock:
                            deadline_x[pidx] += 1
                        continue
                    if resp.status >= 400:
                        raise RuntimeError(f"HTTP {resp.status}")
                    dt = time.perf_counter() - t1
                    with lock:
                        lat[pidx].append(dt)
                except Exception as e:
                    with lock:
                        errors[pidx].append(str(e))
                    conn.close()
        finally:
            conn.close()

    t0 = time.perf_counter()
    threads = [
        threading.Thread(target=worker, args=(t0,), name=f"scenario-{w}")
        for w in range(concurrency)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0

    def q(sorted_lats: list, p: float) -> float:
        if not sorted_lats:
            return float("nan")
        i = min(int(p * len(sorted_lats)), len(sorted_lats) - 1)
        return sorted_lats[i] * 1e3

    offered = [0] * nphase
    for _, pidx in arrivals:
        offered[pidx] += 1
    phase_reports = []
    slo_held_all = True
    worst_p99 = 0.0
    for i, desc in enumerate(program.describe()):
        ls = sorted(lat[i])
        p99 = q(ls, 0.99)
        dur = desc["endS"] - desc["startS"]
        rep = {
            **desc,
            "offered": offered[i],
            "ok": len(ls),
            "errors": len(errors[i]),
            "shed": shed[i],
            "deadlineExceeded": deadline_x[i],
            "p50Ms": round(q(ls, 0.50), 3),
            "p99Ms": round(p99, 3),
            "qps": round(len(ls) / dur, 1) if dur > 0 else 0.0,
        }
        if ls:
            worst_p99 = max(worst_p99, p99)
        if slo_p99_ms is not None:
            held = len(errors[i]) == 0 and (
                not ls or p99 <= slo_p99_ms
            )
            rep["sloHeld"] = held
            slo_held_all = slo_held_all and held
        phase_reports.append(rep)
    out = {
        "requests": len(arrivals),
        "concurrency": concurrency,
        "durationS": round(program.duration_s, 3),
        "wallSec": round(wall, 3),
        "worstLagS": round(late[0], 3),
        # the rate the client really issued (the schedule's requests over
        # the time its last one left): a rate it could not reach is the
        # client's limit, never the server's capacity
        "issuedPerSec": round(len(arrivals) / max(last_fire[0], 1e-9), 1),
        "ok": sum(len(l) for l in lat),
        "errors": sum(len(e) for e in errors),
        "shed": sum(shed),
        "deadlineExceeded": sum(deadline_x),
        "worstP99Ms": round(worst_p99, 3),
        "phases": phase_reports,
    }
    if slo_p99_ms is not None:
        out["sloP99Ms"] = slo_p99_ms
        out["sloHeld"] = slo_held_all
    err_samples = [e for es in errors for e in es[:3]]
    if err_samples:
        out["errorSamples"] = err_samples[:5]
    return out
