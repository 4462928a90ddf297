#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``predictionio_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Every phase prints one JSON line; any failed check raises, so the exit
code is not 0 and the last line is never printed.

1. probe   — torch/CUDA versions, the card and its power limit (the
             ``nvidia-smi --query-gpu=name,power.limit`` line is printed as is).
2. build   — ``nvcc`` builds every kernel of the port from ``csrc/``.
3. kernels — the score kernel against its plain PyTorch version on the card
             at the MovieLens-25M serving shape (162,541 users × 59,047 items,
             rank 10, k = 100) at every rung {1, 8, 16, 32, 64} × {f32, bf16,
             int8}, then ragged catalogs, exact ties within and across chunks
             (integer-valued factors: every dot product is exact, so indices
             must be identical), an exclusion mask and k == n_items. Times
             each rung: kernel, plain version, one PyTorch yardstick
             (``torch.topk(U[u] @ V.T)``, timed only) and the bound.
4. serving — an ALSModel of that shape from ``--seed`` is written into the
             port's MEMORY storage as a COMPLETED engine instance, deployed by
             ``QueryServer(RecommendationEngine.apply(), batching=True)`` and
             sent ``N_QUERIES`` or more ``/queries.json`` in bursts that dispatch
             every rung. Every answer is held against the plain
             version; the kernel's launch count over the traffic must equal
             the fast path's dispatches.

Tolerance: values within rtol = atol = 1e-5; indices equal, except where two
reference values lie within that tolerance of each other (summation order
may swap them); exact equality for integer-valued factors. The timings and
the tables are also written to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
N_USERS, N_ITEMS, RANK, K = 162_541, 59_047, 10, 100
RUNGS = (1, 8, 16, 32, 64)
N_QUERIES = 200  # at least this many /queries.json in the serving phase
DTYPES = ("f32", "bf16", "int8")
TOL = 1e-5
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 rate outside the
# tensor cores (the kernel's arithmetic is defined in f32, no TF32)
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, n: int) -> float:
    """Mean milliseconds per call between CUDA events, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def device_us(fn, n: int = 20) -> dict:
    """Device time per call of each CUDA kernel ``fn`` launches (µs), from
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = ev.cuda_time_total
        if t:
            name = ev.key.replace("(anonymous namespace)::", "").replace("void ", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1].strip()
            out[name] = out.get(name, 0.0) + t / n
    return out


def bound(batch, n_pad, rank, k, dtype):
    """Least time for the work: each input byte read once, each output
    written once, and 2·B·n·rank f32 operations."""
    from predictionio_tpu_torch.ops.quantize import FACTOR_BYTES

    e = FACTOR_BYTES[dtype]
    nbytes = n_pad * rank * e + n_pad + batch * (rank * e + 4) + batch * k * 8
    if dtype == "int8":
        nbytes += (n_pad + batch) * 4  # per-row scales
    ops = 2 * batch * n_pad * rank
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


class Inputs:
    """One scored catalog on the card, laid out as the fast path lays it out."""

    def __init__(self, U, V, dtype, device, mask_extra=None):
        import numpy as np
        import torch

        from predictionio_tpu_torch.ops.quantize import factors_to_tensor, quantize_factors
        from predictionio_tpu_torch.ops.score_kernel import pad_block_items

        n = V.shape[0]
        self.n_pad = pad_block_items(n)
        Uq, us = quantize_factors(U, dtype)
        Vq, vs = quantize_factors(V, dtype)
        self.U = factors_to_tensor(Uq, device)
        self.V = factors_to_tensor(np.pad(Vq, ((0, self.n_pad - n), (0, 0))), device)
        self.us = None if us is None else torch.from_numpy(us).to(device)
        self.vs = None
        if vs is not None:
            vs = np.pad(vs, ((0, self.n_pad - n), (0, 0)), constant_values=1.0)
            self.vs = torch.from_numpy(vs).to(device)
        mask = np.arange(self.n_pad) >= n
        if mask_extra is not None:
            mask[: n] |= mask_extra
        self.mask = torch.from_numpy(mask).to(device)

    def kernel(self, u_idx, k):
        from predictionio_tpu_torch.ops.score_kernel import fused_gather_score_topk

        return fused_gather_score_topk(
            self.U, self.V, u_idx, k, self.mask, u_scale=self.us, v_scale=self.vs
        )

    def plain(self, u_idx, k):
        from predictionio_tpu_torch.ops.score_kernel import gather_score_topk_reference

        return gather_score_topk_reference(
            self.U, self.V, u_idx, k, self.mask, u_scale=self.us, v_scale=self.vs
        )


def compare(inp, u_idx, k, tol, what):
    """Kernel vs plain version on the same inputs; returns max |Δvalue|."""
    import torch

    from predictionio_tpu_torch.testing import topk_mismatches

    kv, ki = inp.kernel(u_idx, k)
    rv, ri = inp.plain(u_idx, k)
    torch.cuda.synchronize()
    bad = topk_mismatches(
        kv.cpu().numpy(), ki.cpu().numpy(), rv.cpu().numpy(), ri.cpu().numpy(), tol
    )
    require(not bad, f"{what}: kernel disagrees with plain version: {bad[:3]}")
    return float((kv - rv).abs().max())


def phase_kernels(seed, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    U = rng.standard_normal((N_USERS, RANK)).astype(np.float32)
    V = rng.standard_normal((N_ITEMS, RANK)).astype(np.float32)
    max_err = 0.0
    rows = []
    for dtype in DTYPES:
        inp = Inputs(U, V, dtype, device)
        for b in RUNGS:
            u_idx = torch.from_numpy(rng.integers(0, N_USERS, b).astype(np.int32)).to(device)
            err = compare(inp, u_idx, K, TOL, f"ML-25M {dtype} B={b}")
            max_err = max(max_err, err)
            Uf = inp.U.float() * (inp.us if inp.us is not None else 1.0)
            Vf = inp.V.float()
            ui = u_idx.long()

            def library():
                s = Uf[ui] @ Vf.T
                if inp.vs is not None:
                    s = s * inp.vs.reshape(1, -1)
                return torch.topk(s.masked_fill(inp.mask, -1e30), K)

            bms, by = bound(b, inp.n_pad, RANK, K, dtype)
            rows.append({
                "dtype": dtype, "batch": b, "n_items_pad": inp.n_pad,
                "max_abs_err": err,
                "ms": cuda_ms(lambda: inp.kernel(u_idx, K), 200),
                "plain_ms": cuda_ms(lambda: inp.plain(u_idx, K), 20),
                "library_ms": cuda_ms(library, 100),
                "bound_ms": bms, "bound_by": by,
                "kernel_device_us": device_us(lambda: inp.kernel(u_idx, K)),
            })
            emit({"phase": "kernels", **rows[-1]})
    del inp
    # edge cases, small catalogs
    edges = []
    for n in (1, 7, 37, 513, 1025):
        Us = rng.standard_normal((50, RANK)).astype(np.float32)
        Vs = rng.standard_normal((n, RANK)).astype(np.float32)
        u_idx = torch.arange(8, dtype=torch.int32, device=device)
        for k in sorted({min(5, n), n}):  # k == n_items included
            edges.append((f"ragged n={n} k={k}", Inputs(Us, Vs, "f32", device), u_idx, k, TOL))
    # exact ties: integer-valued factors, cloned rows within a chunk
    # (600 ← 601) and across chunks (10 ← 3 ← 2900), every dtype
    Ui = rng.integers(1, 4, (200, RANK)) * rng.choice([-1, 1], (200, RANK))
    Vi = rng.integers(1, 4, (3000, RANK)) * rng.choice([-1, 1], (3000, RANK))
    Vi[600], Vi[10], Vi[2900] = Vi[601], Vi[3], Vi[3]
    Ui, Vi = Ui.astype(np.float32), Vi.astype(np.float32)
    u64 = torch.arange(64, dtype=torch.int32, device=device)
    for dtype in DTYPES:
        # bf16 holds small integers exactly; int8 rescales rows, so only
        # f32/bf16 keep every dot exact
        tol = 0.0 if dtype != "int8" else TOL
        edges.append((f"ties {dtype}", Inputs(Ui, Vi, dtype, device), u64, K, tol))
    even = np.zeros(3000, bool)
    even[::2] = True
    for dtype in DTYPES:
        edges.append((f"mask-even {dtype}", Inputs(Ui, Vi, dtype, device, even), u64, K, 0.0 if dtype != "int8" else TOL))
    edges.append(("ties k=n_items", Inputs(Ui, Vi, "f32", device), u64[:8], 3000, 0.0))
    for what, inp, u_idx, k, tol in edges:
        err = compare(inp, u_idx, k, tol, what)
        if what.startswith("mask-even"):
            _, ki = inp.kernel(u_idx, k)
            require(bool((ki % 2 == 1).all()), f"{what}: an excluded item won")
        max_err = max(max_err, err)
    emit({"phase": "kernel-edges", "cases": [e[0] for e in edges], "ok": True})
    return U, V, rows, max_err


def publish(storage, engine, model):
    """Write ``model`` as a COMPLETED engine instance with its sealed blob,
    the steps the training workflow takes after training."""
    import datetime as dt

    from predictionio_tpu_torch.core import persistence
    from predictionio_tpu_torch.data.storage.base import EngineInstance, Model

    params = engine.params_from_variant(
        {"algorithms": [{"name": "als", "params": {"rank": RANK}}]}
    )
    algorithms = engine.make_algorithms(params)
    instances = storage.get_meta_data_engine_instances()
    now = dt.datetime.now(tz=dt.timezone.utc)
    inst = EngineInstance(
        id="", status=instances.STATUS_INIT, start_time=now, end_time=now,
        engine_id="default", engine_version="default", engine_variant="default",
        engine_factory="predictionio_tpu_torch.templates.recommendation.RecommendationEngine",
        **params.to_json_strings(),
    )
    iid = instances.insert(inst)
    blob = persistence.serialize_models(
        iid, algorithms, [model], [p for _, p in params.algorithm_params_list]
    )
    storage.get_model_data_models().insert(
        Model(id=iid, models=persistence.seal_model_blob(blob))
    )
    inst.status = instances.STATUS_COMPLETED
    instances.update(inst)
    return iid


def phase_serving(U, V, seed, device):
    import numpy as np
    import torch

    from predictionio_tpu_torch.data.storage import memory
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.models.als import als_model_from_arrays
    from predictionio_tpu_torch.ops import score_kernel
    from predictionio_tpu_torch.testing import topk_mismatches
    from predictionio_tpu_torch.serving.query_server import QueryServer
    from predictionio_tpu_torch.templates.recommendation import RecommendationEngine

    t0 = time.perf_counter()
    model = als_model_from_arrays(
        U, V, (f"u{i}" for i in range(N_USERS)), (f"i{j}" for j in range(N_ITEMS))
    )
    source = "CHIPSMOKE"
    storage = Storage(env={
        f"PIO_STORAGE_SOURCES_{source}_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": source,
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": source,
    })
    engine = RecommendationEngine.apply()
    iid = publish(storage, engine, model)
    qs = QueryServer(
        engine, storage=storage, ctx=DeviceContext.create(device=device),
        batching=True,
    )
    try:
        port = qs.start("127.0.0.1", 0)
        setup_s = time.perf_counter() - t0
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(f"{base}/readyz", timeout=30) as r:
            ready = json.loads(r.read())
        require(ready["status"] == "ready" and ready["fastpathWarm"], f"readyz {ready}")
        require(ready["engineInstanceId"] == iid, "deployed the published instance")

        def post(q):
            req = urllib.request.Request(
                f"{base}/queries.json", data=json.dumps(q).encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=60) as r:
                return q, json.loads(r.read())

        def info():
            with urllib.request.urlopen(f"{base}/", timeout=30) as r:
                return json.loads(r.read())

        rng = np.random.default_rng(seed + 1)
        # the main path's window: counts read just before and just after
        score_kernel.launches.reset()
        answers = []
        batcher = qs._batcher
        t_serve = time.perf_counter()
        # bursts of concurrent requests; each burst queues behind a held
        # batcher so it leaves as full rung-sized batches (a burst of 128
        # as two of 64), then a trickle of single requests
        pattern = (8, 16, 32, 64, 128, 1, 1, 1, 1)
        with ThreadPoolExecutor(max_workers=128) as pool:
            while len(answers) < N_QUERIES:
                for size in pattern:
                    burst = [
                        {"user": f"u{int(rng.integers(N_USERS))}",
                         "num": int(rng.integers(10, K + 1))}
                        for _ in range(size)
                    ]
                    if size == 1:
                        answers.append(post(burst[0]))
                        continue
                    with batcher.held():
                        futs = [pool.submit(post, q) for q in burst]
                        t_hold = time.monotonic() + 20
                        while info()["inflight"] < size and time.monotonic() < t_hold:
                            time.sleep(0.002)
                        time.sleep(0.02)  # the last arrivals reach the queue
                    answers += [f.result() for f in futs]
        serve_s = time.perf_counter() - t_serve
        launches = score_kernel.launches.count
        served = info()
        hits = served["fastpath"][0]["bucket_hits"]
        require(all(hits[str(b)] > 0 for b in RUNGS), f"every rung dispatched: {hits}")
        require(launches == sum(hits.values()), f"launches {launches} vs dispatches {hits}")
        require(len(answers) >= N_QUERIES, f"{len(answers)} answers")
        require(not any("degraded" in a for _, a in answers), "no degraded answer")

        # every answer against the plain version on the card, on the
        # catalog laid out as the fast path lays it out
        plain = Inputs(U, V, "f32", device)
        item_of = model.item_map
        users = np.array([model.user_map[q["user"]] for q, _ in answers], np.int32)
        bad = []
        for s in range(0, len(users), 256):
            u = torch.from_numpy(users[s: s + 256]).to(device)
            rv, ri = (t.cpu().numpy() for t in plain.plain(u, K))
            for j, (q, a) in enumerate(answers[s: s + 256]):
                n = q["num"]
                got_i = np.array([[item_of[x["item"]] for x in a["itemScores"]]])
                got_v = np.array([[x["score"] for x in a["itemScores"]]])
                bad += topk_mismatches(got_v, got_i, rv[j: j + 1, :n], ri[j: j + 1, :n], TOL)
        require(not bad, f"served answers disagree with the plain version: {bad[:3]}")
    finally:
        qs.stop()
        memory.reset_store(source)
    out = {
        "phase": "serving", "queries": len(answers), "setup_s": setup_s,
        # serve_s includes the held bursts' waits: this script's figure, not
        # a latency or throughput measurement
        "serve_s": serve_s, "bucket_hits": hits, "launches": launches,
        "batch_sizes": served["batching"]["batch_sizes"],
    }
    emit(out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from predictionio_tpu_torch.ops import _build, score_kernel

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    emit({"phase": "probe", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "capability": list(cap),
          "count": torch.cuda.device_count(), "nvidia_smi": smi})
    require(cap[0] == 9, f"a Hopper card (capability 9.x), got {cap}")

    t0 = time.perf_counter()
    built = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {n: str(p.relative_to(ROOT)) for n, (p, _, _) in built.items()},
          "ptxas": {n: [ln.strip() for ln in out.splitlines() if "Used" in ln]
                    for n, (_, _, out) in built.items()}})

    U, V, rows, max_err = phase_kernels(args.seed, device)
    serving = phase_serving(U, V, args.seed, device)

    top = next(r for r in rows if r["dtype"] == "f32" and r["batch"] == RUNGS[-1])
    kernels = {"kernels": [{
        "name": "fused_gather_score_topk",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/score_topk.cu",
        "replaces": "predictionio_tpu/ops/score_kernel.py:125",
        "launches": serving["launches"],
        "max_abs_err": max_err,
        "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"], "library_ms": top["library_ms"],
    }]}
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "rows": rows, "serving": serving, **kernels}, f, indent=1)
    require(score_kernel.launches.count > 0, "kernel launched")
    print(smi, flush=True)
    emit(kernels)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
