#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``predictionio_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --ab PARENT_TREE   # only kernels 1, 2, 4, 5, 6: parent vs this tree

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Every phase prints one JSON line; any failed check raises, so the exit
code is not 0 and the last line is never printed.

1. probe   — torch/CUDA versions, the card and its power limit (the
             ``nvidia-smi --query-gpu=name,power.limit`` line is printed as is).
2. build   — ``nvcc`` builds every kernel of the port from ``csrc/``.
3. kernels — the score kernel against its plain PyTorch version on the card
             at the MovieLens-25M serving shape (162,541 users × 59,047 items,
             rank 10, k = 100) at every rung {1, 8, 16, 32, 64} × {f32, bf16,
             int8}, then ragged catalogs, exact ties within and across slices
             (integer-valued factors: every dot product is exact, so indices
             must be identical), an exclusion mask, k == n_items, and what the
             threshold selection could get wrong: scores ascending with the
             item index (every item beats the running threshold), all scores
             equal (the answer is 0..k-1), a mask that leaves 5 items for
             k = 100, B = 13, k = 1 and k = 8192 on 10,000 items. Times each
             rung and the ascending case at B = 64: kernel, device µs and
             launches a call from the trace, plain version, one PyTorch
             yardstick (``torch.topk(U[u] @ V.T)``, timed only) and the bound.
4. train   — the training kernel at full width: 25,000,095 ratings in the
             ML-25M shape drawn from ``--seed`` by ``bench.py``'s recipe
             (Zipf-Mandelbrot ids, users s = 0.7, items s = 1.1, q = 50;
             ratings uniform on [1, 5)), bucketed as ``train_als`` buckets
             them. Every bucket of both sides of the first half-step (users
             against the initial item factors, items against the initial user
             factors), explicit and implicit × {f32, bf16, int8}, is held
             against the plain version, and launched twice at f32 to give the
             same bytes; then edge cases at small shapes: ranks 1, 4, 10, 63
             and 64, widths 1, 31, 33 and 65, rows cut into parts, each with a
             fully masked row. Times each side, and each bucket at f32 (the
             widest and the narrowest at bf16 and int8): kernel ms and device
             µs, live slots a second, share of the bound, the plain version,
             ``torch.bmm`` of the gathered bucket as yardstick; and one full
             iteration. Then the main path:
             ``train_als`` at that shape, rank 10, 20 iterations, explicit,
             f32, with the kernel launched exactly buckets × iterations times
             and a training RMSE below the first iteration's. Then a small
             draw trained on the card and on the CPU from the same initial
             factors (see ``phase_small_parity`` for what is held to what),
             and ``run_train(RecommendationEngine.apply(), …)`` from
             rate/buy events in MEMORY storage to a COMPLETED instance.
4a. gather-kernel — kernel 3 as ported one to one (the gather the segment
             solver called per chunk before the segment kernel took its
             place; no path calls it now) against its plain
             version on the card, bit for bit: the first chunk (65,536
             ratings) of each side's stream of the same ML-25M draw against
             the item factors (59,047 × 10) and the user factors (162,541 ×
             10), × {f32, bf16, int8}; then n ∈ {1, 7, 513, 65,539} × ranks
             {1, 4, 10, 64, 65, 128, 256} × dtypes with indices at 0, at
             n_opp − 1 and beyond both ends (clamped), and n = 0 (no launch).
             Times each side and dtype: kernel ms and device µs, the plain
             version, one PyTorch yardstick (``V.index_select(0, idx)``; for
             int8 the two-call ``index_select(...).float() * scale.
             index_select(...)``, timed only, with its device µs) and the
             bound (the call's distinct rows counted on the host).
4b. segment-kernel — the segment solver's normal-equation kernel (kernel
             3 redesigned: one launch a half-step over the stream sorted by
             entity) on the card against its plain version on the CPU (the
             chunk loop over the stream in its own order), A, b and cnt bit
             for bit, and a second launch byte for byte: a 1,000,000-rating
             draw (20,000 users × 5,000 items, 16 chunks, the hot items a
             block each) at rank 10 × {f32, bf16, int8} × explicit/implicit,
             both sides; ranks 1 and 65 on 20,000 ratings in chunks of 4,096
             with every entity of 64 slots or more on a block, f32 and int8;
             then the ML-25M draw, f32 explicit, both sides. Times each side
             at the ML-25M shape: the layout's build on the card, the kernel,
             the plain version on the card and the bound.
4c. train-segment — the segment solver's main path at full width:
             ``train_als(ALSConfig(solver="segment", rank=10, iterations=20))``
             on the same draw and seed, so from the dense run's initial
             factors. The segment kernel launches exactly 2 × 20 times, the
             gather kernel and the training kernel not at all; the factors
             are finite, the RMSE is below the first iteration's and within
             1e-3 relative of the dense model's. Reports the layouts' build
             seconds, the prediction gap to the dense model on 10,000 sampled
             pairs (and the share beyond the JAX package's dense-vs-segment
             tolerance, rtol 5e-2, atol 5e-3), seconds per iteration, ratings ·
             iterations/s, device time by kernel and by op over 3 iterations,
             the idle share and the peak memory.
4d. segment-parity — the small draw trained with the segment solver on
             the card and on the CPU from one init by ``phase_small_parity``'s
             rule; then f32 trained twice on the card from one seed, and the
             two runs must be bit-identical.
4e. train-workflow (segment) — the same events through ``run_train`` with
             ``PIO_ALS_SOLVER=segment`` set for the call: COMPLETED, the
             segment kernel launched 2 × 5 times and the gather kernel not at
             all, the stored model's solver "segment"; deployed by
             ``QueryServer(RecommendationEngine.apply(), batching=True)``, 20
             ``/queries.json`` each held against the plain version.
5. serving — the full-width trained model is written into the port's MEMORY
             storage as a COMPLETED engine instance, deployed by
             ``QueryServer(RecommendationEngine.apply(), batching=True)`` and
             sent ``N_QUERIES`` or more ``/queries.json`` in bursts that dispatch
             every rung. Every answer is held against the plain
             version; the kernel's launch count over the traffic must equal
             the fast path's dispatches.
6. sasrec-kernel — the flash-attention kernel against its plain version
             (and the plain version in float64, to show which side owns the
             gap) at (B·H, T_q, T_kv, h) = the SASRec serving shape (1, 256,
             256, 50), the template's batchSize at that width (128, 256, 256,
             50), (16, 512, 512, 16), (8, 1024, 1024, 64), (4, 2048, 2048,
             128) and two T_q != T_kv shapes, causal and not, with
             ``torch.backends.cuda.matmul.allow_tf32 = False``; every case
             launched twice must give the same bytes. Then the split plan at
             the serving shape (one launch of at least 64 blocks of at most
             64 keys). Times the first two, causal: kernel, device µs, host µs
             a launch, plain version, bound (3xTF32 and, as before, f32) and
             ``F.scaled_dot_product_attention(..., is_causal=True)`` (timed only).
7. sasrec-serving — a SASRec at the width of Kang & McAuley's MovieLens-1M
             setting (d = 50, 2 blocks, 1 head, 3,416 items; maxLen 256, the
             shortest length the JAX package sends to its flash kernel), params
             drawn from ``--seed``, published as a COMPLETED instance, with
             view histories of 1 to 419 events for the queried users (padding
             and truncation), one user whose items are all outside the catalog
             and one with no events. ``QueryServer(SequentialRecommendation
             Engine.apply())`` answers every user per query (``batching=False``,
             one client) and in held bursts of 8 (``batching=True``). Every
             answer is held against the port's forward with the plain attention
             on the card, and the flash kernel must launch 2 (layers) × the
             queries whose history holds a catalog item.
8. sasrec-bwd-kernel — the two flash-attention backward kernels (dq; dk and
             dv) against the plain backward (and the plain backward in float64,
             each gradient's gap to it printed beside the plain version's)
             at every sasrec-kernel shape, causal and not, TF32 off, each
             launched twice for the same bytes; then the
             ring's composition with a global lse (block pairs of 128, each fed
             the whole forward's o and lse, summing to the whole backward).
             Times each kernel at the training shape (128, 256, 256, 50) and at
             (8, 1024, 1024, 64), causal: kernel, device µs, dq's grid, the plain
             backward, the SDPA backward (timed only, its backend named) and the
             bounds (3xTF32 and, as before, f32).
9. sasrec-train — the training main path at the paper's ML-1M width: 6,040
             users × 3,416 items, 1,000,209 view events drawn from ``--seed``
             (every user at least 20, items Zipf-Mandelbrot s = 1.1, q = 50,
             times increasing along each history); ``train_sasrec`` on the card,
             d 50, 2 blocks, 1 head, maxLen 256, batch 128, lr 1e-3, 100 steps.
             Each flash kernel (forward, dq, dk/dv) launches 2 × 100 times, the
             params are finite and the last 10 steps' mean loss is below the
             first 10's. Then seconds per step, sequences/s, tokens/s and the
             device time by kernel over 3 steps with the idle share.
10. sasrec-train-parity — a small draw (64 users, 400 items, maxLen 256,
             batch 32) trained 5 steps on the card (kernels) and on the CPU
             (dense attention, autograd) from one start, dense and with 4
             experts: every step's loss free-running, and step by step (the
             CPU starting each step from the card's params and Adam moments
             and taking the card's ReLU branches, a float64 copy as arbiter)
             the gradients, the moments and the updated params.
11. sasrec-train-workflow — view events of 300 users in MEMORY storage →
             ``run_train(SequentialRecommendationEngine.apply(), …)`` on the card
             (maxLen 256) → COMPLETED → ``QueryServer`` answers 20 queries, each
             held against the plain forward.

12. quickstart-cli — the reference quickstart through the port's own CLI
             (``python -m predictionio_tpu_torch.tools.cli``) on the
             zero-config sqlite store of a fresh ``PIO_FS_BASEDIR``: ``status``,
             ``app new QuickstartML``, ``accesskey new QuickstartML rate``; a
             random 100,000 of the ML-1M draw of phase 9 (1,000,209 events,
             6,040 users × 3,416 items; cut to ML-100K's scale because the full
             draw's load and reads took most of the run, printed as step ``cut``)
             as rate events (1-5 stars) with 1 in 20 a buy, bulk-loaded by
             ``SqliteLEvents.insert_batch`` (the role of ``pio import``), timed;
             ``eventserver --stats`` as a subprocess taking 2,000 more events in
             40 batches of 50 and 100 alone, refusing a batch of 51 (400) and a
             buy under the rate-only key (403), a filtered reversed GET, GET and
             DELETE by id, ``/stats.json`` counting all of it, ``POST /stop``;
             ``template get``, ``build`` and ``train --device cuda`` in this
             process (kernel 2 launches buckets × 20 times; wall time and its
             sqlite read), the factors bit-equal to ``train_als`` on what that
             read returned; ``train`` again under ``PIO_ALS_SOLVER=segment`` (segment
             kernel 2 × 20, gather and kernel 2 none); ``deploy --batching
             --device cuda`` as a subprocess (deploy-to-ready time), 1,000 single
             ``/queries.json`` (HTTP latency p50 and p99) and concurrent bursts of
             8 and 64 requests (the batcher forms what it can of them over HTTP:
             the rungs that ran are printed), every answer held against
             ``torch.topk(U[u] @ V.T)`` on the CPU on the factors of the
             instance's sealed blob; kernel 1's launches are the difference of the
             server's ``scoreKernelLaunches`` from readiness to the end and must
             equal its fast path's dispatches; ``undeploy`` (exit 0, port freed). Then
             ``app new QuickstartSeq``, phase 11's 300 users' view events through
             the event server, ``template get sequentialrecommendation``,
             ``train`` (maxLen 256, 30 steps: kernels 4, 5, 6 launch 2 × 30
             times each), ``deploy`` and 20 queries read live from sqlite, each
             held against the plain forward on the history.
13. serving-ops — the deployed ALS server as operators run it: the
             full-width model of phase 4 published into the sqlite store of
             a fresh ``PIO_FS_BASEDIR``, ``eventserver --stats`` and ``deploy
             --batching --feedback`` against it (subprocesses; feedback
             posts a ``predict`` event per answer), and ``pio loadtest`` with
             this process as the client: closed loops of 2,000 requests, Zipf
             over all 162,541 users, at concurrency 1, 16 and 64; open loops
             ``steady:rate=R,duration=6`` at 200, 800 and 3,200 req/s over
             64 connections (the rate the client really issued printed beside
             each). Each load prints client p50/p99 and QPS, the batches by
             size and rung, the fast path's dispatches, the card's busy share
             and utilization against the card's row of the peak table (from
             the server's accountant, the CUDA events around each launch, and
             from the rungs dispatched times phase 3's device µs a rung), and
             at concurrency 1 the median of each trace stage. Held: 300
             sampled answers against the plain version; 0 degraded answers
             and 0 query errors; kernel 1's launches equal to the fast path's
             dispatches; every answer's feedback event in sqlite, less the
             ones the bounded queue dropped (counted); ``PIO_RESULT_CACHE=1
             PIO_COALESCE=1`` in this process: answers equal to the cache-off
             server's, launches fewer by the hits, a held burst of 8 × 8
             identical queries scored as 8 rows; a corrupt newer instance:
             ``POST /reload`` keeps the live one (``reload_failed`` 1), a new
             ``deploy`` cold-starts on the last-known-good one (and serves a
             closed loop at 64 without feedback); SIGTERM to that deploy under
             load and ``loadtest --kill-after`` (POST /stop) to the first: each
             drains, exits 0 and answers no 5xx beyond 503 sheds.

Tolerances. Gather kernel and segment kernel: bit for bit. Score kernel: values within rtol =
atol = 1e-5; indices equal, except where two reference values lie within
that tolerance of each other
(summation order may swap them); exact equality for integer-valued
factors. Training kernel: each entry of A and b within 3e-4 (against the
plain version) and within 1e-5 (against the same operands summed in
float64) of the sum of the absolute products behind it, plus 1e-6 (the
reach of a change of summation order, over up to 96,168 slots;
``predictionio_tpu_torch/testing.py`` says how the two were set), cnt
equal; the largest gap of each is reported. Card-trained factors
against CPU-trained ones: rtol = atol = 1e-4 (f32, five iterations), 1e-3
(bf16, int8: every half-step of five iterations, the CPU fed the card's
previous factors; ``phase_small_parity`` says why). Flash kernel: o within
rtol = atol = 2e-5 (the JAX package's own flash test), lse within rtol =
atol = 1e-5. Backward kernels: dq, dk, dv within rtol 2e-4, atol 2e-5 (the
JAX package's own gradient test). Served SASRec answers: scores within
rtol = atol = 1e-4 of the plain forward's logits, items by
``topk_mismatches`` at that tolerance. SASRec trained on the card against
the CPU: each step's loss within rtol 1e-5 free-running; step by step,
gradients and Adam moments entry by entry within rtol 1e-4 plus 1e-6 of the
leaf's largest value, and params within rtol = atol = 1e-4 except entries
whose √v̂ is below 1e-6, which are listed and held within lr
(``phase_sasrec_train_parity`` says why). The timings and the tables are
also written to ``chiprun_out/chip_smoke.json``.

``--ab PARENT_TREE`` runs nothing of the above: it times kernels 1 and 2
(every rung × dtype of the serving shape; each side's buckets of the first
half-step, f32) and the flash kernels (4 at (1, 256, 256, 50) and (128,
256, 256, 50), 5 and 6 at (128, 256, 256, 50) and (8, 1024, 1024, 64),
causal; ms and device µs) of the tree unpacked at PARENT_TREE (``git archive`` of the
parent commit, under a directory ``.gitignore`` lists) and of this tree, in
turns on one card (parent, change, change, parent), each in a process of its
own, and writes ``chiprun_out/ab.json``.
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
N_RATINGS = 25_000_095  # MovieLens-25M's rating count
TRAIN_ITERS = 20  # the recommendation template's numIterations default
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 rate outside the
# tensor cores (the kernel's arithmetic is defined in f32, no TF32)
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# TF32 on the tensor cores (dense); a 3xTF32 product makes three of them
PEAK_TF32_OPS_S = 495e12


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


def host_us(fn, n: int) -> float:
    """Host microseconds a call of ``fn``, which only enqueues work: the
    queue is drained before and after, not between calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def device_us(fn, n: int = 20, tries: int = 2) -> dict:
    """Device time per call of each CUDA kernel ``fn`` launches (µs)."""
    return op_device_us(fn, n, tries)["kernels"]


def op_device_us(fn, n: int = 3, tries: int = 2) -> dict:
    """Device time per call, from ``torch.profiler``: by CUDA kernel and by
    the PyTorch op that launched it (``self_device_time_total``); a trace
    that comes back without device events is taken once more."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels, ops, launches = {}, {}, {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CPU"):
            t = getattr(ev, "self_device_time_total", 0) or 0
            if t and ev.key.startswith("aten::"):
                ops[ev.key] = ops.get(ev.key, 0.0) + t / n
            continue
        t = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if t:
            name = ev.key.replace("(anonymous namespace)::", "").replace("void ", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1].strip()
            kernels[name] = kernels.get(name, 0.0) + t / n
            # launches a call the trace saw: a fraction means it lost events
            launches[name] = launches.get(name, 0.0) + ev.count / n
    if not kernels and tries > 1:
        return op_device_us(fn, n, tries - 1)
    return {"kernels": kernels, "ops": ops, "launches": launches}


def ptxas_usage(log: str) -> dict:
    """``nvcc -Xptxas -v`` output → {"kernel<first template argument>":
    "registers; stack and spills"}, one entry per compiled kernel."""
    import re

    out, name, spill = {}, None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:  # an Itanium-mangled name, maybe in an anonymous namespace
            body, ident = re.sub(r"^_ZN?", "", m.group(1)), "_GLOBAL__N"
            while ident.startswith("_GLOBAL__N"):
                n = re.match(r"\d+", body)
                ident, body = body[n.end(): n.end() + int(n.group())], body[n.end() + int(n.group()):]
            arg = re.match(r"IL[a-z](\d+)E", body)
            name = ident + (f"<{arg.group(1)}>" if arg else "")
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out[name] = f"{regs} registers; {spill}"
            name = None
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
            trace = op_device_us(lambda: inp.kernel(u_idx, K), 20)
            rows.append({
                "dtype": dtype, "batch": b, "n_items_pad": inp.n_pad,
                "max_abs_err": err,
                "ms": cuda_ms(lambda: inp.kernel(u_idx, K), 200),
                "plain_ms": cuda_ms(lambda: inp.plain(u_idx, K), 20),
                "library_ms": cuda_ms(library, 100),
                "bound_ms": bms, "bound_by": by,
                # device µs a call by CUDA kernel, and the launches a call of each
                "kernel_device_us": trace["kernels"], "kernel_launches": trace["launches"],
            })
            emit({"phase": "kernels", **rows[-1]})
    del inp
    # scores ascending with the item index (U = e_0, V[i] = i·e_0: exact), so
    # every item beats each row's running threshold; B = 64, f32, timed
    Ua = np.zeros((N_USERS, RANK), np.float32)
    Ua[:, 0] = 1.0
    Va = np.zeros((N_ITEMS, RANK), np.float32)
    Va[:, 0] = np.arange(N_ITEMS)
    inp = Inputs(Ua, Va, "f32", device)
    u_idx = torch.from_numpy(rng.integers(0, N_USERS, RUNGS[-1]).astype(np.int32)).to(device)
    err = compare(inp, u_idx, K, 0.0, "ascending B=64")
    _, ki = inp.kernel(u_idx, K)
    require(bool((ki.cpu() == torch.arange(N_ITEMS - 1, N_ITEMS - 1 - K, -1)).all()),
            "ascending: the last k items, best first")
    bms, by = bound(RUNGS[-1], inp.n_pad, RANK, K, "f32")
    trace = op_device_us(lambda: inp.kernel(u_idx, K), 20)
    rows.append({"case": "ascending", "dtype": "f32", "batch": RUNGS[-1],
                 "n_items_pad": inp.n_pad, "max_abs_err": err,
                 "ms": cuda_ms(lambda: inp.kernel(u_idx, K), 200),
                 "plain_ms": cuda_ms(lambda: inp.plain(u_idx, K), 20),
                 "bound_ms": bms, "bound_by": by,
                 "kernel_device_us": trace["kernels"], "kernel_launches": trace["launches"]})
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
    # what the threshold selection could get wrong: all scores equal (the
    # answer is 0..k-1), a mask that leaves 5 items for k = 100, a batch that
    # is no multiple of the 8-row group, k = 1, and k = 8192 (a block's buffer)
    Ut = rng.integers(-3, 4, (200, RANK)).astype(np.float32)
    Vt = np.tile(rng.integers(1, 4, (1, RANK)), (N_ITEMS, 1)).astype(np.float32)
    for dtype in ("f32", "bf16"):
        edges.append((f"all-equal {dtype}", Inputs(Ut, Vt, dtype, device), u64, K, 0.0))
    five = np.ones(3000, bool)
    five[[7, 600, 1500, 2222, 2999]] = False
    edges.append(("mask-leaves-5 k=100", Inputs(Ui, Vi, "f32", device, five), u64, K, 0.0))
    Ur = rng.standard_normal((N_USERS, RANK)).astype(np.float32)
    Vr = rng.standard_normal((N_ITEMS, RANK)).astype(np.float32)
    full = Inputs(Ur, Vr, "f32", device)
    u13 = torch.from_numpy(rng.integers(0, N_USERS, 13).astype(np.int32)).to(device)
    edges.append(("B=13", full, u13, K, TOL))
    edges.append(("k=1", full, u64, 1, TOL))
    wide = Inputs(Ur[:300], Vr[:10_000], "f32", device)
    edges.append(("k=8192 n_items=10000", wide, u64[:13], 8192, TOL))
    for what, inp, u_idx, k, tol in edges:
        err = compare(inp, u_idx, k, tol, what)
        if what.startswith("mask-even"):
            _, ki = inp.kernel(u_idx, k)
            require(bool((ki % 2 == 1).all()), f"{what}: an excluded item won")
        if what.startswith("all-equal"):
            _, ki = inp.kernel(u_idx, k)
            require(bool((ki.cpu() == torch.arange(k)).all()), f"{what}: indices 0..k-1")
        max_err = max(max_err, err)
    emit({"phase": "kernel-edges", "cases": [e[0] for e in edges], "ok": True})
    return U, V, rows, max_err


# -- training ---------------------------------------------------------------


def zipf_mandelbrot_weights(n: int, s: float, q: float = 50.0):
    """Zipf-Mandelbrot pmf ``P(k) ∝ (k+q)^-s`` over ranks ``[0, n)`` (the
    JAX package's ``tools/loadtest.py`` recipe, copied)."""
    import numpy as np

    p = (np.arange(1, n + 1, dtype=np.float64) + q) ** -s
    return p / p.sum()


def zipf_interactions(seed, n_users, n_items, n_ratings):
    """``bench.py``'s synthetic ML-25M recipe at the given size."""
    import numpy as np

    from predictionio_tpu_torch.data.batch import interactions_from_arrays

    rng = np.random.default_rng(seed)
    user = rng.choice(n_users, size=n_ratings, p=zipf_mandelbrot_weights(n_users, 0.7))
    item = rng.choice(n_items, size=n_ratings, p=zipf_mandelbrot_weights(n_items, 1.1))
    rating = rng.uniform(1.0, 5.0, n_ratings).astype(np.float32)
    return interactions_from_arrays(
        user, item, rating, np.zeros(n_ratings),
        (f"u{i}" for i in range(n_users)), (f"i{j}" for j in range(n_items)),
    )


def train_bound(buckets, n_opp, rank, dtype):
    """Least time for one half-step's normal equations over ``buckets``
    ((n_b, D, live slots) each): idx, rat and msk read once (12 B a slot),
    the opposite factors once, A, b and cnt written once; 2k² + 2k f32
    operations per live (unmasked) slot."""
    from predictionio_tpu_torch.ops.quantize import FACTOR_BYTES

    nbytes = n_opp * rank * FACTOR_BYTES[dtype] + (4 * n_opp if dtype == "int8" else 0)
    ops = 0
    for n_b, D, live in buckets:
        nbytes += n_b * D * 12 + n_b * (rank * rank + rank + 1) * 4
        ops += live * (2 * rank * rank + 2 * rank)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_normal_eq(idx, rat, msk, V, dtype, implicit, what, alpha=1.0):
    """Training kernel vs plain version on one bucket. Returns the largest
    |Δ| of A and b, and the largest |Δ| over the summed absolute products
    behind its entry, of the kernel against the plain version and of each
    against the same operands summed in float64."""
    import torch

    from predictionio_tpu_torch.ops.quantize import quantize_factors_torch
    from predictionio_tpu_torch.ops.train_kernel import (
        fused_train_normal_eq,
        train_normal_eq_reference,
    )
    from predictionio_tpu_torch import testing

    q, s = quantize_factors_torch(V, dtype)
    kw = dict(implicit=implicit, alpha=alpha)
    got = fused_train_normal_eq(idx, rat, msk, q, s, **kw)
    ref = train_normal_eq_reference(idx, rat, msk, q, s, **kw)
    exact = train_normal_eq_reference(idx, rat, msk, q, s, accumulate=torch.float64, **kw)
    mag = testing.normal_eq_magnitudes(idx, rat, msk, q, s, **kw)
    torch.cuda.synchronize()
    bad = testing.normal_eq_mismatches(got, ref, mag, rtol=testing.KERNEL_VS_PLAIN_RTOL)
    require(not bad, f"{what}: training kernel disagrees with plain version: {bad[:3]}")
    bad = testing.normal_eq_mismatches(got, exact, mag, rtol=testing.KERNEL_VS_FLOAT64_RTOL)
    require(not bad, f"{what}: training kernel disagrees with float64 sums: {bad[:3]}")

    def rel(x, y):
        return max(float(((a.double() - b.double()).abs() / (m.double() + 1e-6)).max())
                   for a, b, m in zip(x[:2], y[:2], mag))

    return {"abs": max(float((g - r).abs().max()) for g, r in zip(got[:2], ref[:2])),
            "rel": rel(got, ref), "kernel_f64": rel(got, exact), "plain_f64": rel(ref, exact)}


def rmse(inter, U, V, device):
    """Training RMSE of factors (original order) over every rating."""
    import torch

    Ut, Vt = torch.from_numpy(U).to(device), torch.from_numpy(V).to(device)
    se, n = 0.0, len(inter)
    for s in range(0, n, 5_000_000):
        u = torch.from_numpy(inter.user[s: s + 5_000_000]).to(device).long()
        i = torch.from_numpy(inter.item[s: s + 5_000_000]).to(device).long()
        r = torch.from_numpy(inter.rating[s: s + 5_000_000]).to(device)
        se += float(((Ut[u] * Vt[i]).sum(1) - r).double().pow(2).sum())
    return (se / n) ** 0.5


def phase_train_kernels(seed, device):
    """The training kernel at full width and at the edges; the first
    iteration's RMSE and this card's time per iteration."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.ops import train_kernel
    from predictionio_tpu_torch.ops.quantize import quantize_factors_torch

    t0 = time.perf_counter()
    inter = zipf_interactions(seed, N_USERS, N_ITEMS, N_RATINGS)
    cfg = als.ALSConfig(rank=RANK, iterations=TRAIN_ITERS, seed=seed)
    ub, ib, u_perm, i_perm = als._dense_blocks_for(inter, cfg)
    gen = torch.Generator(device="cpu").manual_seed(cfg.seed)
    U0 = als._initial_factors(cfg, N_USERS, gen)  # the draw train_als makes
    V0 = als._initial_factors(cfg, N_ITEMS, gen)
    U0b = torch.from_numpy(U0[np.argsort(u_perm)]).to(device)
    V0b = torch.from_numpy(V0[np.argsort(i_perm)]).to(device)
    sides = {}
    for name, blocks, opp in (("user", ub, V0b), ("item", ib, U0b)):
        dev_blocks = [
            tuple(torch.from_numpy(a).to(device) for a in t)
            for t in zip(blocks.idx, blocks.rat, blocks.msk)
        ]
        sides[name] = (blocks, dev_blocks, opp)
    emit({"phase": "train-data", "seconds": time.perf_counter() - t0,
          "ratings": len(inter),
          "buckets": {n: len(b.widths) for n, (b, _, _) in sides.items()},
          "widths": {n: b.widths for n, (b, _, _) in sides.items()},
          "padded_slots": {n: b.padded_ratings for n, (b, _, _) in sides.items()}})

    # every bucket of both sides, explicit and implicit × every dtype
    errs = []
    for name, (blocks, dev_blocks, opp) in sides.items():
        for dtype in DTYPES:
            for implicit in (False, True):
                for j, (idx, rat, msk) in enumerate(dev_blocks):
                    what = f"{name} bucket {j} (width {blocks.widths[j]}) {dtype} implicit={implicit}"
                    errs.append(check_normal_eq(idx, rat, msk, opp, dtype, implicit, what))
    def gaps(rs):
        return {"max_abs_err": max(r["abs"] for r in rs), "max_rel_err": max(r["rel"] for r in rs),
                # which side of the comparison owns the gap
                "kernel_vs_f64_rel": max(r["kernel_f64"] for r in rs),
                "plain_vs_f64_rel": max(r["plain_f64"] for r in rs)}

    full = gaps(errs)
    emit({"phase": "train-kernel-full", "checked": len(errs), **full, "ok": True})

    # two launches on the same inputs give the same bytes, every bucket of
    # both sides at full width (f32, explicit and implicit)
    for name, (blocks, dev_blocks, opp) in sides.items():
        for implicit in (False, True):
            for j, (idx, rat, msk) in enumerate(dev_blocks):
                a = train_kernel.fused_train_normal_eq(idx, rat, msk, opp, implicit=implicit)
                b = train_kernel.fused_train_normal_eq(idx, rat, msk, opp, implicit=implicit)
                require(all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b)),
                        f"{name} bucket {j} implicit={implicit}: two launches differ")
    emit({"phase": "train-kernel-deterministic", "buckets": sum(len(d) for _, d, _ in sides.values()),
          "ok": True})

    # edge cases at small shapes: ragged, wide (split), ranks 1, 4, 10, 63, 64,
    # widths 1, 31, 33 and 65 (a warp a row), each with one fully masked row
    rng = np.random.default_rng(seed + 2)
    cases, edge_errs = [], []
    for n_b, D, n_opp, k in ((1, 4, 7, 4), (32, 7, 29, 10), (17, 33, 50, 64),
                             (3, 20_000, 1000, 10), (5, 300, 50, 64), (2, 96_168, 500, 4),
                             (40, 1, 9, 10), (17, 31, 30, 1), (17, 33, 30, 63), (9, 65, 40, 10),
                             (6, 700, 80, 63), (4, 5000, 300, 1)):
        idx = torch.from_numpy(rng.integers(0, n_opp, (n_b, D)).astype(np.int32)).to(device)
        rat = torch.from_numpy(rng.uniform(1, 5, (n_b, D)).astype(np.float32)).to(device)
        m = (rng.uniform(size=(n_b, D)) < 0.7).astype(np.float32)
        if n_b > 1:
            m[n_b // 2] = 0.0  # a fully masked row
        msk = torch.from_numpy(m).to(device)
        V = torch.from_numpy(rng.normal(size=(n_opp, k)).astype(np.float32)).to(device)
        for dtype in DTYPES:
            for implicit in (False, True):
                what = f"edge ({n_b}, {D}) n_opp={n_opp} rank {k} {dtype} implicit={implicit}"
                edge_errs.append(check_normal_eq(idx, rat, msk, V, dtype, implicit, what, 2.0))
                cases.append(what)
        if n_b > 1:
            q, s = quantize_factors_torch(V, "bf16")
            got = train_kernel.fused_train_normal_eq(idx, rat, msk, q, s, implicit=False)
            require(not any(bool(t[n_b // 2].any()) for t in got), f"masked row ({n_b}, {D}) rank {k}")
            cases.append(f"masked-row ({n_b}, {D}) rank {k}")
        # masked slots pointing anywhere, in range or not, change no bit
        q, s = quantize_factors_torch(V, "int8")
        moved = torch.where(msk > 0, idx, (idx * 7 + 3) % (3 * n_opp) - n_opp)
        a = train_kernel.fused_train_normal_eq(idx, rat, msk, q, s)
        b = train_kernel.fused_train_normal_eq(moved, rat, msk, q, s)
        require(all(torch.equal(x, y) for x, y in zip(a, b)), f"masked slots moved ({n_b}, {D})")
        zero = train_kernel.fused_train_normal_eq(idx, rat, torch.zeros_like(msk), V, implicit=True)
        require(not any(bool(t.any()) for t in zero), f"fully masked bucket ({n_b}, {D})")
        cases += [f"masked-moved ({n_b}, {D})", f"fully-masked ({n_b}, {D})"]
    try:
        train_kernel.fused_train_normal_eq(idx, rat, msk, torch.zeros((n_opp, 65), device=device))
        require(False, "rank 65 raises")
    except ValueError:
        cases.append("rank 65 raises ValueError")
    emit({"phase": "train-kernel-edges", "cases": len(cases), **gaps(edge_errs), "ok": True})

    # timings: each side's half-step (all its buckets), and each bucket
    def yardstick(bucket, opp):
        idx, _, msk = bucket
        return (opp[idx.long()] * msk[:, :, None]).contiguous()

    torch.backends.cuda.matmul.allow_tf32 = False
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    side_rows, bucket_rows = {}, []
    for name, (blocks, dev_blocks, opp) in sides.items():
        n_opp = opp.shape[0]
        live = [int(m.sum()) for m in blocks.msk]
        for dtype in DTYPES:
            q, s = quantize_factors_torch(opp, dtype)

            def kern(bs=dev_blocks, q=q, s=s):
                return [train_kernel.fused_train_normal_eq(i, r, m, q, s) for i, r, m in bs]

            def plain(bs=dev_blocks, q=q, s=s):
                return [train_kernel.train_normal_eq_reference(i, r, m, q, s) for i, r, m in bs]

            geo = [(m.shape[0], m.shape[1], lv) for m, lv in zip(blocks.msk, live)]
            bms, by = train_bound(geo, n_opp, RANK, dtype)
            row = {"side": name, "dtype": dtype, "buckets": len(geo),
                   "ms": cuda_ms(kern, 10), "plain_ms": cuda_ms(plain, 3),
                   "bound_ms": bms, "bound_by": by,
                   "kernel_device_us": device_us(kern, 5)}
            if dtype == "f32":
                Ws = [yardstick(b, opp) for b in dev_blocks]
                row["library_ms"] = cuda_ms(
                    lambda: [torch.bmm(W.transpose(1, 2), W) for W in Ws], 10
                )
                del Ws
            side_rows[(name, dtype)] = row
            emit({"phase": "train-kernel-time", **row})
            # every bucket at f32; the widest and the narrowest at bf16 and int8
            for j in range(len(geo)) if dtype == "f32" else (0, len(geo) - 1):
                bk = dev_blocks[j]
                bms, by = train_bound([geo[j]], n_opp, RANK, dtype)
                W = yardstick(bk, q.float() * (s if s is not None else 1.0))
                narrow, splits, _ = train_kernel.dense_plan(geo[j][0], geo[j][1], n_sm)

                def one(bk=bk, q=q, s=s):
                    return train_kernel.fused_train_normal_eq(*bk, q, s)

                ms = cuda_ms(one, 20)
                dev = sum(device_us(one, 10).values())
                brow = {"side": name, "dtype": dtype, "bucket": j, "n_b": geo[j][0],
                        "width": geo[j][1], "live_slots": geo[j][2],
                        "route": "warp a row" if narrow else "block a row", "splits": splits,
                        "ms": ms, "device_us": dev,
                        "live_slots_per_s": geo[j][2] / (dev * 1e-6) if dev else None,
                        "share_of_bound": bms / ms,
                        "plain_ms": cuda_ms(lambda: train_kernel.train_normal_eq_reference(*bk, q, s), 5),
                        "library_ms": cuda_ms(lambda: torch.bmm(W.transpose(1, 2), W), 20),
                        "bound_ms": bms, "bound_by": by}
                del W
                bucket_rows.append(brow)
                emit({"phase": "train-kernel-bucket", **brow})
            if dtype == "f32":
                # live-slot rates from the trace: buckets of width <= 64 against
                # those a block a row takes
                mine = [r for r in bucket_rows if r["side"] == name and r["dtype"] == "f32"]
                rate = {grp: sum(r["live_slots"] for r in rs) / (sum(r["device_us"] for r in rs) * 1e-6)
                        for grp, rs in (("narrow_w_le_64", [r for r in mine if r["width"] <= 64]),
                                        ("wide", [r for r in mine if r["route"] == "block a row"]))
                        if rs and all(r["device_us"] for r in rs)}
                row["live_slots_per_s"] = rate
                emit({"phase": "train-kernel-rates", "side": name, **rate})

    # one full iteration (both half-steps: quantize, kernels, solve) from the
    # initial factors: the first iteration train_als runs, and its time
    u_blk, i_blk = sides["user"][1], sides["item"][1]

    def iteration():
        U1 = als._dense_half_step(u_blk, V0b, None, cfg)
        return U1, als._dense_half_step(i_blk, U1, None, cfg)

    iter_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        U1, V1 = iteration()
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t)
    # device time of one iteration by kernel name, largest first
    per_kernel = device_us(iteration, 3)
    iter_device_us = dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12])
    rmse1 = rmse(inter, U1.cpu().numpy()[u_perm], V1.cpu().numpy()[i_perm], device)
    del sides, u_blk, i_blk
    torch.cuda.empty_cache()
    out = {"phase": "train-iteration", "buckets": len(ub.widths) + len(ib.widths),
           "iteration_s": sorted(iter_s)[2],
           "iteration_s_all": iter_s, "ratings_iterations_per_s": N_RATINGS / sorted(iter_s)[2],
           "iteration_device_us_total": sum(per_kernel.values()),
           "iteration_device_us_top": iter_device_us, "rmse_after_first": rmse1}
    emit(out)
    return inter, cfg, side_rows, bucket_rows, full, out


def phase_train(inter, cfg, device, first):
    """The training main path: train_als at full width, 20 iterations."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.ops import train_kernel

    n_buckets = first["buckets"]
    ctx = DeviceContext.create(device=device)
    # the main path's window: counts read just before and just after
    train_kernel.launches.reset()
    t0 = time.perf_counter()
    model = als.train_als(ctx, inter, cfg)
    train_s = time.perf_counter() - t0
    launches = train_kernel.launches.count
    require(launches == n_buckets * cfg.iterations,
            f"launches {launches} vs {n_buckets} buckets × {cfg.iterations} iterations")
    for F in (model.user_factors, model.item_factors):
        require(bool(np.isfinite(F).all()), "finite factors")
    require(model.user_factors.shape == (N_USERS, RANK) and model.item_factors.shape == (N_ITEMS, RANK),
            "factor shapes")
    last = rmse(inter, model.user_factors, model.item_factors, device)
    require(np.isfinite(last) and last < first["rmse_after_first"],
            f"RMSE {last} after {cfg.iterations} iterations vs {first['rmse_after_first']} after 1")
    torch.cuda.synchronize()
    out = {"phase": "train", "iterations": cfg.iterations, "buckets": n_buckets,
           "launches": launches, "train_als_s": train_s, "rmse_after_first": first["rmse_after_first"],
           "rmse_after_last": last, "iteration_s": first["iteration_s"],
           "ratings_iterations_per_s": first["ratings_iterations_per_s"]}
    emit(out)
    return model, out


def phase_small_parity(seed, device):
    """A small draw trained on the card and on the CPU from one init.

    f32, explicit and implicit: five iterations of ``train_als`` on each
    device, every factor within rtol = atol = 1e-4. bf16 and int8 quantize
    the opposite factors at every half-step, so once the two devices' sums
    part in the last bit, a quantization can turn that bit into a whole
    bf16 or int8 step and the runs drift apart. They are held half-step by
    half-step instead: for five iterations, explicit and implicit, the card
    runs each half-step, the CPU runs the same half-step from the card's
    previous factors, and the two results must agree within rtol = atol =
    1e-3 before the card's result goes on.
    """
    import numpy as np
    import torch

    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.models import als

    n_users, n_items, iters = 2000, 1000, 5
    inter = zipf_interactions(seed + 3, n_users, n_items, 50_000)
    rng = np.random.default_rng(seed + 4)
    init = ((rng.standard_normal((n_users, RANK)) / np.sqrt(RANK)).astype(np.float32),
            (rng.standard_normal((n_items, RANK)) / np.sqrt(RANK)).astype(np.float32))
    card_ctx, host_ctx = DeviceContext.create(device=device), DeviceContext.create(device="cpu")

    def config(**kw):
        return als.ALSConfig(rank=RANK, alpha=2.0, reg=0.05, iterations=iters, **kw)

    def diff(a, b):
        return float(np.abs(a - b).max())

    results = []
    for implicit in (False, True):
        cfg = config(implicit=implicit)
        card = als.train_als(card_ctx, inter, cfg, init_factors=init)
        host = als.train_als(host_ctx, inter, cfg, init_factors=init)
        err = max(diff(card.user_factors, host.user_factors), diff(card.item_factors, host.item_factors))
        for a, b in ((card.user_factors, host.user_factors), (card.item_factors, host.item_factors)):
            require(np.allclose(a, b, rtol=1e-4, atol=1e-4),
                    f"card vs CPU factors, implicit={implicit} f32: max |Δ| {err}")
        results.append({"implicit": implicit, "dtype": "f32", "iterations": iters, "tol": 1e-4,
                        "max_abs_diff": err})

    # half-step by half-step, the CPU fed the card's previous factors
    ub, ib, u_perm, i_perm = als._dense_blocks_for(inter, config())
    blocks = {
        dev: [[tuple(torch.from_numpy(a).to(dev) for a in t) for t in zip(b.idx, b.rat, b.msk)]
              for b in (ub, ib)]
        for dev in (device, "cpu")
    }
    for dtype in ("bf16", "int8"):
        for implicit in (False, True):
            cfg = config(implicit=implicit, compute_dtype=dtype)
            # blocked order, host copies of the card's latest factors
            F = [torch.from_numpy(init[0][np.argsort(u_perm)]),
                 torch.from_numpy(init[1][np.argsort(i_perm)])]
            steps = []
            for it in range(iters):
                for side in (0, 1):  # user half-step gathers items, and back
                    opp = F[1 - side]
                    out = {}
                    for dev in (device, "cpu"):
                        o = opp.to(dev)
                        gram = als._gram(o) if implicit else None
                        out[dev] = als._dense_half_step(blocks[dev][side], o, gram, cfg).cpu()
                    got, ref = out[device].numpy(), out["cpu"].numpy()
                    steps.append(diff(got, ref))
                    require(np.allclose(got, ref, rtol=1e-3, atol=1e-3),
                            f"card vs CPU {dtype} implicit={implicit} iteration {it} "
                            f"{('user', 'item')[side]} half-step: max |Δ| {steps[-1]}")
                    F[side] = out[device]
            results.append({"dtype": dtype, "implicit": implicit, "iterations": iters,
                            "tol": 1e-3, "half_step_max_abs_diff": steps})
    emit({"phase": "train-small-parity", "cases": results, "ok": True})


def phase_workflow(seed, device):
    """Events in MEMORY storage → run_train on the card → COMPLETED, with the
    dense solver and then with ``PIO_ALS_SOLVER=segment``; the segment
    instance is deployed and answers 20 queries, each held against the
    plain version."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.core import workflow
    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import memory
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.ops import train_kernel
    from predictionio_tpu_torch.serving.query_server import QueryServer
    from predictionio_tpu_torch.templates.recommendation import RecommendationEngine
    from predictionio_tpu_torch.testing import topk_mismatches

    t_phase = time.perf_counter()
    source = "CHIPSMOKEEV"
    storage = Storage(env={f"PIO_STORAGE_SOURCES_{source}_TYPE": "memory"})
    rng = np.random.default_rng(seed + 5)
    app_id = storage.get_meta_data_apps().insert(App(0, "ChipSmoke"))
    events = []
    for k in range(5000):
        u, i = f"u{int(rng.integers(300))}", f"i{int(rng.integers(200))}"
        if k % 5 == 0:
            events.append(Event(event="buy", entity_type="user", entity_id=u,
                                target_entity_type="item", target_entity_id=i))
        else:
            events.append(Event(event="rate", entity_type="user", entity_id=u,
                                target_entity_type="item", target_entity_id=i,
                                properties={"rating": float(rng.integers(1, 6))}))
    storage.get_l_events().insert_batch(events, app_id)
    engine = RecommendationEngine.apply()
    params = engine.params_from_variant({
        "datasource": {"params": {"appName": "ChipSmoke"}},
        "algorithms": [{"name": "als", "params": {"rank": RANK, "numIterations": 5}}],
    })
    ctx = DeviceContext.create(device=device)
    store.set_storage(storage)
    saved = os.environ.get("PIO_ALS_SOLVER")
    try:
        train_kernel.launches.reset()
        iid = workflow.run_train(engine, params, ALS_FACTORY, storage=storage, ctx=ctx)
        launches = train_kernel.launches.count
        inst = storage.get_meta_data_engine_instances().get(iid)
        require(inst.status == "COMPLETED", f"run_train instance status {inst.status}")
        require(launches > 0 and launches % 5 == 0, f"run_train launched the kernel ({launches})")
        require(storage.get_model_data_models().get(iid) is not None, "model blob stored")

        # the same events under PIO_ALS_SOLVER=segment, set for the call only
        os.environ["PIO_ALS_SOLVER"] = "segment"
        for c in (train_kernel.launches, train_kernel.gather_launches, train_kernel.segment_launches):
            c.reset()
        try:
            seg_iid = workflow.run_train(engine, params, ALS_FACTORY, storage=storage, ctx=ctx)
        finally:
            if saved is None:
                os.environ.pop("PIO_ALS_SOLVER", None)
            else:
                os.environ["PIO_ALS_SOLVER"] = saved
        segments = train_kernel.segment_launches.count
        gathers, dense_launches = train_kernel.gather_launches.count, train_kernel.launches.count
        seg_inst = storage.get_meta_data_engine_instances().get(seg_iid)
        require(seg_inst.status == "COMPLETED", f"segment run_train status {seg_inst.status}")
        require(segments == 2 * 5 and gathers == 0 and dense_launches == 0,
                f"segment run_train: segment kernel {segments} (want 10), gather {gathers}, "
                f"training kernel {dense_launches} launches")
        _, _, _, models = workflow.prepare_deploy(engine, seg_inst, storage=storage, ctx=ctx)
        model = models[0]
        require(model.config.solver == "segment", f"stored solver {model.config.solver}")

        qs = QueryServer(RecommendationEngine.apply(), storage=storage, ctx=ctx, batching=True)
        try:
            base = f"http://127.0.0.1:{qs.start('127.0.0.1', 0)}"
            with urllib.request.urlopen(f"{base}/readyz", timeout=30) as r:
                ready = json.loads(r.read())
            require(ready["engineInstanceId"] == seg_iid, f"deployed the segment instance: {ready}")
            users = [model.user_map.inverse[j] for j in rng.integers(0, len(model.user_map), 20)]
            plain = Inputs(model.user_factors, model.item_factors, "f32", device)
            n_items = model.item_factors.shape[0]
            bad, answers = [], []
            for u in users:
                num = int(rng.integers(5, 30))
                req = urllib.request.Request(
                    f"{base}/queries.json", data=json.dumps({"user": u, "num": num}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as r:
                    a = json.loads(r.read())
                answers.append(a)
                u_idx = torch.tensor([model.user_map[u]], dtype=torch.int32, device=device)
                rv, ri = (t.cpu().numpy() for t in plain.plain(u_idx, min(num, n_items)))
                got_i = np.array([[model.item_map[x["item"]] for x in a["itemScores"]]])
                got_v = np.array([[x["score"] for x in a["itemScores"]]])
                bad += topk_mismatches(got_v, got_i, rv, ri, TOL)
            require(len(answers) == 20 and not bad,
                    f"segment-trained answers disagree with the plain version: {bad[:3]}")
        finally:
            qs.stop()
    finally:
        store.set_storage(None)
        memory.reset_store(source)
    emit({"phase": "train-workflow", "events": len(events), "instance": iid,
          "status": inst.status, "launches": launches,
          "segment": {"instance": seg_iid, "status": seg_inst.status,
                      "segment_launches": segments, "queries": len(answers), "ok": True},
          "seconds": time.perf_counter() - t_phase})


ALS_FACTORY = "predictionio_tpu_torch.templates.recommendation.RecommendationEngine"


# -- the segment solver ---------------------------------------------------------

GATHER_EDGE_N = (1, 7, 513, 65_536 + 3)
GATHER_EDGE_RANKS = (1, 4, 10, 64, 65, 128, 256)
# the JAX package's own dense-vs-segment prediction tolerance (tests/test_als.py:339-353)
SEG_PRED_RTOL, SEG_PRED_ATOL = 5e-2, 5e-3


def gather_bound(idx, n_opp, rank, dtype):
    """Least time for one gather call: idx read once (4 B a row), each
    distinct row of V it names read once (with its scale for int8), the
    (n, rank) float32 output written once; one multiply a value for int8."""
    import numpy as np

    from predictionio_tpu_torch.ops.quantize import FACTOR_BYTES

    n = len(idx)
    distinct = int(np.unique(np.clip(idx, 0, n_opp - 1)).size)
    nbytes = 4 * n + 4 * n * rank + distinct * (rank * FACTOR_BYTES[dtype] + (4 if dtype == "int8" else 0))
    ops = n * rank if dtype == "int8" else 0
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), distinct


def gather_library(V, idx, v_scale):
    """One PyTorch call (two for int8) that computes the gather: the yardstick."""
    if v_scale is None:
        return V.index_select(0, idx).float()
    return V.index_select(0, idx).float() * v_scale.index_select(0, idx)


def phase_gather_kernel(seed, device, inter):
    """Kernel 3 against its plain version on the card, bit for bit: the first
    chunk of each side's ML-25M stream, ranks and lengths at the edges; times
    at the main path's shape."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.ops import train_kernel
    from predictionio_tpu_torch.ops.quantize import quantize_factors_torch

    t0 = time.perf_counter()
    ub, ib = als._segment_blocks_for(inter)
    rng = np.random.default_rng(seed + 20)
    U = torch.from_numpy((rng.standard_normal((N_USERS, RANK)) / np.sqrt(RANK)).astype(np.float32)).to(device)
    V = torch.from_numpy((rng.standard_normal((N_ITEMS, RANK)) / np.sqrt(RANK)).astype(np.float32)).to(device)
    # the user half-step gathers item rows, the item half-step user rows
    sides = {"user": (ub.other[: als._CHUNK], V), "item": (ib.other[: als._CHUNK], U)}
    checked, rows = 0, []
    for name, (idx_h, opp) in sides.items():
        idx = torch.from_numpy(idx_h).to(device)
        for dtype in DTYPES:
            q, s = quantize_factors_torch(opp, dtype)
            got = train_kernel.fused_gather_rows(q, idx, s)
            ref = train_kernel.gather_rows_reference(q, idx, s)
            torch.cuda.synchronize()
            require(got.dtype == torch.float32 and torch.equal(got, ref),
                    f"gather {name} side {dtype}: kernel differs from plain version "
                    f"(max |Δ| {float((got - ref).abs().max())})")
            checked += 1
            bms, by, distinct = gather_bound(idx_h, opp.shape[0], RANK, dtype)
            rows.append({
                "side": name, "dtype": dtype, "n": len(idx_h), "n_opp": opp.shape[0],
                "distinct_rows": distinct,
                "ms": cuda_ms(lambda: train_kernel.fused_gather_rows(q, idx, s), 200),
                "device_us": device_us(lambda: train_kernel.fused_gather_rows(q, idx, s), 20),
                "plain_ms": cuda_ms(lambda: train_kernel.gather_rows_reference(q, idx, s), 50),
                "library_ms": cuda_ms(lambda: gather_library(q, idx, s), 200),
                "library_device_us": device_us(lambda: gather_library(q, idx, s), 20),
                "library": "index_select" + (".float()" if dtype != "f32" else "")
                           + (" * scale.index_select" if dtype == "int8" else ""),
                "bound_ms": bms, "bound_by": by,
            })
            emit({"phase": "gather-kernel-time", **rows[-1]})
    # the edges: lengths, ranks, indices at and beyond both ends, n = 0
    for n in GATHER_EDGE_N:
        for k in GATHER_EDGE_RANKS:
            n_opp = 1000
            opp = torch.from_numpy(rng.normal(size=(n_opp, k)).astype(np.float32)).to(device)
            idx_h = rng.integers(0, n_opp, n).astype(np.int32)
            idx_h[0] = n_opp - 1
            idx_h[-1] = 0
            if n >= 7:
                idx_h[1:5] = (-1, -70_000, n_opp, 2**31 - 1)  # clamped
            idx = torch.from_numpy(idx_h).to(device)
            for dtype in DTYPES:
                q, s = quantize_factors_torch(opp, dtype)
                got = train_kernel.fused_gather_rows(q, idx, s)
                ref = train_kernel.gather_rows_reference(q, idx, s)
                torch.cuda.synchronize()
                require(got.shape == (n, k) and torch.equal(got, ref),
                        f"gather edge n={n} rank {k} {dtype}: kernel differs from plain version")
                checked += 1
    before = train_kernel.gather_launches.count
    empty = train_kernel.fused_gather_rows(V, torch.zeros(0, dtype=torch.int32, device=device))
    require(empty.shape == (0, RANK) and train_kernel.gather_launches.count == before,
            "n = 0 returns (0, k) and launches nothing")
    emit({"phase": "gather-kernel", "checked": checked + 1, "max_abs_err": 0.0,
          "bitwise": True, "seconds": time.perf_counter() - t0, "ok": True})
    return rows, 0.0


SEG_DRAW = (20_000, 5_000, 1_000_000)  # users, items, ratings: 16 chunks of 65,536
SEG_EDGE_RANKS = (1, 65)  # 65: past the dense kernel's 64, 18 and 34 tiles of accumulators
SEG_EDGE_CHUNK = 4096  # 20,000 ratings in five chunks at the edge ranks


def segment_stats(lay):
    """Host copies of a layout's sizes: slots, runs, entities, heavy ones."""
    return {"slots": int(lay.other.shape[0]), "runs": int(lay.run_offsets.shape[0]) - 1,
            "entities": lay.n_entity, "heavy": int(lay.heavy.shape[0])}


def segment_bound(stats, distinct, rank, dtype):
    """Least time for one segment half-step, explicit: the sorted stream read
    once (other and rating, 8 B a slot), the run and entity offsets and the
    entity lists (4 B each), each distinct row of V the stream names (with
    its scale for int8), A, b and cnt written once; a slot's f32 operations
    are the products and sums of A's entries i ≤ j (A is symmetric, its
    mirror is a copy), of b and of the count, k(k + 1) + 2k + 1, k more for
    int8 rows (the scale), and a run's the fold of those k(k + 1)/2 + k + 1
    sums into the carry."""
    from predictionio_tpu_torch.ops.quantize import FACTOR_BYTES

    k, nnz, runs, n = rank, stats["slots"], stats["runs"], stats["entities"]
    nbytes = (8 * nnz + 4 * (runs + 1) + 4 * (n + 1) + 4 * n
              + distinct * (k * FACTOR_BYTES[dtype] + (4 if dtype == "int8" else 0))
              + 4 * n * (k * k + k + 1))
    ops = (nnz * (k * (k + 1) + 2 * k + 1 + (k if dtype == "int8" else 0))
           + runs * (k * (k + 1) // 2 + k + 1))
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_segment(blk, chunk, opp, dtype, implicit, device, what):
    """The segment kernel on the card against its plain version on the CPU
    (the layout's stream, the same chunk): A, b and cnt bit for bit, and a
    second launch byte for byte. Returns the layouts' sizes."""
    import torch

    from predictionio_tpu_torch.ops import train_kernel
    from predictionio_tpu_torch.ops.quantize import quantize_factors_torch

    stream = [torch.from_numpy(a) for a in (blk.local, blk.other, blk.rating, blk.mask)]
    lay = train_kernel.segment_layout(*(t.to(device) for t in stream), blk.n_entity, chunk=chunk)
    q, s = quantize_factors_torch(opp, dtype)
    got = train_kernel.fused_segment_normal_eq(lay, q, s, implicit=implicit, alpha=2.0)
    again = train_kernel.fused_segment_normal_eq(lay, q, s, implicit=implicit, alpha=2.0)
    ref = train_kernel.segment_normal_eq_reference(
        *stream, blk.n_entity, q.cpu(), None if s is None else s.cpu(),
        implicit=implicit, alpha=2.0, chunk=chunk)
    torch.cuda.synchronize()
    for name, g, a, r in zip(("A", "b", "cnt"), got, again, ref):
        g = g.cpu()
        require(g.dtype == torch.float32 and torch.equal(g, r),
                f"segment {what} {dtype} implicit={implicit}: kernel {name} differs from the "
                f"plain version (max |Δ| {float((g - r).abs().max())})")
        require(torch.equal(a.cpu(), g), f"segment {what}: two launches differ in {name}")
    return segment_stats(lay)


def phase_segment_kernel(seed, device, inter):
    """The segment kernel against its plain version, bit for bit: a 1,000,000-
    rating draw (16 chunks, Zipf-hot items a block each) at rank 10 × dtypes
    × explicit/implicit, both sides; ranks 1 and 65 on 20,000 ratings in
    chunks of 4,096 with every entity of 64 slots or more on a block; then
    the ML-25M draw, f32 explicit, both sides, against the plain version run
    on the CPU. Times each side at the ML-25M shape: the layout's build, the
    kernel (CUDA events over back-to-back calls), the plain version (the
    chunk loop on the card) and the bound."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.ops import train_kernel
    from predictionio_tpu_torch.ops.quantize import quantize_factors_torch

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 22)

    def factors(n, k):
        return torch.from_numpy((rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)).to(device)

    checked, cases = 0, []
    n_u, n_i, n_r = SEG_DRAW
    small = zipf_interactions(seed + 22, n_u, n_i, n_r)
    ub, ib = als._segment_blocks_for(small)
    U, V = factors(n_u, RANK), factors(n_i, RANK)
    for dtype in DTYPES:
        for implicit in (False, True):
            for side, blk, opp in (("user", ub, V), ("item", ib, U)):
                st = check_segment(blk, als._CHUNK, opp, dtype, implicit, device, f"{side} side")
                checked += 1
            cases.append({"dtype": dtype, "implicit": implicit, "rank": RANK, "ratings": n_r})
    require(st["heavy"] > 0, f"the draw's hot items take a block: {st}")
    edge = zipf_interactions(seed + 23, 300, 200, 20_000)
    eb = als._segment_blocks_for(edge)
    heavy_slots = train_kernel.HEAVY_SLOTS
    train_kernel.HEAVY_SLOTS = 64
    try:
        for k in SEG_EDGE_RANKS:
            opps = (factors(200, k), factors(300, k))
            for dtype in ("f32", "int8"):
                for implicit in (False, True):
                    for side, blk, opp in zip(("user", "item"), eb, opps):
                        check_segment(blk, SEG_EDGE_CHUNK, opp, dtype, implicit, device,
                                      f"rank {k} {side} side")
                        checked += 1
                    cases.append({"dtype": dtype, "implicit": implicit, "rank": k, "ratings": 20_000,
                                  "chunk": SEG_EDGE_CHUNK, "heavy_slots": 64})
    finally:
        train_kernel.HEAVY_SLOTS = heavy_slots
    emit({"phase": "segment-kernel", "checked": checked, "cases": cases, "max_abs_err": 0.0,
          "bitwise": True, "seconds": time.perf_counter() - t_phase})

    # the main path's shape: the ML-25M draw, rank 10, f32, explicit
    t_full = time.perf_counter()
    full_u, full_i = als._segment_blocks_for(inter)
    U, V = factors(N_USERS, RANK), factors(N_ITEMS, RANK)
    rows = []
    for side, blk, opp in (("user", full_u, V), ("item", full_i, U)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lay = als._segment_layout(blk, device)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        stats = segment_stats(lay)
        q, s = quantize_factors_torch(opp, "f32")
        chunk = min(blk.length, als._CHUNK)
        stream = [torch.from_numpy(a).to(device) for a in (blk.local, blk.other, blk.rating, blk.mask)]

        def kernel():
            return train_kernel.fused_segment_normal_eq(lay, q, s)

        def plain():
            return train_kernel.segment_normal_eq_reference(*stream, blk.n_entity, q, s, chunk=chunk)

        got = [t.cpu() for t in kernel()]
        ref = train_kernel.segment_normal_eq_reference(
            *(torch.from_numpy(a) for a in (blk.local, blk.other, blk.rating, blk.mask)),
            blk.n_entity, q.cpu(), chunk=chunk)
        for name, g, r in zip(("A", "b", "cnt"), got, ref):
            require(torch.equal(g, r), f"segment ML-25M {side} side: kernel {name} differs from the "
                                       f"plain version on the CPU (max |Δ| {float((g - r).abs().max())})")
        checked += 1
        distinct = int(np.unique(blk.other[: stats["slots"]]).size)
        bms, by = segment_bound(stats, distinct, RANK, "f32")
        rows.append({
            "side": side, "dtype": "f32", "implicit": False, "chunk": chunk, **stats,
            "distinct_rows": distinct, "layout_build_s": build_s,
            # one launch a call, ~1 ms of device work each, back to back: the
            # events time the card (train-segment's trace gives its device µs)
            "ms": cuda_ms(kernel, 20),
            "plain_ms": cuda_ms(plain, 2), "bound_ms": bms, "bound_by": by, "library_ms": None,
        })
        emit({"phase": "segment-kernel-time", **rows[-1]})
        del lay, stream, got, ref
        torch.cuda.empty_cache()
    emit({"phase": "segment-kernel-full", "checked": 2, "bitwise_vs_cpu": True,
          "seconds": time.perf_counter() - t_full, "ok": True})
    return rows, 0.0


def phase_train_segment(inter, seed, device, dense_model, dense_out):
    """The segment solver's main path at full width: train_als, 20 iterations."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.ops import train_kernel

    t_phase = time.perf_counter()
    cfg = als.ALSConfig(rank=RANK, iterations=TRAIN_ITERS, seed=seed, solver="segment")
    ub, ib = als._segment_blocks_for(inter)
    chunks = {name: b.length // min(b.length, als._CHUNK) for name, b in (("user", ub), ("item", ib))}
    ctx = DeviceContext.create(device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    start_gb = torch.cuda.memory_allocated(device) / 1e9  # held by earlier phases
    # the main path's window: counts read just before and just after
    counters = (train_kernel.segment_launches, train_kernel.gather_launches, train_kernel.launches)
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    model = als.train_als(ctx, inter, cfg)
    train_s = time.perf_counter() - t0
    segments, gathers, dense_launches = (c.count for c in counters)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    require(segments == 2 * cfg.iterations,
            f"segment kernel launches {segments} vs 2 half-steps × {cfg.iterations} iterations")
    require(gathers == 0 and dense_launches == 0,
            f"train_als launched the gather kernel {gathers} and the training kernel "
            f"{dense_launches} times")
    for F in (model.user_factors, model.item_factors):
        require(bool(np.isfinite(F).all()), "finite factors")
    require(model.config.solver == "segment", "segment model")

    # one iteration from the initial factors (the first train_als runs),
    # timed, then its device time by kernel and by op
    gen = torch.Generator(device="cpu").manual_seed(cfg.seed)
    U0 = torch.from_numpy(als._initial_factors(cfg, N_USERS, gen)).to(device)
    V0 = torch.from_numpy(als._initial_factors(cfg, N_ITEMS, gen)).to(device)
    # the layouts train_als builds before its loop, timed
    torch.cuda.synchronize()
    t = time.perf_counter()
    layouts = [als._segment_layout(b, device) for b in (ub, ib)]
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t

    def iteration():
        U1 = als._half_step(layouts[0], V0, None, cfg)
        return U1, als._half_step(layouts[1], U1, None, cfg)

    iter_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        U1, V1 = iteration()
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t)
    median = float(np.median(iter_s))
    rmse1 = rmse(inter, U1.cpu().numpy(), V1.cpu().numpy(), device)
    prof = op_device_us(iteration, 3)
    busy_us = sum(prof["kernels"].values())
    del layouts, U1, V1
    torch.cuda.empty_cache()

    last = rmse(inter, model.user_factors, model.item_factors, device)
    dense_rmse = dense_out["rmse_after_last"]
    require(np.isfinite(last) and last < rmse1,
            f"segment RMSE {last} after {cfg.iterations} iterations vs {rmse1} after 1")
    rel = abs(last - dense_rmse) / dense_rmse
    require(rel <= 1e-3, f"segment RMSE {last} vs dense {dense_rmse}: {rel} relative")
    # predictions of 10,000 sampled (user, item) pairs against the dense model's
    rng = np.random.default_rng(seed + 21)
    u = rng.integers(0, N_USERS, 10_000)
    i = rng.integers(0, N_ITEMS, 10_000)
    ps = np.einsum("nk,nk->n", model.user_factors[u], model.item_factors[i])
    pd = np.einsum("nk,nk->n", dense_model.user_factors[u], dense_model.item_factors[i])
    beyond = np.abs(ps - pd) > SEG_PRED_ATOL + SEG_PRED_RTOL * np.abs(pd)

    def top(d, m=12):
        return dict(sorted(d.items(), key=lambda kv: -kv[1])[:m])

    out = {"phase": "train-segment", "iterations": cfg.iterations, "chunk": als._CHUNK,
           "chunks": chunks, "padded_slots": {"user": ub.length, "item": ib.length},
           "layout_build_s": layout_s, "segment_launches": segments,
           "gather_launches": gathers, "launches_training_kernel": dense_launches,
           "train_als_s": train_s, "iteration_s": median, "iteration_s_all": iter_s,
           "ratings_iterations_per_s": N_RATINGS / median,
           "rmse_after_first": rmse1, "rmse_after_last": last, "dense_rmse_after_last": dense_rmse,
           "rmse_rel_vs_dense": rel,
           "pred_pairs": 10_000, "pred_max_abs_diff_vs_dense": float(np.abs(ps - pd).max()),
           "pred_share_beyond_tol": float(beyond.mean()),
           "pred_tol": {"rtol": SEG_PRED_RTOL, "atol": SEG_PRED_ATOL},
           "iteration_device_us_total": busy_us,
           "iteration_idle_share": 1.0 - busy_us * 1e-6 / median,
           "iteration_device_us_by_kernel": top(prof["kernels"]),
           "iteration_launches": sum(prof["launches"].values()),
           "iteration_launches_by_kernel": top(prof["launches"]),
           "iteration_device_us_by_op": top(prof["ops"]),
           "peak_memory_gb": peak_gb, "memory_at_start_gb": start_gb,
           "seconds": time.perf_counter() - t_phase, "ok": True}
    emit(out)
    return out


def phase_segment_parity(seed, device):
    """The segment solver on a small draw, on the card and on the CPU from
    one init, by ``phase_small_parity``'s rule: f32 free-running over five
    iterations at rtol = atol = 1e-4; bf16 and int8 half-step by half-step
    at 1e-3, the CPU fed the card's previous factors. The normal equations
    are equal on both devices bit for bit (``segment-kernel``); the factors
    part where the two devices' Cholesky solves round differently. Then f32
    twice on the card from one seed: the kernel sums in one fixed order, so
    the two runs must be bit-identical."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.models import als

    t_phase = time.perf_counter()
    n_users, n_items, iters = 2000, 1000, 5
    inter = zipf_interactions(seed + 3, n_users, n_items, 50_000)
    rng = np.random.default_rng(seed + 4)
    init = ((rng.standard_normal((n_users, RANK)) / np.sqrt(RANK)).astype(np.float32),
            (rng.standard_normal((n_items, RANK)) / np.sqrt(RANK)).astype(np.float32))
    card_ctx, host_ctx = DeviceContext.create(device=device), DeviceContext.create(device="cpu")

    def config(**kw):
        return als.ALSConfig(rank=RANK, alpha=2.0, reg=0.05, iterations=iters, solver="segment", **kw)

    def diff(a, b):
        return float(np.abs(a - b).max())

    results = []
    for implicit in (False, True):
        cfg = config(implicit=implicit)
        card = als.train_als(card_ctx, inter, cfg, init_factors=init)
        host = als.train_als(host_ctx, inter, cfg, init_factors=init)
        err = max(diff(card.user_factors, host.user_factors), diff(card.item_factors, host.item_factors))
        for a, b in ((card.user_factors, host.user_factors), (card.item_factors, host.item_factors)):
            require(np.allclose(a, b, rtol=1e-4, atol=1e-4),
                    f"segment card vs CPU factors, implicit={implicit} f32: max |Δ| {err}")
        results.append({"implicit": implicit, "dtype": "f32", "iterations": iters, "tol": 1e-4,
                        "max_abs_diff": err})

    blocks = {dev: [als._segment_layout(b, dev) for b in als._segment_blocks_for(inter)]
              for dev in (device, "cpu")}
    for dtype in ("bf16", "int8"):
        for implicit in (False, True):
            cfg = config(implicit=implicit, compute_dtype=dtype)
            F = [torch.from_numpy(init[0]), torch.from_numpy(init[1])]
            steps = []
            for it in range(iters):
                for side in (0, 1):  # user half-step gathers items, and back
                    opp = F[1 - side]
                    out = {}
                    for dev in (device, "cpu"):
                        o = opp.to(dev)
                        gram = als._gram(o) if implicit else None
                        out[dev] = als._half_step(blocks[dev][side], o, gram, cfg).cpu()
                    got, ref = out[device].numpy(), out["cpu"].numpy()
                    steps.append(diff(got, ref))
                    require(np.allclose(got, ref, rtol=1e-3, atol=1e-3),
                            f"segment card vs CPU {dtype} implicit={implicit} iteration {it} "
                            f"{('user', 'item')[side]} half-step: max |Δ| {steps[-1]}")
                    F[side] = out[device]
            results.append({"dtype": dtype, "implicit": implicit, "iterations": iters,
                            "tol": 1e-3, "half_step_max_abs_diff": steps})

    cfg = config()
    a = als.train_als(card_ctx, inter, cfg, init_factors=init)
    b = als.train_als(card_ctx, inter, cfg, init_factors=init)
    identical = bool(np.array_equal(a.user_factors, b.user_factors)
                     and np.array_equal(a.item_factors, b.item_factors))
    rerun = max(diff(a.user_factors, b.user_factors), diff(a.item_factors, b.item_factors))
    require(identical, f"two card runs of one seed differ: max |Δ| {rerun}")
    out = {"phase": "segment-parity", "cases": results,
           "rerun": {"bit_identical": identical, "max_abs_diff": rerun, "iterations": iters},
           "seconds": time.perf_counter() - t_phase, "ok": True}
    emit(out)
    return out


ALS_VARIANT = {"algorithms": [{"name": "als", "params": {"rank": RANK}}]}


def publish(storage, engine, model, variant=ALS_VARIANT, factory=ALS_FACTORY,
            engine_id="default"):
    """Write ``model`` as a COMPLETED engine instance with its sealed blob,
    the steps the training workflow takes after training. ``pio deploy``
    looks instances up under ``engine_id`` = the engine.json's factory."""
    import datetime as dt

    from predictionio_tpu_torch.core import persistence
    from predictionio_tpu_torch.data.storage.base import EngineInstance, Model

    params = engine.params_from_variant(variant)
    algorithms = engine.make_algorithms(params)
    instances = storage.get_meta_data_engine_instances()
    now = dt.datetime.now(tz=dt.timezone.utc)
    inst = EngineInstance(
        id="", status=instances.STATUS_INIT, start_time=now, end_time=now,
        engine_id=engine_id, engine_version="default", engine_variant="default",
        engine_factory=factory, **params.to_json_strings(),
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


def phase_serving(model, seed, device):
    """Deploy ``model`` (the full-width trained one) and serve it."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.data.storage import memory
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.ops import score_kernel
    from predictionio_tpu_torch.testing import topk_mismatches
    from predictionio_tpu_torch.serving.query_server import QueryServer
    from predictionio_tpu_torch.templates.recommendation import RecommendationEngine

    t0 = time.perf_counter()
    U, V = model.user_factors, model.item_factors
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


# -- SASRec serving -----------------------------------------------------------

# Kang & McAuley, "Self-Attentive Sequential Recommendation" (ICDM 2018), §IV,
# MovieLens-1M: d = 50, 2 self-attention blocks, 1 head; the filtered catalog
# holds 6,040 users × 3,416 items. maxLen is 256, not the paper's 200: the
# shortest length the JAX package sends to its flash kernel.
SAS_D, SAS_LAYERS, SAS_HEADS, SAS_MAX_LEN, SAS_ITEMS = 50, 2, 1, 256, 3416
SAS_USERS = 120  # users with a history, each queried in both serving modes
SAS_VARIANT = {
    "datasource": {"params": {"appName": "ChipSmokeSeq"}},
    "algorithms": [{"name": "sasrec", "params": {
        "appName": "ChipSmokeSeq", "eventNames": ["view"], "dModel": SAS_D,
        "numLayers": SAS_LAYERS, "numHeads": SAS_HEADS, "maxLen": SAS_MAX_LEN}}],
}
SAS_FACTORY = "predictionio_tpu_torch.templates.sequentialrecommendation.SequentialRecommendationEngine"
# (B·H, T_q, T_kv, h): serving (one query, one head), the template's
# batchSize at this width, longer blocks, and T_q != T_kv both ways
FLASH_SHAPES = (
    (1, 256, 256, 50), (128, 256, 256, 50), (16, 512, 512, 16), (8, 1024, 1024, 64),
    (4, 2048, 2048, 128), (4, 256, 1024, 50), (4, 1024, 256, 64),
)
FLASH_O_TOL = 2e-5  # rtol = atol: the JAX package's flash test
FLASH_LSE_TOL = 1e-5  # rtol = atol
SAS_TOL = 1e-4  # served logits vs the plain forward, rtol = atol


def visible_pairs(t_q, t_kv, causal):
    """(query, key) pairs a causal mask by absolute position leaves, or all."""
    import numpy as np

    return int(np.minimum(np.arange(t_q) + 1, t_kv).sum()) if causal else t_q * t_kv


def flash_bound(bh, t_q, t_kv, h, causal, products_on="tf32x3"):
    """Least time: q, k, v read once, o and lse written once (f32); two
    products of h multiply-adds over each visible (query, key) pair and one
    exponential a pair. ``products_on`` "tf32x3": the products on the tensor
    cores as three TF32 products each (the committed kernel 4), the
    exponentials at the f32 rate; "f32": everything at the f32 rate outside
    the tensor cores (the bound of the earlier FMA kernel, for comparison)."""
    pairs = bh * visible_pairs(t_q, t_kv, causal)
    nbytes = 4 * bh * (2 * t_q * h + 2 * t_kv * h + t_q)
    t_bytes = nbytes / PEAK_BYTES_S
    if products_on == "f32":
        t_ops = 4 * h * pairs / PEAK_F32_OPS_S
    else:
        t_ops = 4 * h * pairs / (PEAK_TF32_OPS_S / 3) + pairs / PEAK_F32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_backend(fn) -> dict:
    """Which ``F.scaled_dot_product_attention`` backend the default dispatch
    ran for ``fn``: each backend is tried alone under
    ``torch.nn.attention.sdpa_kernel`` (a backend that does not take the
    inputs raises and is left out); the one whose device kernels are those
    of the default call names it."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    default = sorted(device_us(fn, 2))
    kernels = {}
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
              SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        with sdpa_kernel([b]):
            try:
                fn()
                torch.cuda.synchronize()
            except RuntimeError:  # "No available kernel": not this backend
                continue
            kernels[b.name] = sorted(device_us(fn, 2))
    ran = [name for name, ks in kernels.items() if default and ks == default]
    return {"backend": ran[0] if len(ran) == 1 else "not recorded",
            "default_kernels": default, "runnable": kernels}


def phase_sasrec_kernel(seed, device):
    """The flash kernel against its plain version (f32 and f64) at every
    FLASH_SHAPES shape, causal and not; times at the serving shape and at
    the batchSize shape."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from predictionio_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's products in full f32
    rng = np.random.default_rng(seed + 7)
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    cases, max_o, max_lse = [], 0.0, 0.0
    inputs = {}
    for bh, t_q, t_kv, h in FLASH_SHAPES:
        q, k, v = (torch.from_numpy(rng.standard_normal((bh, t, h)).astype(np.float32)).to(device)
                   for t in (t_q, t_kv, t_kv))
        inputs[(bh, t_q, t_kv, h)] = (q, k, v)
        for causal in (True, False):
            o, lse = fa.flash_block_fwd(q, k, v, causal)
            o2, lse2 = fa.flash_block_fwd(q, k, v, causal)  # a relaunch: the same bytes
            ro, rlse = fa.flash_attention_reference(q, k, v, causal)
            o64, lse64 = fa.flash_attention_reference(q.double(), k.double(), v.double(), causal)
            torch.cuda.synchronize()
            what = f"flash ({bh}, {t_q}, {t_kv}, {h}) causal={causal}"
            require(bool(torch.isfinite(o).all() and torch.isfinite(lse).all()), f"{what}: finite")
            require(torch.equal(o, o2) and torch.equal(lse, lse2), f"{what}: a relaunch gives other bytes")
            for got, ref, tol, name in ((o, ro, FLASH_O_TOL, "o"), (lse, rlse, FLASH_LSE_TOL, "lse")):
                excess = float(((got - ref).abs() - (tol + tol * ref.abs())).max())
                require(excess <= 0, f"{what}: {name} disagrees with the plain version by {excess} past tolerance")
            gap = {
                "o_kernel_vs_plain": float((o - ro).abs().max()),
                "o_kernel_vs_f64": float((o.double() - o64).abs().max()),
                "o_plain_vs_f64": float((ro.double() - o64).abs().max()),
                "lse_kernel_vs_plain": float((lse - rlse).abs().max()),
                "lse_kernel_vs_f64": float((lse.double() - lse64).abs().max()),
                "lse_plain_vs_f64": float((rlse.double() - lse64).abs().max()),
            }
            max_o = max(max_o, gap["o_kernel_vs_plain"])
            max_lse = max(max_lse, gap["lse_kernel_vs_plain"])
            cases.append({"shape": [bh, t_q, t_kv, h], "causal": causal,
                          "plan": fa.split_plan(bh, t_q, t_kv, causal, n_sm), **gap})
    emit({"phase": "sasrec-kernel", "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cases": cases, "max_abs_err_o": max_o, "max_abs_err_lse": max_lse,
          "relaunch_identical": True, "ok": True})
    # the serving shape's grid: one launch of key splits that fills the card
    q_rows, ks, blocks = fa.split_plan(*FLASH_SHAPES[0][:3], True, n_sm)
    require(blocks >= 64 and ks <= 64, f"serving-shape plan {q_rows, ks, blocks}: at least 64 "
                                       f"blocks of at most 64 keys")
    emit({"phase": "sasrec-split-plan", "shape": list(FLASH_SHAPES[0]), "causal": True, "sms": n_sm,
          "q_rows": q_rows, "keys_a_split": ks, "blocks": blocks, "ok": True})

    rows = []
    for shape in FLASH_SHAPES[:2]:
        bh, t_q, t_kv, h = shape
        q, k, v = inputs[shape]
        q4, k4, v4 = (x[:, None] for x in (q, k, v))  # (B, H = 1, T, h)
        bms, by = flash_bound(bh, t_q, t_kv, h, True)

        def sdpa():
            return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

        scale = fa._f32(1.0 / h ** 0.5)
        rows.append({
            "shape": list(shape), "causal": True,
            "plan": fa.split_plan(bh, t_q, t_kv, True, n_sm),
            "ms": cuda_ms(lambda: fa.flash_block_fwd(q, k, v, True), 200),
            "plain_ms": cuda_ms(lambda: fa.flash_attention_reference(q, k, v, True), 100),
            "library_ms": cuda_ms(sdpa, 200),
            "library_backend": sdpa_backend(sdpa),
            "bound_ms": bms, "bound_by": by,
            "bound_f32_ms": flash_bound(bh, t_q, t_kv, h, True, "f32")[0],
            "kernel_device_us": device_us(lambda: fa.flash_block_fwd(q, k, v, True)),
            # host µs a call of the wrapper's launch (allocation, plan, ctypes)
            "launch_host_us": host_us(lambda: fa._launch(q, k, v, True, scale), 300),
        })
        emit({"phase": "sasrec-kernel-time", **rows[-1]})
    return rows, max_o


def sasrec_histories(seed):
    """Per queried user, item indices oldest → newest: lengths from 1 to
    beyond maxLen (padding and truncation), items drawn from the catalog
    with repeats."""
    import numpy as np

    rng = np.random.default_rng(seed + 8)
    lengths = np.unique(np.concatenate([[1, 2, 255, 256, 257, 400],
                                        rng.integers(1, 420, SAS_USERS)]))[:SAS_USERS]
    lengths = np.concatenate([lengths, rng.integers(1, 420, SAS_USERS - len(lengths))])
    return {f"su{n}": rng.integers(0, SAS_ITEMS, int(L)) for n, L in enumerate(lengths)}


def hold_answers(model, device, histories, answers, nums):
    """Every served ``(user, answer)`` against the port's forward with the
    plain attention on the card: items by ``topk_mismatches`` at SAS_TOL, no
    history item back, ``[]`` for a user with no catalog item in the last
    ``maxLen`` events. ``histories`` maps each user with events to its item
    ids, oldest first. Returns the largest |Δ| of an answered score, the
    plain logits of the users with catalog items and their sequences."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.models import sequential
    from predictionio_tpu_torch.parallel.ring import full_attention
    from predictionio_tpu_torch.testing import topk_mismatches

    cfg, imap = model.config, model.item_map
    # the live read takes the last maxLen events; recommend keeps the catalog's
    known = {u: np.asarray([imap[i] for i in items[-cfg.max_len:] if i in imap], np.int64)
             for u, items in histories.items()}
    users = [u for u in histories if len(known[u])]
    seqs = np.zeros((len(users), cfg.max_len), np.int64)
    for row, u in enumerate(users):
        seqs[row, -len(known[u]):] = known[u] + 1
    tree = model.bind(device).tree()
    seq_t = torch.from_numpy(seqs).to(device)
    with torch.no_grad():
        hidden, _ = sequential._block_stack(tree, seq_t, cfg, tree["pos"],
                                            lambda q, k, v: full_attention(q, k, v, causal=True))
        plain = (hidden[:, -1, :] @ tree["emb"][1:].T).cpu().numpy()
    row_of = {u: r for r, u in enumerate(users)}
    bad, gap = [], 0.0
    for u, a in answers:
        got = a["itemScores"]
        if u not in row_of:
            require(got == [], f"{u}: {got[:3]}")
            continue
        ref_i, ref_v = sequential.host_top_items(plain[row_of[u]], known[u], nums[u])
        got_i = np.array([[imap[x["item"]] for x in got]])
        got_v = np.array([[x["score"] for x in got]])
        require(not set(got_i[0].tolist()) & set(known[u].tolist()), f"{u}: a history item came back")
        bad += topk_mismatches(got_v, got_i, ref_v[None, :], ref_i[None, :], SAS_TOL)
        if len(got):
            gap = max(gap, float(np.abs(got_v[0] - plain[row_of[u], got_i[0]]).max()))
    require(not bad, f"served answers disagree with the plain forward: {bad[:3]}")
    return gap, plain, seq_t


def phase_sasrec_serving(seed, device):
    """A seeded SASRec at the paper's ML-1M width, published and served:
    every answer against the forward with the plain attention."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.data.bimap import BiMap
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import memory
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.models import sequential
    from predictionio_tpu_torch.ops import flash_attention as fa
    from predictionio_tpu_torch.serving.query_server import QueryServer
    from predictionio_tpu_torch.templates.sequentialrecommendation import (
        SequentialRecommendationEngine,
    )

    t0 = time.perf_counter()
    cfg = sequential.SASRecConfig(d_model=SAS_D, n_layers=SAS_LAYERS, n_heads=SAS_HEADS,
                                  max_len=SAS_MAX_LEN)
    model = sequential.SASRecModel(
        params=sequential.init_params(seed, cfg, SAS_ITEMS),
        item_map=BiMap({f"si{j}": j for j in range(SAS_ITEMS)}), config=cfg,
    )
    histories = sasrec_histories(seed)
    source = "CHIPSMOKESEQ"
    storage = Storage(env={
        f"PIO_STORAGE_SOURCES_{source}_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": source,
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": source,
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": source,
    })
    app_id = storage.get_meta_data_apps().insert(App(0, "ChipSmokeSeq"))
    events = [
        Event(event="view", entity_type="user", entity_id=u, target_entity_type="item",
              target_entity_id=f"si{int(i)}", event_time=1_767_225_600.0 + t)
        for u, items in histories.items() for t, i in enumerate(items)
    ]
    # a user whose every item lies outside the catalog: no sequence, no launch
    events += [Event(event="view", entity_type="user", entity_id="su_offcatalog",
                     target_entity_type="item", target_entity_id=f"x{t}",
                     event_time=1_767_225_600.0 + t) for t in range(5)]
    storage.get_l_events().insert_batch(events, app_id)
    engine = SequentialRecommendationEngine.apply()
    iid = publish(storage, engine, model, SAS_VARIANT, SAS_FACTORY)
    users = list(histories) + ["su_offcatalog", "su_ghost"]
    rng = np.random.default_rng(seed + 9)
    nums = {u: int(rng.integers(1, 101)) for u in users}
    store.set_storage(storage)
    out = {"phase": "sasrec-serving", "events": len(events), "users": len(users)}
    loops = []
    try:
        fa.launches.reset()  # the main path's window: both serving loops
        for batching in (False, True):
            qs = QueryServer(engine, storage=storage, ctx=DeviceContext.create(device=device),
                             batching=batching)
            try:
                net = qs._deployed.models[0]._net
                require(net is not None and net.device == torch.device(device),
                        "weights bound on the card at deploy")
                base = f"http://127.0.0.1:{qs.start('127.0.0.1', 0)}"

                def post(u):
                    req = urllib.request.Request(
                        f"{base}/queries.json", data=json.dumps({"user": u, "num": nums[u]}).encode(),
                        headers={"Content-Type": "application/json"},
                    )
                    with urllib.request.urlopen(req, timeout=60) as r:
                        return u, json.loads(r.read())

                def info():
                    with urllib.request.urlopen(f"{base}/", timeout=30) as r:
                        return json.loads(r.read())

                before = fa.launches.count
                t_loop = time.perf_counter()
                if batching:
                    # bursts of 8 queued behind a held batcher, so each leaves
                    # as one batch that the base batch_predict loops over
                    answers = []
                    with ThreadPoolExecutor(max_workers=8) as pool:
                        for b0 in range(0, len(users), 8):
                            burst = users[b0: b0 + 8]
                            with qs._batcher.held():
                                futs = [pool.submit(post, u) for u in burst]
                                t_hold = time.monotonic() + 20
                                while info()["inflight"] < len(burst) and time.monotonic() < t_hold:
                                    time.sleep(0.002)
                                time.sleep(0.02)  # the last arrivals reach the queue
                            answers += [f.result() for f in futs]
                else:  # one client, one query at a time
                    answers = [post(u) for u in users]
                loop_s = time.perf_counter() - t_loop
                served = info()
                loops.append({"batching": batching, "queries": len(answers), "loop_s": loop_s,
                              # this script's loop through HTTP and the memory
                              # event store (with the held bursts' waits when
                              # batching), not a benchmark
                              "script_qps": len(answers) / loop_s,
                              "launches": fa.launches.count - before,
                              "batch_sizes": (served["batching"] or {}).get("batch_sizes")})
                emit({"phase": "sasrec-serving-loop", **loops[-1]})
            finally:
                qs.stop()
            loops[-1]["answers"] = answers
        launches = fa.launches.count
        # where one query's time goes (after the window): the live history
        # read on the host, then recommend (the forward on the card, one copy
        # back, the host top-k), and the card's busy time within recommend
        algo = engine.make_algorithms(engine.params_from_variant(SAS_VARIANT))[0]
        model.bind(device)
        hist_ms, rec_ms = [], []
        for u in list(histories)[:20]:
            t = time.perf_counter()
            h = algo._history(u, SAS_MAX_LEN)
            hist_ms.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            model.recommend(h, nums[u])
            rec_ms.append((time.perf_counter() - t) * 1e3)
        per_kernel = device_us(lambda: model.recommend(h, 10))
        breakdown = {"history_ms": sorted(hist_ms)[10], "recommend_ms": sorted(rec_ms)[10],
                     "recommend_device_us": sum(per_kernel.values()),
                     "recommend_device_us_top": dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8])}
        emit({"phase": "sasrec-breakdown", **breakdown})
    finally:
        store.set_storage(None)
        memory.reset_store(source)
    n_with_items = sum(1 for u in users if u in histories)
    n_queries = sum(lp["queries"] for lp in loops)
    require(n_queries >= N_QUERIES, f"{n_queries} answers")
    require(launches == SAS_LAYERS * 2 * n_with_items,
            f"flash launches {launches} vs {SAS_LAYERS} layers × {2 * n_with_items} queries with catalog items")

    # every answer against the plain forward on the card, one batch
    ids = {u: [f"si{int(i)}" for i in items] for u, items in histories.items()}
    ids["su_offcatalog"] = [f"x{t}" for t in range(5)]
    answer_gap, plain, seq_t = hold_answers(
        model, device, ids, [a for lp in loops for a in lp["answers"]], nums)
    net = model.bind(device)
    with torch.no_grad():
        kernel = net(seq_t).cpu().numpy()  # the batch through the kernel, outside the window
    logit_gap = float(np.abs(kernel - plain).max())
    require(np.allclose(kernel, plain, rtol=SAS_TOL, atol=SAS_TOL),
            f"batched logits through the kernel vs plain: max |Δ| {logit_gap}")
    for lp in loops:
        del lp["answers"]
    out.update({"instance": iid, "setup_and_serve_s": time.perf_counter() - t0,
                "queries": n_queries, "queries_with_items": 2 * n_with_items,
                "launches": launches, "loops": loops, "breakdown": breakdown,
                "max_abs_err_answers": answer_gap,
                "max_abs_err_batched_logits": logit_gap, "tol": SAS_TOL, "ok": True})
    emit(out)
    return out


# -- SASRec training -----------------------------------------------------------

# MovieLens-1M's shape (Kang & McAuley §IV): 6,040 users, 3,416 items,
# 1,000,209 events, every user with at least 20; the paper's batch and lr.
ML1M_USERS, ML1M_EVENTS, ML1M_MIN_EVENTS = 6040, 1_000_209, 20
SAS_BATCH, SAS_LR, SAS_STEPS = 128, 1e-3, 100
# (B·H, T_q, T_kv, h) of the backward's timings: the training shape, a longer block
BWD_TIMED = ((128, 256, 256, 50), (8, 1024, 1024, 64))
BWD_RTOL, BWD_ATOL = 2e-4, 2e-5  # the JAX package's own gradient test


def flash_bwd_bounds(bh, t_q, t_kv, h, causal, dkv_on="tf32x3", dq_on="tf32x3"):
    """Least time of each backward kernel, (ms, "bytes" | "operations"):
    inputs read once and outputs written once (f32); kernel 5 (dq) makes
    three products of h multiply-adds over each visible pair (s, dp, ds·k),
    kernel 6 (dk, dv) four (s, dp, pᵀ·do, dsᵀ·q), each with one exponential
    a pair at the f32 rate. ``dq_on`` / ``dkv_on`` "tf32x3": the products on
    the tensor cores as three TF32 products each (the committed kernels);
    "f32": everything at the f32 rate outside the tensor cores (the bound of
    the earlier FMA kernels, for comparison)."""
    pairs = visible_pairs(t_q, t_kv, causal) * bh

    def t_ops(products, on):
        if on == "f32":
            return 2 * products * h * pairs / PEAK_F32_OPS_S
        return 2 * products * h * pairs / (PEAK_TF32_OPS_S / 3) + pairs / PEAK_F32_OPS_S

    out = {}
    for name, nbytes, t_op in (
        ("dq", 4 * bh * (3 * t_q * h + 2 * t_kv * h + 2 * t_q), t_ops(3, dq_on)),
        ("dkv", 4 * bh * (2 * t_q * h + 4 * t_kv * h + 2 * t_q), t_ops(4, dkv_on)),
    ):
        t_bytes = nbytes / PEAK_BYTES_S
        out[name] = (max(t_bytes, t_op) * 1e3, "bytes" if t_bytes >= t_op else "operations")
    return out


def ring_backward(q, k, v, o, lse, do, causal, n_blocks):
    """The ring backward's composition on one card: q and k/v cut into
    ``n_blocks`` blocks along T, block pair (i, j) causal on the diagonal,
    full below it and skipped above it under a causal mask, each pair fed
    the GLOBAL o and lse of its query block; the pieces summed."""
    import torch

    from predictionio_tpu_torch.ops import flash_attention as fa

    cut = q.shape[-2] // n_blocks
    blk = [slice(b * cut, (b + 1) * cut) for b in range(n_blocks)]
    dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
    for i, si in enumerate(blk):
        for j, sj in enumerate(blk):
            if causal and j > i:
                continue
            part = fa.flash_block_bwd(
                *(x[:, s].contiguous() for x, s in ((q, si), (k, sj), (v, sj), (o, si), (lse, si), (do, si))),
                causal and i == j)
            dq[:, si] += part[0]
            dk[:, sj] += part[1]
            dv[:, sj] += part[2]
    return dq, dk, dv


def bwd_excess(got, ref):
    """Largest |got - ref| past atol + rtol·|ref| (≤ 0 passes)."""
    return float(((got - ref).abs() - (BWD_ATOL + BWD_RTOL * ref.abs())).max())


def phase_sasrec_bwd_kernel(seed, device):
    """Kernels 5 and 6 against the plain backward (f32 and f64) at every
    FLASH_SHAPES shape, causal and not; the global-lse ring composition;
    times at BWD_TIMED."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from predictionio_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain products in full f32
    rng = np.random.default_rng(seed + 10)
    cases, worst, inputs = [], 0.0, {}
    for shape in FLASH_SHAPES:
        bh, t_q, t_kv, h = shape
        q, k, v, do = (torch.from_numpy(rng.standard_normal((bh, t, h)).astype(np.float32)).to(device)
                       for t in (t_q, t_kv, t_kv, t_q))
        for causal in (True, False):
            o, lse = fa.flash_attention_reference(q, k, v, causal)
            got = fa.flash_block_bwd(q, k, v, o, lse, do, causal)
            again = fa.flash_block_bwd(q, k, v, o, lse, do, causal)  # a relaunch: the same bytes
            ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
            exact = fa.flash_attention_bwd_reference(*(x.double() for x in (q, k, v, o, lse, do)), causal)
            torch.cuda.synchronize()
            what = f"flash backward {shape} causal={causal}"
            require(all(torch.equal(a, b) for a, b in zip(got, again)),
                    f"{what}: a relaunch gives other bytes")
            gap = {}
            for name, g, r, e in zip(("dq", "dk", "dv"), got, ref, exact):
                require(bool(torch.isfinite(g).all()), f"{what}: {name} finite")
                excess = bwd_excess(g, r)
                require(excess <= 0, f"{what}: {name} disagrees with the plain backward by {excess} past tolerance")
                gap[f"{name}_kernel_vs_plain"] = float((g - r).abs().max())
                gap[f"{name}_kernel_vs_f64"] = float((g.double() - e).abs().max())
                gap[f"{name}_plain_vs_f64"] = float((r.double() - e).abs().max())
                worst = max(worst, gap[f"{name}_kernel_vs_plain"])
            cases.append({"shape": list(shape), "causal": causal, **gap})
            if causal and shape in BWD_TIMED:
                inputs[shape] = (q, k, v, o, lse, do)
    emit({"phase": "sasrec-bwd-kernel", "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cases": cases, "max_abs_err": worst, "rtol": BWD_RTOL, "atol": BWD_ATOL,
          # the largest gap to float64 over the cases, kernel beside the plain version
          "vs_f64": {name: {"kernel": max(c[f"{name}_kernel_vs_f64"] for c in cases),
                            "plain": max(c[f"{name}_plain_vs_f64"] for c in cases)}
                     for name in ("dq", "dk", "dv")},
          "relaunch_identical": True, "ok": True})

    # the ring's composition: block pairs fed the whole forward's o and lse
    ring = []
    for shape, n_blocks in ((BWD_TIMED[0], 2), (BWD_TIMED[1], 4)):
        bh, t_q, t_kv, h = shape
        q, k, v, do = (torch.from_numpy(rng.standard_normal((bh, t, h)).astype(np.float32)).to(device)
                       for t in (t_q, t_kv, t_kv, t_q))
        for causal in (True, False):
            o, lse = fa.flash_block_fwd(q, k, v, causal)
            whole = fa.flash_block_bwd(q, k, v, o, lse, do, causal)
            parts = ring_backward(q, k, v, o, lse, do, causal, n_blocks)
            torch.cuda.synchronize()
            excess = max(bwd_excess(p, w) for p, w in zip(parts, whole))
            require(excess <= 0, f"ring backward {shape} / {n_blocks} blocks causal={causal}: "
                                 f"{excess} past tolerance of the whole backward")
            ring.append({"shape": list(shape), "blocks": n_blocks, "causal": causal,
                         "max_abs_diff": max(float((p - w).abs().max()) for p, w in zip(parts, whole))})
    emit({"phase": "sasrec-bwd-ring", "cases": ring, "ok": True})

    rows = []
    for shape in BWD_TIMED:
        bh, t_q, t_kv, h = shape
        q, k, v, o, lse, do = inputs[shape]
        scale = fa._f32(1.0 / h ** 0.5)
        delta = (do * o).sum(-1)
        q4, k4, v4 = (x[:, None].detach().requires_grad_() for x in (q, k, v))
        do4 = do[:, None]

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
            return torch.autograd.grad(out, (q4, k4, v4), do4)

        sdpa_out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        bounds = flash_bwd_bounds(bh, t_q, t_kv, h, True)
        dev = device_us(lambda: fa.flash_block_bwd(q, k, v, o, lse, do, True))
        row = {
            "shape": list(shape), "causal": True,
            "dq_ms": cuda_ms(lambda: fa._launch_bwd_dq(q, k, v, do, lse, delta, True, scale), 100),
            "dkv_ms": cuda_ms(lambda: fa._launch_bwd_dkv(q, k, v, do, lse, delta, True, scale), 100),
            "dq_device_us": dev.get("flash_bwd_dq_kernel"),
            "dkv_device_us": dev.get("flash_bwd_dkv_kernel"),
            "backward_ms": cuda_ms(lambda: fa.flash_block_bwd(q, k, v, o, lse, do, True), 100),
            "backward_device_us": dev,
            # the plain backward and SDPA's each compute dq, dk and dv at once
            "plain_ms": cuda_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, o, lse, do, True), 20),
            "library_ms": cuda_ms(lambda: torch.autograd.grad(sdpa_out, (q4, k4, v4), do4,
                                                             retain_graph=True), 100),
            "library_backend": sdpa_backend(sdpa_fwd_bwd),
            "dq_bound_ms": bounds["dq"][0], "dq_bound_by": bounds["dq"][1],
            "dkv_bound_ms": bounds["dkv"][0], "dkv_bound_by": bounds["dkv"][1],
            "dq_bound_f32_ms": flash_bwd_bounds(bh, t_q, t_kv, h, True, dq_on="f32")["dq"][0],
            "dkv_bound_f32_ms": flash_bwd_bounds(bh, t_q, t_kv, h, True, dkv_on="f32")["dkv"][0],
            "dq_plan": dict(zip(("q_rows", "blocks"), fa.dq_plan(bh, t_q, h, fa._sm_count(q.device.index)))),
        }
        rows.append(row)
        emit({"phase": "sasrec-bwd-time", **row})
    return rows, worst


def ml1m_interactions(seed):
    """Interactions in MovieLens-1M's shape: ML1M_EVENTS view events of
    ML1M_USERS users over SAS_ITEMS items, every user at least
    ML1M_MIN_EVENTS (the rest spread log-normally, ~165 on average), items
    Zipf-Mandelbrot (s = 1.1, q = 50), times increasing along each history."""
    import numpy as np

    from predictionio_tpu_torch.data.batch import interactions_from_arrays

    rng = np.random.default_rng(seed + 11)
    spread = ML1M_EVENTS - ML1M_MIN_EVENTS * ML1M_USERS
    w = rng.lognormal(0.0, 1.0, ML1M_USERS)
    extra = np.floor(w / w.sum() * spread).astype(np.int64)
    extra[rng.choice(ML1M_USERS, spread - int(extra.sum()), replace=False)] += 1
    lengths = ML1M_MIN_EVENTS + extra
    user = np.repeat(np.arange(ML1M_USERS), lengths)
    item = rng.choice(SAS_ITEMS, size=len(user), p=zipf_mandelbrot_weights(SAS_ITEMS, 1.1))
    t = np.arange(len(user)) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    inter = interactions_from_arrays(
        user, item, np.ones(len(user)), 1_767_225_600.0 + t,
        (f"u{i}" for i in range(ML1M_USERS)), (f"si{j}" for j in range(SAS_ITEMS)))
    return inter, lengths


def flash_counts():
    from predictionio_tpu_torch.ops import flash_attention as fa

    return {"fwd": fa.launches.count, "bwd_dq": fa.bwd_dq_launches.count,
            "bwd_dkv": fa.bwd_dkv_launches.count}


def reset_flash_counts():
    from predictionio_tpu_torch.ops import flash_attention as fa

    for c in (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches):
        c.reset()


def phase_sasrec_train(seed, device):
    """The training main path at full width: train_sasrec, 100 steps."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.models import sequential

    t0 = time.perf_counter()
    inter, lengths = ml1m_interactions(seed)
    data_s = time.perf_counter() - t0
    cfg = sequential.SASRecConfig(d_model=SAS_D, n_layers=SAS_LAYERS, n_heads=SAS_HEADS,
                                  max_len=SAS_MAX_LEN, epochs=SAS_STEPS, batch_size=SAS_BATCH,
                                  lr=SAS_LR, seed=seed)
    ctx = DeviceContext.create(device=device)
    torch.cuda.synchronize()
    reset_flash_counts()  # the main path's window: counts read just before and just after
    t0 = time.perf_counter()
    model = sequential.train_sasrec(ctx, inter, cfg)
    train_s = time.perf_counter() - t0
    counts = flash_counts()
    want = SAS_LAYERS * SAS_STEPS
    require(counts == {"fwd": want, "bwd_dq": want, "bwd_dkv": want},
            f"flash launches {counts} vs {SAS_LAYERS} layers × {SAS_STEPS} steps each")
    leaves = [model.params["emb"], model.params["pos"]] + [
        a for layer in model.params["layers"] for a in layer.values()]
    require(all(bool(np.isfinite(a).all()) for a in leaves), "finite params")
    losses = model.losses
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    require(np.isfinite(losses).all() and last < first,
            f"mean loss of the last 10 steps {last} vs the first 10 {first}")

    # the same step (sequential.train_step) timed on its own, and its
    # device time by kernel, after the window
    seqs = sequential.training_sequences(inter, cfg)
    rows = torch.from_numpy(seqs.astype(np.int64)).to(device)
    net = sequential.SASRecNet(model.params, cfg, device, trainable=True)
    opt = sequential.adam(net, cfg)
    rng = np.random.default_rng(seed + 12)

    def step():
        picks = torch.from_numpy(rng.integers(0, len(seqs), SAS_BATCH)).to(device)
        return sequential.train_step(net, opt, rows[picks], cfg)

    step_s = []
    for _ in range(11):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    median = float(np.median(step_s[1:]))
    per_kernel = device_us(step, 3)
    busy_us = sum(per_kernel.values())
    tokens = SAS_BATCH * SAS_MAX_LEN
    out = {"phase": "sasrec-train", "users": ML1M_USERS, "items": SAS_ITEMS, "events": len(inter),
           "events_per_user": {"min": int(lengths.min()), "median": float(np.median(lengths)),
                               "mean": float(lengths.mean()), "max": int(lengths.max())},
           "trainable_sequences": len(seqs), "data_s": data_s,
           "steps": SAS_STEPS, "batch": SAS_BATCH, "launches": counts,
           "train_sasrec_s": train_s, "loss_first10": first, "loss_last10": last,
           "losses": [float(x) for x in losses],
           "step_s_median": median, "step_s": step_s,
           "sequences_per_s": SAS_BATCH / median, "tokens_per_s": tokens / median,
           "step_device_us_total": busy_us,
           "step_idle_share": 1.0 - busy_us * 1e-6 / median,
           "step_device_us_top": dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])[:14]),
           "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9, "ok": True}
    emit(out)
    return out


def param_leaves(params):
    """(name, array) pairs of a host param tree, in one order."""
    out = [("emb", params["emb"]), ("pos", params["pos"])]
    for n, layer in enumerate(params["layers"]):
        out += [(f"layers.{n}.{k}", layer[k]) for k in sorted(layer)]
    return out


ADAM_FLOOR = 1e-6  # √v̂ below this (100 × Adam's eps): the update is set by rounding


class ReluDecisions:
    """Within ``with``, ``torch.relu`` records each call's pre-activations
    (``record``) and, given the masks of another run in call order
    (``replay``), applies those masks in place of this device's own signs.
    The FFN's ReLU is the model's only branch on a float value besides the
    MoE's argmax; a pre-activation within rounding of zero takes opposite
    branches on two devices, and the step's gradients then differ by that
    unit's share."""

    def __init__(self, replay=None):
        self.record, self.replay = [], replay

    def __enter__(self):
        import torch

        self._real, masks = torch.relu, iter(self.replay or ())

        def relu(x):
            self.record.append(x.detach())
            if self.replay is None:
                return self._real(x)
            return x * next(masks).to(device=x.device, dtype=x.dtype)

        torch.relu = relu
        return self

    def __exit__(self, *exc):
        import torch

        torch.relu = self._real


def phase_sasrec_train_parity(seed, device):
    """A small draw trained on the card (kernels) and on the CPU (dense
    attention, autograd) from one start, dense and with 4 experts.

    Step by step, the CPU starts each of the 5 steps from the card's params
    and Adam moments and takes the card's ReLU branches (ReluDecisions); a
    float64 copy of the CPU model computes the same gradients as the arbiter
    of which side owns a gap. Held at every step: gradients and Adam moments
    entry by entry within rtol 1e-4 plus 1e-6 of the leaf's largest value,
    and the updated params within rtol = atol = 1e-4, except entries whose
    √v̂ is below ADAM_FLOOR (there lr·m̂/(√v̂ + eps) turns on the rounding of
    a near-zero gradient: listed with their |g| and held within lr). The
    ReLU pre-activations the two devices round to opposite sides of zero are
    counted and reported.

    Free-running (``train_sasrec`` on each device, each taking its own
    branches): every step's loss within rtol 1e-5; the params' gap is
    reported, not held: a flipped branch and the Adam floor leave gaps that
    Adam's normalized steps carry into every param (ROADMAP §3, PERF.md §6
    PR 4).
    """
    import numpy as np
    import torch

    from predictionio_tpu_torch.data.batch import interactions_from_arrays
    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.models import sequential

    n_users, n_items = 64, 400
    rng = np.random.default_rng(seed + 13)
    lengths = rng.integers(2, 400, n_users)
    user = np.repeat(np.arange(n_users), lengths)
    item = rng.choice(n_items, size=len(user), p=zipf_mandelbrot_weights(n_items, 1.1))
    t = np.arange(len(user)) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    inter = interactions_from_arrays(user, item, np.ones(len(user)), t.astype(np.float64),
                                     (f"u{i}" for i in range(n_users)), (f"i{j}" for j in range(n_items)))
    card, host = DeviceContext.create(device=device), DeviceContext.create(device="cpu")

    def entrywise(got, want):  # largest excess past rtol 1e-4 + 1e-6·max|want| (≤ 0 passes)
        return float((np.abs(got - want) - (1e-4 * np.abs(want) + 1e-6 * np.abs(want).max())).max())

    results = []
    for n_experts in (0, 4):
        cfg = sequential.SASRecConfig(d_model=SAS_D, n_layers=SAS_LAYERS, n_heads=SAS_HEADS,
                                      max_len=SAS_MAX_LEN, epochs=5, batch_size=32, lr=SAS_LR,
                                      seed=seed, n_experts=n_experts)
        start = sequential.init_params(seed + 14, cfg, n_items)
        what = f"n_experts={n_experts}"

        # step by step: the CPU (and its float64 copy) start each step from the
        # card's state and take the card's ReLU branches
        seqs = sequential.training_sequences(inter, cfg)
        cnet = sequential.SASRecNet(start, cfg, device, trainable=True)
        hnet = sequential.SASRecNet(start, cfg, "cpu", trainable=True)
        xnet = sequential.SASRecNet(start, cfg, "cpu", trainable=True).double()
        copt, hopt = sequential.adam(cnet, cfg), sequential.adam(hnet, cfg)
        sampler = np.random.default_rng(cfg.seed)
        steps = []
        for step in range(1, cfg.epochs + 1):
            rows = torch.from_numpy(seqs[sampler.integers(0, len(seqs), min(cfg.batch_size, len(seqs)))]
                                    .astype(np.int64))
            with torch.no_grad():
                for cp, hp, xp in zip(cnet.parameters(), hnet.parameters(), xnet.parameters()):
                    hp.copy_(cp.cpu())
                    xp.copy_(cp.cpu().double())
                    if cp in copt.state:
                        hopt.state[hp] = {k: v.detach().cpu().clone() for k, v in copt.state[cp].items()}
            with ReluDecisions() as on_card:
                sequential.train_step(cnet, copt, rows.to(device), cfg)
            masks = [z > 0 for z in on_card.record]
            with ReluDecisions(replay=masks) as on_host:
                sequential.train_step(hnet, hopt, rows, cfg)
            with ReluDecisions(replay=masks):
                xnet.zero_grad()
                sequential._loss_fn(xnet.tree(), rows, cfg).backward()
            flips = [(zc.cpu() > 0) != (zh > 0) for zc, zh in zip(on_card.record, on_host.record)]
            row = {"step": step, "relu_flips": int(sum(int(f.sum()) for f in flips)),
                   "relu_flip_abs_preactivation": [float(zh[f].abs().max()) for zh, f in
                                                   zip(on_host.record, flips) if f.any()],
                   "grad": -np.inf, "moments": -np.inf, "params": -np.inf, "worst_grad": None,
                   "floor_entries": [], "floor_max_abs_diff": 0.0}
            for (name, cp), hp, xp in zip(cnet.named_parameters(), hnet.parameters(), xnet.parameters()):
                g_c, g_h, g_x = cp.grad.cpu().numpy(), hp.grad.numpy(), xp.grad.numpy()
                row["grad"] = max(row["grad"], entrywise(g_c, g_h))
                gap = np.abs(g_c - g_h)
                j = np.unravel_index(int(np.argmax(gap)), gap.shape)
                if row["worst_grad"] is None or gap[j] > row["worst_grad"]["abs_diff"]:
                    row["worst_grad"] = {"leaf": name, "index": [int(x) for x in j], "abs_diff": float(gap[j]),
                                         "card": float(g_c[j]), "cpu": float(g_h[j]), "cpu_f64": float(g_x[j]),
                                         "leaf_card_vs_f64": float(np.abs(g_c - g_x).max()),
                                         "leaf_cpu_vs_f64": float(np.abs(g_h - g_x).max())}
                cs, hs = copt.state[cp], hopt.state[hp]
                for key in ("exp_avg", "exp_avg_sq"):
                    row["moments"] = max(row["moments"], entrywise(cs[key].cpu().numpy(), hs[key].numpy()))
                floor = np.sqrt(hs["exp_avg_sq"].numpy() / (1 - 0.999 ** step)) < ADAM_FLOOR
                p_c, p_h = cp.detach().cpu().numpy(), hp.detach().numpy()
                gap = np.abs(p_c - p_h)
                over = gap > 1e-4 + 1e-4 * np.abs(p_h)
                row["params"] = max(row["params"], float((gap - (1e-4 + 1e-4 * np.abs(p_h)))[~floor].max(initial=-1.0)))
                for j in zip(*np.nonzero(floor & over)):
                    row["floor_entries"].append({"leaf": name, "index": [int(x) for x in j],
                                                 "abs_diff": float(gap[j]), "cpu_abs_grad": float(abs(g_h[j])),
                                                 "card_abs_grad": float(abs(g_c[j]))})
                if floor.any():
                    row["floor_max_abs_diff"] = max(row["floor_max_abs_diff"], float(gap[floor].max()))
            steps.append(row)
            for key in ("grad", "moments", "params"):
                require(row[key] <= 0, f"{what} step {step}: {key} past tolerance: {row}")
            require(row["floor_max_abs_diff"] <= cfg.lr,
                    f"{what} step {step}: an entry under the Adam floor moved apart by more than lr: {row}")

        # free-running: train_sasrec on each device
        before = flash_counts()
        on_card = sequential.train_sasrec(card, inter, cfg, init_params=start)
        after = flash_counts()
        require(after["bwd_dq"] - before["bwd_dq"] == SAS_LAYERS * cfg.epochs
                and after["bwd_dkv"] - before["bwd_dkv"] == SAS_LAYERS * cfg.epochs,
                f"{what}: the card's training ran the backward kernels ({before} → {after})")
        on_host = sequential.train_sasrec(host, inter, cfg, init_params=start)
        require(np.allclose(on_card.losses, on_host.losses, rtol=1e-5, atol=0),
                f"{what}: losses {on_card.losses} vs {on_host.losses}")
        free_gap = [(float(np.abs(a - b).max()), name) for (name, a), (_, b) in
                    zip(param_leaves(on_card.params), param_leaves(on_host.params))]
        results.append({
            "n_experts": n_experts, "steps": cfg.epochs, "step_by_step": steps,
            "free_loss_max_rel_diff": float(np.abs(on_card.losses - on_host.losses).max()
                                            / np.abs(on_host.losses).min()),
            "free_param_max_abs_diff": max(free_gap),
        })
    emit({"phase": "sasrec-train-parity", "cases": results, "adam_floor": ADAM_FLOOR, "ok": True})


def phase_sasrec_train_workflow(seed, device):
    """View events in MEMORY storage → run_train on the card → COMPLETED →
    QueryServer → 20 answers held against the plain forward."""
    import numpy as np

    from predictionio_tpu_torch.core import workflow
    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import memory
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.serving.query_server import QueryServer
    from predictionio_tpu_torch.templates.sequentialrecommendation import (
        SequentialRecommendationEngine,
    )

    app, epochs = "ChipSmokeSeqTrain", 20
    source = "CHIPSMOKESEQTRAIN"
    storage = Storage(env={
        f"PIO_STORAGE_SOURCES_{source}_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": source,
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": source,
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": source,
    })
    rng = np.random.default_rng(seed + 15)
    weights = zipf_mandelbrot_weights(1000, 1.1)
    histories = {f"wu{u}": [f"wi{int(i)}" for i in rng.choice(1000, int(rng.integers(20, 301)), p=weights)]
                 for u in range(300)}
    app_id = storage.get_meta_data_apps().insert(App(0, app))
    events = [Event(event="view", entity_type="user", entity_id=u, target_entity_type="item",
                    target_entity_id=i, event_time=1_767_225_600.0 + t)
              for u, items in histories.items() for t, i in enumerate(items)]
    storage.get_l_events().insert_batch(events, app_id)
    engine = SequentialRecommendationEngine.apply()
    variant = {
        "datasource": {"params": {"appName": app, "eventNames": ["view"]}},
        "algorithms": [{"name": "sasrec", "params": {
            "appName": app, "eventNames": ["view"], "dModel": SAS_D, "numLayers": SAS_LAYERS,
            "numHeads": SAS_HEADS, "maxLen": SAS_MAX_LEN, "epochs": epochs,
            "batchSize": SAS_BATCH, "lr": SAS_LR, "seed": seed}}],
    }
    ctx = DeviceContext.create(device=device)
    store.set_storage(storage)
    try:
        reset_flash_counts()  # the path's window
        t0 = time.perf_counter()
        iid = workflow.run_train(engine, engine.params_from_variant(variant), SAS_FACTORY,
                                 storage=storage, ctx=ctx)
        train_s = time.perf_counter() - t0
        counts = flash_counts()
        inst = storage.get_meta_data_engine_instances().get(iid)
        require(inst.status == "COMPLETED", f"run_train instance status {inst.status}")
        want = SAS_LAYERS * epochs
        require(counts == {"fwd": want, "bwd_dq": want, "bwd_dkv": want},
                f"run_train flash launches {counts} vs {SAS_LAYERS} layers × {epochs} epochs")
        qs = QueryServer(engine, storage=storage, ctx=ctx, batching=False)
        try:
            base = f"http://127.0.0.1:{qs.start('127.0.0.1', 0)}"
            users = list(histories)[:20]
            nums = {u: int(rng.integers(1, 51)) for u in users}

            def post(u):
                req = urllib.request.Request(
                    f"{base}/queries.json", data=json.dumps({"user": u, "num": nums[u]}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as r:
                    return u, json.loads(r.read())

            answers = [post(u) for u in users]
            model = qs._deployed.models[0]
        finally:
            qs.stop()
        gap, _, _ = hold_answers(model, device, {u: histories[u] for u in users}, answers, nums)
        require(all(len(a["itemScores"]) == nums[u] for u, a in answers), "every query answered in full")
    finally:
        store.set_storage(None)
        memory.reset_store(source)
    out = {"phase": "sasrec-train-workflow", "events": len(events), "users": len(histories),
           "instance": iid, "status": inst.status, "epochs": epochs, "launches": counts,
           "run_train_s": train_s, "queries": len(answers), "max_abs_err_answers": gap,
           "tol": SAS_TOL, "ok": True}
    emit(out)
    return out


# -- the quickstart through the port's CLI -------------------------------------

CLI = [sys.executable, "-m", "predictionio_tpu_torch.tools.cli"]
QS_APP, QS_SEQ_APP = "QuickstartML", "QuickstartSeq"
QS_BUY_EVERY = 20  # 1 in 20 events is a buy, the rest rate 1-5
QS_BATCHES, QS_SINGLES = 40, 100  # events through the event server: 40 × 50, then 100 alone
QS_BULK, QS_BULK_CHUNK = 100_000, 50_000  # bulk-loaded events (of the ML-1M draw), a chunk
QS_SINGLE_QUERIES = 1000  # one at a time: p99 with 10 samples beyond it
QS_BURSTS = ((8, 8), (64, 4))  # (concurrent queries, bursts)
QS_SAS_STEPS = 30


def cli_run(*argv) -> str:
    """``pio <argv>`` in this process (so the kernels' counters see its
    launches); its standard output, and a failed check unless it exits 0."""
    import contextlib
    import io

    from predictionio_tpu_torch.tools import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    out = buf.getvalue()
    require(rc == 0, f"pio {' '.join(argv)} exited {rc}: {out}")
    return out


def http_json(url, body=None, method=None, timeout=60):
    """(status, JSON body) of one request, error statuses included."""
    import urllib.error

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class CliServer:
    """``pio <argv>`` as a real subprocess serving on 127.0.0.1:port; its
    standard error goes to a log the checks quote."""

    def __init__(self, tmp, name, *argv):
        self.port = free_port()
        self.base = f"http://127.0.0.1:{self.port}"
        self.log = os.path.join(tmp, f"{name}.log")
        env = dict(os.environ, PYTHONPATH=ROOT)
        self.t_spawn = time.perf_counter()
        with open(self.log, "w") as log:
            self.proc = subprocess.Popen(
                CLI + list(argv) + ["--ip", "127.0.0.1", "--port", str(self.port)],
                cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=log)

    def tail(self) -> str:
        with open(self.log) as f:
            return f.read()[-2000:]

    def wait_ready(self, deadline_s=300) -> float:
        """Seconds from the spawn to the first 200 on /readyz."""
        t_end = time.monotonic() + deadline_s
        while time.monotonic() < t_end:
            require(self.proc.poll() is None, f"{self.log} exited {self.proc.returncode}: {self.tail()}")
            try:
                with urllib.request.urlopen(f"{self.base}/readyz", timeout=5) as r:
                    if r.status == 200:
                        return time.perf_counter() - self.t_spawn
            except OSError:
                pass
            time.sleep(0.02)
        raise RuntimeError(f"check failed: {self.base}/readyz never answered 200: {self.tail()}")

    def wait_exit(self, timeout=60) -> None:
        rc = self.proc.wait(timeout=timeout)
        require(rc == 0, f"{self.log} exited {rc}: {self.tail()}")

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def post_batches(base, key, events):
    """POST ``events`` to /batch/events.json in requests of 50; every item
    must be written."""
    for b in range(0, len(events), 50):
        status, body = http_json(f"{base}/batch/events.json?accessKey={key}", events[b:b + 50])
        require(status == 200 and all(x["status"] == 201 for x in body),
                f"batch {b // 50}: {status} {str(body)[:300]}")


def fill_engine_json(path, app, algorithms, **datasource):
    with open(path) as f:
        variant = json.load(f)
    variant["datasource"]["params"] = {"appName": app, **datasource}
    variant["algorithms"] = algorithms
    with open(path, "w") as f:
        json.dump(variant, f, indent=2)
    return variant


def phase_quickstart_cli(seed, device):
    """The reference quickstart through ``python -m predictionio_tpu_torch.
    tools.cli`` on the card, on the zero-config sqlite store of a fresh
    ``PIO_FS_BASEDIR``: see the module docstring, phase 12."""
    import re
    import shutil
    import socket
    import tempfile

    import numpy as np
    import torch

    from predictionio_tpu_torch.core import workflow
    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import sqlite
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.ops import train_kernel
    from predictionio_tpu_torch.templates.recommendation import (
        RecommendationEngine,
        _merge_part_reads,
    )
    from predictionio_tpu_torch.templates.sequentialrecommendation import (
        SequentialRecommendationEngine,
    )
    from predictionio_tpu_torch.testing import topk_mismatches

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="pio-quickstart-")
    saved = {k: v for k, v in os.environ.items()
             if k.startswith("PIO_STORAGE_") or k in ("PIO_FS_BASEDIR", "PIO_ALS_SOLVER")}
    for k in saved:
        del os.environ[k]
    os.environ["PIO_FS_BASEDIR"] = os.path.join(tmp, "base")
    Storage.reset_instance()
    store.set_storage(None)
    servers = []
    ctx = DeviceContext.create(device=device)
    key_of = re.compile(r"Access Key: (\S+)")
    out = {"phase": "quickstart-cli"}
    try:
        # 1. storage and apps
        status = cli_run("status")
        require(status.count("(type sqlite)") == 3 and "all ready to go" in status, status)
        key = key_of.search(cli_run("app", "new", QS_APP)).group(1)
        rate_key = key_of.search(cli_run("accesskey", "new", QS_APP, "rate")).group(1)
        storage = Storage.instance()
        require(isinstance(storage.get_l_events(), sqlite.SqliteLEvents), "zero-config sqlite events")
        app_id = storage.get_meta_data_apps().get_by_name(QS_APP).id

        # 2a. the bulk load (the role of `pio import`) through insert_batch,
        # of a random QS_BULK of the ML-1M draw: on an H100 host the full
        # draw loaded at ~94 µs a row and each `pio train` read it back at
        # ~43 µs a row, 275 s for the phase
        inter, _ = ml1m_interactions(seed)
        rng = np.random.default_rng(seed + 21)
        pick = np.sort(rng.choice(len(inter.user), QS_BULK, replace=False))
        b_user, b_item, b_t = inter.user[pick], inter.item[pick], inter.t[pick]
        emit({"phase": "quickstart-cli", "step": "cut", "bulk_events": QS_BULK,
              "of_ml1m_draw": len(inter.user), "users": len(np.unique(b_user)),
              "items": len(np.unique(b_item)),
              "reason": "ML-100K scale: the full draw's bulk load and its reads by "
                        "pio train took 275 s, most of the run's time"})
        del inter
        n_bulk = QS_BULK
        buy = rng.integers(0, QS_BUY_EVERY, n_bulk) == 0
        stars = rng.integers(1, 6, n_bulk)
        le = storage.get_l_events()
        t0 = time.perf_counter()
        for c in range(0, n_bulk, QS_BULK_CHUNK):
            le.insert_batch([
                Event(event="buy" if buy[k] else "rate", entity_type="user",
                      entity_id=f"u{b_user[k]}", target_entity_type="item",
                      target_entity_id=f"si{b_item[k]}",
                      properties=None if buy[k] else {"rating": int(stars[k])},
                      event_time=float(b_t[k]), creation_time=float(b_t[k]))
                for k in range(c, min(c + QS_BULK_CHUNK, n_bulk))], app_id)
        bulk_s = time.perf_counter() - t0

        # 2b. more events through the event server, a real subprocess
        es = CliServer(tmp, "eventserver", "eventserver", "--stats")
        servers.append(es)
        es.wait_ready()
        weights = zipf_mandelbrot_weights(SAS_ITEMS, 1.1)
        n_more = QS_BATCHES * 50 + QS_SINGLES
        more = [{"event": "buy", "entityType": "user", "entityId": f"u{int(u)}",
                 "targetEntityType": "item", "targetEntityId": f"si{int(i)}",
                 "eventTime": 1_767_225_600 + 10_000_000 + k}
                if k % QS_BUY_EVERY == 0 else
                {"event": "rate", "entityType": "user", "entityId": f"u{int(u)}",
                 "targetEntityType": "item", "targetEntityId": f"si{int(i)}",
                 "properties": {"rating": int(r)}, "eventTime": 1_767_225_600 + 10_000_000 + k}
                for k, (u, i, r) in enumerate(zip(rng.integers(0, ML1M_USERS, n_more),
                                                  rng.choice(SAS_ITEMS, n_more, p=weights),
                                                  rng.integers(1, 6, n_more)))]
        t0 = time.perf_counter()
        post_batches(es.base, key, more[:QS_BATCHES * 50])
        batch_s = time.perf_counter() - t0
        singles = []
        t0 = time.perf_counter()
        for d in more[QS_BATCHES * 50:]:
            status, body = http_json(f"{es.base}/events.json?accessKey={key}", d)
            require(status == 201 and len(body["eventId"]) == 32, f"single POST {status} {body}")
            singles.append(body["eventId"])
        single_s = time.perf_counter() - t0
        status, body = http_json(f"{es.base}/batch/events.json?accessKey={key}", more[:51])
        require(status == 400 and "less than or equal to 50" in body["message"], f"batch of 51: {status} {body}")
        status, body = http_json(f"{es.base}/events.json?accessKey={rate_key}", more[0])
        require(status == 403 and body == {"message": "buy events are not allowed"},
                f"buy under the rate-only key: {status} {body}")
        user = more[QS_BATCHES * 50]["entityId"]
        status, found = http_json(
            f"{es.base}/events.json?accessKey={key}&entityType=user&entityId={user}&reversed=true&limit=5")
        times = [e["eventTime"] for e in found] if status == 200 else []
        require(status == 200 and 1 <= len(found) <= 5 and times == sorted(times, reverse=True)
                and all(e["entityId"] == user for e in found), f"filtered GET {status} {found}")
        eid = singles[0]
        status, got = http_json(f"{es.base}/events/{eid}.json?accessKey={key}")
        require(status == 200 and got["eventId"] == eid, f"GET by id {status} {got}")
        require(http_json(f"{es.base}/events/{eid}.json?accessKey={key}", method="DELETE")
                == (200, {"message": "Found"}), "DELETE by id")
        require(http_json(f"{es.base}/events/{eid}.json?accessKey={key}")[0] == 404, "deleted")
        status, stats = http_json(f"{es.base}/stats.json?accessKey={key}")
        counts = {(s["event"], s["status"]): s["count"] for s in stats["statusCount"]}
        want = {("rate", 201): sum(d["event"] == "rate" for d in more),
                ("buy", 201): sum(d["event"] == "buy" for d in more), ("buy", 403): 1}
        require(counts == want, f"/stats.json {counts} vs {want}")
        require(http_json(f"{es.base}/stop", method="POST")[0] == 202, "POST /stop")
        es.wait_exit()
        n_events = n_bulk + n_more - 1
        out["events"] = {"bulk": n_bulk, "bulk_insert_s": bulk_s, "bulk_rows_per_s": n_bulk / bulk_s,
                         "server_batches": QS_BATCHES, "server_batch_s": batch_s,
                         "server_singles": QS_SINGLES, "server_single_s": single_s,
                         "stored": n_events}
        emit({"phase": "quickstart-cli", "step": "events", **out["events"]})

        # 3. train: dense (the default) in this process, then the segment solver
        eng = os.path.join(tmp, "recommendation")
        cli_run("template", "get", "recommendation", "--directory", eng)
        variant = fill_engine_json(os.path.join(eng, "engine.json"), QS_APP, [
            {"name": "als", "params": {"rank": RANK, "numIterations": TRAIN_ITERS}}])
        cli_run("build", "--engine-dir", eng)
        read_s, reads = [], []
        find_interactions = sqlite.SqlitePEvents.find_interactions

        def timed_read(self, *a, **kw):
            t = time.perf_counter()
            try:
                reads.append(find_interactions(self, *a, **kw))
                return reads[-1]
            finally:
                read_s.append(time.perf_counter() - t)

        sqlite.SqlitePEvents.find_interactions = timed_read
        try:
            train_kernel.launches.reset()  # the path's window
            t0 = time.perf_counter()
            trained = cli_run("train", "--engine-dir", eng, "--device", device.type)
            train_s = time.perf_counter() - t0
            launches = train_kernel.launches.count
        finally:
            sqlite.SqlitePEvents.find_interactions = find_interactions
        iid = re.search(r"Engine instance ID: (\S+)", trained).group(1)
        engine = RecommendationEngine.apply()
        inst = storage.get_meta_data_engine_instances().get(iid)
        require(inst.status == "COMPLETED", f"pio train instance {inst.status}")
        _, _, _, models = workflow.prepare_deploy(engine, inst, storage=storage, ctx=ctx)
        model = models[0]
        # what pio train's sqlite reads returned, merged as the data source
        # merges them, then train_als on the card from the same seed
        read = _merge_part_reads(lambda r: r, reads)
        cfg = engine.make_algorithms(engine.params_from_variant(variant))[0]._config()
        ub, ib, _, _ = als._dense_blocks_for(read, cfg)
        n_buckets = len(ub.widths) + len(ib.widths)
        require(launches == n_buckets * TRAIN_ITERS,
                f"pio train: kernel 2 launched {launches} times vs {n_buckets} buckets × {TRAIN_ITERS}")
        require(len(read) == n_events, f"{len(read)} ratings read vs {n_events}")
        ref = als.train_als(ctx, read, cfg)
        gaps = [float(np.abs(a - b).max()) for a, b in ((model.user_factors, ref.user_factors),
                                                         (model.item_factors, ref.item_factors))]
        bit_equal = all(np.array_equal(a, b) for a, b in ((model.user_factors, ref.user_factors),
                                                           (model.item_factors, ref.item_factors)))
        require(bit_equal and model.user_map.inverse[0] == ref.user_map.inverse[0],
                f"pio train's factors vs train_als on the same read: largest gaps {gaps}")
        out["train"] = {"instance": iid, "ratings": len(read), "buckets": n_buckets,
                        "iterations": TRAIN_ITERS, "launches": launches, "wall_s": train_s,
                        "sqlite_read_s": sum(read_s), "sqlite_reads": len(read_s),
                        "sqlite_read_share": sum(read_s) / train_s,
                        "bit_equal_to_train_als": bit_equal,
                        "max_abs_gap": max(gaps)}
        emit({"phase": "quickstart-cli", "step": "train", **out["train"]})

        # the segment solver under its own engine variant, so deploy serves the dense one
        seg = os.path.join(tmp, "recommendation-segment")
        shutil.copytree(eng, seg)
        with open(os.path.join(seg, "engine.json")) as f:
            seg_variant = json.load(f)
        seg_variant["id"] = "segment"
        with open(os.path.join(seg, "engine.json"), "w") as f:
            json.dump(seg_variant, f)
        os.environ["PIO_ALS_SOLVER"] = "segment"
        try:
            for c in (train_kernel.launches, train_kernel.gather_launches,
                      train_kernel.segment_launches):
                c.reset()
            t0 = time.perf_counter()
            cli_run("train", "--engine-dir", seg, "--device", device.type)
            seg_s = time.perf_counter() - t0
            seg_counts = {"segment": train_kernel.segment_launches.count,
                          "gather": train_kernel.gather_launches.count,
                          "dense": train_kernel.launches.count}
        finally:
            del os.environ["PIO_ALS_SOLVER"]
        require(seg_counts == {"segment": 2 * TRAIN_ITERS, "gather": 0, "dense": 0},
                f"PIO_ALS_SOLVER=segment pio train launches {seg_counts}")
        out["train_segment"] = {"wall_s": seg_s, "launches": seg_counts}
        emit({"phase": "quickstart-cli", "step": "train-segment", **out["train_segment"]})

        # 4. serve: deploy --batching as a real subprocess
        qs = CliServer(tmp, "deploy", "deploy", "--engine-dir", eng, "--batching", "--device", device.type)
        servers.append(qs)
        ready_s = qs.wait_ready()
        status, ready = http_json(f"{qs.base}/readyz")
        require(ready["engineInstanceId"] == iid, f"deployed {ready} vs the dense instance {iid}")
        launched_at_ready = http_json(f"{qs.base}/")[1]["scoreKernelLaunches"]  # after the warm-up
        q_rng = np.random.default_rng(seed + 22)
        n_users = len(model.user_map)

        def query():
            return {"user": model.user_map.inverse[int(q_rng.integers(n_users))],
                    "num": int(q_rng.integers(1, K + 1))}

        def post(q):
            t = time.perf_counter()
            status, a = http_json(f"{qs.base}/queries.json", q)
            require(status == 200, f"/queries.json {status} {a}")
            return q, a, time.perf_counter() - t

        answers, latency = [], []
        for _ in range(QS_SINGLE_QUERIES):
            q, a, dt = post(query())
            answers.append((q, a))
            latency.append(dt)
        with ThreadPoolExecutor(max(size for size, _ in QS_BURSTS)) as pool:
            for size, count in QS_BURSTS:
                for _ in range(count):
                    answers += [(q, a) for q, a, _ in pool.map(post, [query() for _ in range(size)])]
        status, info = http_json(f"{qs.base}/")
        fp = info["fastpath"][0]
        hits = {int(b): h for b, h in fp["bucket_hits"].items()}
        require(fp["calls"] == sum(hits.values()) > 0 and any(h for b, h in hits.items() if b > 1),
                f"dispatches {fp['calls']}, rungs {hits}: a rung above 1 formed")
        require(fp["queries"] == len(answers), f"{fp['queries']} queries served vs {len(answers)}")
        score_launches = info["scoreKernelLaunches"] - launched_at_ready
        require(score_launches == fp["calls"],
                f"kernel 1 launched {score_launches} times vs {fp['calls']} fast-path dispatches")
        U, V = (torch.from_numpy(np.ascontiguousarray(F)) for F in (model.user_factors, model.item_factors))
        users = torch.tensor([model.user_map[q["user"]] for q, _ in answers])
        rv, ri = (t.numpy() for t in torch.topk(U[users] @ V.T, K, dim=1))
        bad = []
        for j, (q, a) in enumerate(answers):
            n = q["num"]
            got_i = np.array([[model.item_map[x["item"]] for x in a["itemScores"]]])
            got_v = np.array([[x["score"] for x in a["itemScores"]]])
            bad += topk_mismatches(got_v, got_i, rv[j:j + 1, :n], ri[j:j + 1, :n], TOL)
        require(not bad, f"served answers disagree with the plain version: {bad[:3]}")
        cli_run("undeploy", "--port", str(qs.port))
        qs.wait_exit()
        try:
            socket.create_connection(("127.0.0.1", qs.port), timeout=5).close()
            require(False, f"port {qs.port} still listening after undeploy")
        except ConnectionRefusedError:
            pass
        lat_ms = np.asarray(latency) * 1e3
        top = 100.0 * (1 - 10 / len(lat_ms))
        out["serve"] = {"deploy_to_ready_s": ready_s, "queries": len(answers),
                        "single_queries": len(lat_ms), "bursts": [list(b) for b in QS_BURSTS],
                        "http_ms_p50": float(np.percentile(lat_ms, 50)),
                        f"http_ms_p{top:g}": float(np.percentile(lat_ms, top)),
                        "dispatches": fp["calls"], "launches": score_launches,
                        "bucket_hits": fp["bucket_hits"],
                        "rungs_run": sorted(b for b, h in hits.items() if h),
                        "topk_mismatches": 0}
        emit({"phase": "quickstart-cli", "step": "serve", **out["serve"]})

        # 5. SASRec through the same verbs
        seq_key = key_of.search(cli_run("app", "new", QS_SEQ_APP)).group(1)
        rng = np.random.default_rng(seed + 15)  # phase_sasrec_train_workflow's draw
        w = zipf_mandelbrot_weights(1000, 1.1)
        histories = {f"wu{u}": [f"wi{int(i)}" for i in rng.choice(1000, int(rng.integers(20, 301)), p=w)]
                     for u in range(300)}
        views = [{"event": "view", "entityType": "user", "entityId": u, "targetEntityType": "item",
                  "targetEntityId": i, "eventTime": 1_767_225_600.0 + t}
                 for u, items in histories.items() for t, i in enumerate(items)]
        es = CliServer(tmp, "eventserver-seq", "eventserver")
        servers.append(es)
        es.wait_ready()
        t0 = time.perf_counter()
        post_batches(es.base, seq_key, views)
        seq_post_s = time.perf_counter() - t0
        require(http_json(f"{es.base}/stop", method="POST")[0] == 202, "POST /stop")
        es.wait_exit()
        seng = os.path.join(tmp, "sequentialrecommendation")
        cli_run("template", "get", "sequentialrecommendation", "--directory", seng)
        fill_engine_json(os.path.join(seng, "engine.json"), QS_SEQ_APP, [
            {"name": "sasrec", "params": {
                "appName": QS_SEQ_APP, "eventNames": ["view"], "dModel": SAS_D,
                "numLayers": SAS_LAYERS, "numHeads": SAS_HEADS, "maxLen": SAS_MAX_LEN,
                "epochs": QS_SAS_STEPS, "batchSize": SAS_BATCH, "lr": SAS_LR, "seed": seed}}],
            eventNames=["view"])
        cli_run("build", "--engine-dir", seng)
        reset_flash_counts()  # the path's window
        t0 = time.perf_counter()
        trained = cli_run("train", "--engine-dir", seng, "--device", device.type)
        sas_train_s = time.perf_counter() - t0
        counts = flash_counts()
        want = SAS_LAYERS * QS_SAS_STEPS
        require(counts == {"fwd": want, "bwd_dq": want, "bwd_dkv": want},
                f"pio train (SASRec) flash launches {counts} vs {SAS_LAYERS} layers × {QS_SAS_STEPS} steps")
        sas_iid = re.search(r"Engine instance ID: (\S+)", trained).group(1)
        qs = CliServer(tmp, "deploy-seq", "deploy", "--engine-dir", seng, "--device", device.type)
        servers.append(qs)
        sas_ready_s = qs.wait_ready()
        users = list(histories)[:20]
        nums = {u: int(rng.integers(1, 51)) for u in users}
        sas_answers = []
        for u in users:
            status, a = http_json(f"{qs.base}/queries.json", {"user": u, "num": nums[u]})
            require(status == 200 and len(a["itemScores"]) == nums[u], f"{u}: {status} {a}")
            sas_answers.append((u, a))
        cli_run("undeploy", "--port", str(qs.port))
        qs.wait_exit()
        sas_engine = SequentialRecommendationEngine.apply()
        sas_inst = storage.get_meta_data_engine_instances().get(sas_iid)
        _, _, _, sas_models = workflow.prepare_deploy(sas_engine, sas_inst, storage=storage, ctx=ctx)
        gap, _, _ = hold_answers(sas_models[0], device, {u: histories[u] for u in users},
                                 sas_answers, nums)
        out["sasrec"] = {"events": len(views), "users": len(histories), "post_s": seq_post_s,
                         "steps": QS_SAS_STEPS, "train_wall_s": sas_train_s, "launches": counts,
                         "deploy_to_ready_s": sas_ready_s, "queries": len(sas_answers),
                         "max_abs_err_answers": gap, "tol": SAS_TOL}
    finally:
        for srv in servers:
            srv.kill()
        Storage.reset_instance()
        sqlite.close_all_dbs()
        os.environ.pop("PIO_FS_BASEDIR", None)
        os.environ.pop("PIO_ALS_SOLVER", None)
        os.environ.update(saved)
        shutil.rmtree(tmp, ignore_errors=True)
    out.update(seconds=time.perf_counter() - t_phase, ok=True)
    emit(out)
    return out


# -- serving-ops: the deployed ALS server as operators run it -----------------

OPS_APP = "ServingOps"
OPS_REQUESTS = 2000  # each closed-loop load
OPS_CONCURRENCY = (1, 16, 64)
OPS_RATES = (200, 800, 3200)  # open-loop arrival rates, req/s
OPS_RATE_S = 6  # seconds each open-loop rate runs
OPS_CLIENTS = 64  # the open loop's workers (one keep-alive connection each)
OPS_SLO_MS = 50.0  # the p99 limit PERF.md §2 sets for /queries.json
OPS_SAMPLED = 300  # answers held against the plain version
OPS_NUM = 10  # items a query asks for (the loadtest's default query)
# requests of the loads a drain cuts short (SIGTERM, --kill-after): more
# than the 1.5 s before the stop can serve, few enough that the refused
# rest costs the client little
OPS_TAIL = 5000
OPS_STAGES = ("decode", "queue_wait", "batch_assembly", "h2d", "device_compute", "d2h",
              "serialize", "other")


def run_loadtest_cli(*argv) -> tuple[int, dict]:
    """``pio loadtest <argv>`` with this process as the client (the server
    runs in a process of its own): its exit code and JSON report. In this
    process because ``--sample user=<every user>`` is longer than one
    command-line argument may be."""
    import contextlib
    import io

    from predictionio_tpu_torch.tools import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["loadtest", *argv])
    lines = buf.getvalue().strip().splitlines()
    require(bool(lines), f"pio loadtest {argv[:4]} printed nothing (exit {rc})")
    return rc, json.loads(lines[-1])


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}


def _device_totals(info: dict) -> dict:
    """Busy seconds, FLOPs and bytes the fast path's accountant holds (its
    window spans the whole phase, ``PIO_DEVPROF_WINDOW``)."""
    d = (info["fastpath"][0] or {}).get("devprof") or {}
    el = d.get("elapsed_s") or 0.0
    return {"busy_s": d.get("busy_s") or 0.0, "flops": (d.get("flops_per_s") or 0.0) * el,
            "bytes": (d.get("hbm_gbps") or 0.0) * 1e9 * el, "platform": d.get("platform")}


def ops_load_row(before: dict, after: dict, report: dict, rung_us: dict) -> dict:
    """One load's server-side view from ``GET /`` before and after it: the
    batches it formed by size and rung, the fast path's dispatches and the
    score kernel's launches, and the card's busy share and utilization
    over the load's wall time, from the accountant's device time (the CUDA
    events around each launch) and, as a check, from the rungs dispatched
    times the kernel's device µs a rung in this run's trace (``rung_us``)."""
    from predictionio_tpu_torch.obs.devprof import peak_for

    fa, fb = after["fastpath"][0], before["fastpath"][0]
    da, db = _device_totals(after), _device_totals(before)
    wall = report["wallSec"]
    peak = peak_for(da["platform"])
    busy = da["busy_s"] - db["busy_s"]
    flops, nbytes = da["flops"] - db["flops"], da["bytes"] - db["bytes"]
    hits = _delta(fa["bucket_hits"], fb["bucket_hits"])
    traced = sum(n * rung_us[int(b)] for b, n in hits.items()) * 1e-6
    return {
        "batch_sizes": _delta(after["batching"]["batch_sizes"], before["batching"]["batch_sizes"]),
        "rung_hits": hits,
        "dispatches": fa["calls"] - fb["calls"],
        "launches": after["scoreKernelLaunches"] - before["scoreKernelLaunches"],
        "device_busy_s": busy,
        "device_busy_share": busy / wall if wall else None,
        "kernel_busy_share_from_trace": traced / wall if wall else None,
        "flops_per_s": flops / wall if wall else None,
        "bytes_per_s": nbytes / wall if wall else None,
        "utilization_vs": da["platform"],
        "flops_util": flops / wall / peak["flops"] if peak and wall else None,
        "bytes_util": nbytes / wall / peak["hbm_gbps"] if peak and wall else None,
    }


def trace_stage_medians(traces: list) -> dict:
    """Median ms of each trace stage over sampled ``POST /queries.json``."""
    import numpy as np

    qs = [t for t in traces if t.get("name") == "POST /queries.json" and t.get("status") == 200]
    require(len(qs) >= 20, f"{len(qs)} sampled /queries.json traces")
    out = {"traces": len(qs), "wall_ms": float(np.median([t["wallMs"] for t in qs])),
           "kernel_event_us": float(np.median([t["meta"]["device_us"] for t in qs
                                              if "device_us" in t.get("meta", {})]))}
    for st in OPS_STAGES:
        out[f"{st}_ms"] = float(np.median([t["stagesMs"].get(st, 0.0) for t in qs]))
    return out


def phase_serving_ops(model, seed, device, kernel_rows):
    """The deployed ALS server as operators run it: see the module
    docstring, phase 13. ``kernel_rows``: phase 3's timings, whose f32
    rows give the kernel's device µs a rung."""
    import re
    import shutil
    import signal
    import sqlite3
    import tempfile
    import threading

    import numpy as np
    import torch

    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.data.storage import sqlite
    from predictionio_tpu_torch.data.storage.base import Model
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.ops import score_kernel
    from predictionio_tpu_torch.serving.query_server import QueryServer
    from predictionio_tpu_torch.templates.recommendation import RecommendationEngine
    from predictionio_tpu_torch.testing import topk_mismatches

    t_phase = time.perf_counter()
    rung_us = {r["batch"]: sum(r["kernel_device_us"].values()) for r in kernel_rows
               if r.get("case", "ml25m") == "ml25m" and r["dtype"] == "f32"}
    tmp = tempfile.mkdtemp(prefix="pio-serving-ops-")
    knobs = ("PIO_FS_BASEDIR", "PIO_DEVPROF_WINDOW", "PIO_RESULT_CACHE", "PIO_COALESCE",
             "PIO_TRACE_SAMPLE")
    saved = {k: v for k, v in os.environ.items() if k.startswith("PIO_STORAGE_") or k in knobs}
    for k in saved:
        del os.environ[k]
    os.environ["PIO_FS_BASEDIR"] = os.path.join(tmp, "base")
    # one accountant window for the whole phase, so its busy seconds add up
    # across the loads; the deployed servers inherit it
    os.environ["PIO_DEVPROF_WINDOW"] = "3600"
    Storage.reset_instance()
    store.set_storage(None)
    servers = []
    out = {"phase": "serving-ops"}
    users = [model.user_map.inverse[j] for j in range(len(model.user_map))]
    sample = "user=" + ",".join(users)
    query = json.dumps({"user": users[0], "num": OPS_NUM})
    try:
        # 1. the store, the model and the two servers
        key = re.search(r"Access Key: (\S+)", cli_run("app", "new", OPS_APP)).group(1)
        storage = Storage.instance()
        app_id = storage.get_meta_data_apps().get_by_name(OPS_APP).id
        engine = RecommendationEngine.apply()
        eng = os.path.join(tmp, "recommendation")
        cli_run("template", "get", "recommendation", "--directory", eng)
        fill_engine_json(os.path.join(eng, "engine.json"), OPS_APP, ALS_VARIANT["algorithms"])
        t0 = time.perf_counter()
        iid = publish(storage, engine, model, engine_id=ALS_FACTORY)
        publish_s = time.perf_counter() - t0
        es = CliServer(tmp, "eventserver", "eventserver", "--stats")
        servers.append(es)
        es.wait_ready()
        qs = CliServer(tmp, "deploy", "deploy", "--engine-dir", eng, "--batching", "--feedback",
                       "--event-server-ip", "127.0.0.1", "--event-server-port", str(es.port),
                       "--accesskey", key, "--device", device.type)
        servers.append(qs)
        ready_s = qs.wait_ready()

        def info(srv=qs):
            return http_json(f"{srv.base}/")[1]

        at_ready = info()
        require(at_ready["engineInstanceId"] == iid and at_ready["feedback"], f"deployed {at_ready}")
        emit({"phase": "serving-ops", "step": "deploy", "t": time.perf_counter() - t_phase,
              "users": len(users),
              "items": len(model.item_map), "publish_s": publish_s, "deploy_to_ready_s": ready_s})

        # 2. closed loops: zipf over every user, at three concurrencies
        closed = []
        for c in OPS_CONCURRENCY:
            before = info()
            rc, rep = run_loadtest_cli(
                "--port", str(qs.port), "--query", query, "--requests", str(OPS_REQUESTS),
                "--concurrency", str(c), "--dist", "zipf", "--sample", sample, "--scrape-metrics")
            after = info()
            require(rc == 0 and rep["ok"] == OPS_REQUESTS and rep["http5xx"] == 0,
                    f"closed loop c={c}: exit {rc}, {rep}")
            row = {"concurrency": c, "requests": rep["requests"], "ok": rep["ok"],
                   "issued_per_s": rep["requests"] / rep["wallSec"], "qps": rep["qps"],
                   "p50_ms": rep["p50Ms"], "p90_ms": rep["p90Ms"], "p99_ms": rep["p99Ms"],
                   "shed": rep["shed"], "distinct_users": rep["perKey"]["distinctKeys"],
                   **ops_load_row(before, after, rep, rung_us),
                   "scrape": {k: rep["serverMetrics"].get(k) for k in (
                       "deviceBusyFraction", "deviceMfu", "deviceHbmUtil", "kernelBackend",
                       "kernelFactorDtype", "kernelIntensity", "batcherQueries")}}
            if c == 1:
                traces = http_json(f"{qs.base}/trace/recent.json?limit=256")[1]["traces"]
                row["trace_stages"] = trace_stage_medians(traces)
            closed.append(row)
            emit({"phase": "serving-ops", "step": "closed-loop", "t": time.perf_counter() - t_phase,
                  **row})

        # 3. open loops: steady arrivals over every user in turn
        opened = []
        for rate in OPS_RATES:
            before = info()
            rc, rep = run_loadtest_cli(
                "--port", str(qs.port), "--query", query, "--sample", sample,
                "--scenario", f"steady:rate={rate},duration={OPS_RATE_S}",
                "--concurrency", str(OPS_CLIENTS), "--seed", str(seed), "--scrape-metrics")
            after = info()
            require(rc == 0 and rep["errors"] == 0, f"open loop {rate}/s: exit {rc}, {rep}")
            ph = rep["phases"][0]
            row = {"rate": rate, "requests": rep["requests"], "ok": rep["ok"],
                   "issued_per_s": rep["issuedPerSec"], "worst_lag_s": rep["worstLagS"],
                   "qps": ph["qps"], "p50_ms": ph["p50Ms"], "p99_ms": ph["p99Ms"],
                   "shed": rep["shed"], **ops_load_row(before, after, rep, rung_us)}
            opened.append(row)
            emit({"phase": "serving-ops", "step": "open-loop", "t": time.perf_counter() - t_phase,
                  **row})
        within = [r["rate"] for r in opened if r["p99_ms"] <= OPS_SLO_MS]

        # 4. sampled answers against the plain version on the card
        rng = np.random.default_rng(seed + 41)
        picks = [(users[int(j)], int(rng.integers(1, K + 1)))
                 for j in rng.integers(0, len(users), OPS_SAMPLED)]
        answers = []
        for u, n in picks:
            status, a = http_json(f"{qs.base}/queries.json", {"user": u, "num": n})
            require(status == 200 and "prId" in a, f"{u}: {status} {a}")
            answers.append(a)
        plain = Inputs(model.user_factors, model.item_factors, "f32", device)
        u_idx = torch.tensor([model.user_map[u] for u, _ in picks], dtype=torch.int32, device=device)
        rv, ri = (t.cpu().numpy() for t in plain.plain(u_idx, K))
        bad = []
        for j, ((_, n), a) in enumerate(zip(picks, answers)):
            got_i = np.array([[model.item_map[x["item"]] for x in a["itemScores"]]])
            got_v = np.array([[x["score"] for x in a["itemScores"]]])
            bad += topk_mismatches(got_v, got_i, rv[j:j + 1, :n], ri[j:j + 1, :n], TOL)
        require(not bad, f"served answers disagree with the plain version: {bad[:3]}")

        # 5. the counters of everything served so far
        served = info()
        counters = served["resilience"]["counters"]
        launches = served["scoreKernelLaunches"] - at_ready["scoreKernelLaunches"]
        dispatches = served["fastpath"][0]["calls"] - at_ready["fastpath"][0]["calls"]
        require(counters["degraded"] == 0 and counters["query_errors"] == 0,
                f"degraded / query errors: {counters}")
        require(launches == dispatches > 0,
                f"kernel 1 launched {launches} times vs {dispatches} fast-path dispatches")

        # 6. feedback: every answer's predict event lands in sqlite, less
        # what the bounded queue dropped (counted) and failed posts
        t_end = time.monotonic() + 60
        db = os.path.join(os.environ["PIO_FS_BASEDIR"], "default.sqlite")
        while True:
            now = info()
            c = now["resilience"]["counters"]
            expect = (now["requestCount"] - now["feedbackDropped"] - c["feedback_errors"]
                      - c["breaker_open"])
            with sqlite3.connect(db, timeout=30) as conn:
                landed = conn.execute(
                    "SELECT COUNT(*) FROM events WHERE app_id = ? AND event = 'predict' "
                    "AND entity_type = 'pio_pr'", (app_id,)).fetchone()[0]
            if (landed == expect and now["feedbackQueued"] == 0) or time.monotonic() > t_end:
                break
            time.sleep(0.2)
        require(landed == expect and landed > 0,
                f"feedback: {landed} predict events in sqlite vs {expect} expected "
                f"({now['requestCount']} answered, {now['feedbackDropped']} dropped, {c})")
        out["feedback"] = {"answered": now["requestCount"], "predict_events": landed,
                           "dropped": now["feedbackDropped"], "errors": c["feedback_errors"],
                           "breaker_open": c["breaker_open"]}
        emit({"phase": "serving-ops", "step": "feedback", "t": time.perf_counter() - t_phase,
              **out["feedback"]})

        # 7. result cache and coalescing, in this process on the card,
        # against the answers of the cache-off server above
        os.environ.update(PIO_RESULT_CACHE="1", PIO_COALESCE="1")
        try:
            cq = QueryServer(engine, storage=storage, ctx=DeviceContext.create(device=device),
                             engine_id=ALS_FACTORY, batching=True)
        finally:
            del os.environ["PIO_RESULT_CACHE"], os.environ["PIO_COALESCE"]
        cbase = f"http://127.0.0.1:{cq.start('127.0.0.1', 0)}"
        try:
            hot = [users[int(j)] for j in rng.integers(0, len(users), 50)]
            seq = [{"user": hot[int(j)], "num": OPS_NUM} for j in rng.integers(0, len(hot), 400)]
            score_kernel.launches.reset()  # the cache path's window
            got = [http_json(f"{cbase}/queries.json", q)[1] for q in seq]
            seq_launches = score_kernel.launches.count
            hits = cq._result_cache.stats()["hits"]
            require(seq_launches == len(seq) - hits and hits >= len(seq) - len(hot),
                    f"one at a time: {seq_launches} launches for {len(seq)} queries, {hits} hits")
            # bursts of identical queries held so they arrive together:
            # one leader a user takes a row, the followers ride it
            burst_users = [users[int(j)] for j in rng.integers(0, len(users), 8)]
            burst = [{"user": u, "num": OPS_NUM} for u in burst_users for _ in range(8)]
            rows_before = cq._fastpath_stats()["queries"]
            with ThreadPoolExecutor(len(burst)) as pool:
                with cq._batcher.held():
                    futs = [pool.submit(http_json, f"{cbase}/queries.json", q) for q in burst]
                    t_hold = time.monotonic() + 20
                    while cq._inflight < len(burst) and time.monotonic() < t_hold:
                        time.sleep(0.002)
                    time.sleep(0.02)
                got += [f.result()[1] for f in futs]
            coalesced = cq._batcher.stats()["coalesced"]
            burst_rows = cq._fastpath_stats()["queries"] - rows_before
            launches_c = score_kernel.launches.count
            cstats = cq._result_cache.stats()
        finally:
            cq.stop()
        require(burst_rows == len(set(burst_users)) and coalesced == len(burst) - burst_rows,
                f"coalescing: {burst_rows} rows, {coalesced} followers for {len(burst)} queries")
        bad = []
        for q, a in zip(seq + burst, got):
            _, ref = http_json(f"{qs.base}/queries.json", q)
            ri_ = np.array([[model.item_map[x["item"]] for x in ref["itemScores"]]])
            rv_ = np.array([[x["score"] for x in ref["itemScores"]]])
            gi = np.array([[model.item_map[x["item"]] for x in a["itemScores"]]])
            gv = np.array([[x["score"] for x in a["itemScores"]]])
            bad += topk_mismatches(gv, gi, rv_, ri_, TOL)
        require(not bad, f"cached/coalesced answers vs the cache-off server: {bad[:3]}")
        out["cache"] = {"queries": len(seq) + len(burst), "hits": cstats["hits"],
                        "misses": cstats["misses"], "coalesced": coalesced,
                        "launches": launches_c, "one_at_a_time_launches": seq_launches,
                        "burst_rows": burst_rows}
        emit({"phase": "serving-ops", "step": "cache", "t": time.perf_counter() - t_phase,
              **out["cache"]})

        # 8. a corrupt newer instance: the live server keeps its generation,
        # a fresh deploy cold-starts on the last-known-good one
        bad_iid = publish(storage, engine, model, engine_id=ALS_FACTORY)
        row = storage.get_model_data_models().get(bad_iid)
        storage.get_model_data_models().insert(Model(id=bad_iid, models=row.models[:-7] + b"garbage"))
        status, rl = http_json(f"{qs.base}/reload", method="POST")
        _, rz = http_json(f"{qs.base}/readyz")
        require(status == 200 and rl["engineInstanceId"] == iid and rz["reloadDegraded"]
                and info()["resilience"]["counters"]["reload_failed"] == 1,
                f"reload onto a corrupt instance: {status} {rl}, readyz {rz}")
        cold = CliServer(tmp, "deploy-cold", "deploy", "--engine-dir", eng, "--batching",
                         "--device", device.type)
        servers.append(cold)
        cold_ready_s = cold.wait_ready()
        _, cz = http_json(f"{cold.base}/readyz")
        require(cz["engineInstanceId"] == iid and cz["reloadDegraded"],
                f"cold start next to a corrupt newest instance: {cz}")
        # the same closed loop at 64 on this deploy, which posts no
        # feedback: what the feedback worker costs the server
        before = info(cold)
        rc, rep = run_loadtest_cli(
            "--port", str(cold.port), "--query", query, "--requests", str(OPS_REQUESTS),
            "--concurrency", str(OPS_CONCURRENCY[-1]), "--dist", "zipf", "--sample", sample)
        require(rc == 0 and rep["ok"] == OPS_REQUESTS, f"closed loop without feedback: {rep}")
        out["closed_no_feedback"] = {
            "concurrency": OPS_CONCURRENCY[-1], "qps": rep["qps"], "p50_ms": rep["p50Ms"],
            "p99_ms": rep["p99Ms"], **ops_load_row(before, info(cold), rep, rung_us)}
        emit({"phase": "serving-ops", "step": "closed-no-feedback",
              "t": time.perf_counter() - t_phase, **out["closed_no_feedback"]})

        # 9. SIGTERM to that deploy during a loadtest: it drains, exits 0,
        # and answers no 5xx beyond 503 sheds
        term = {}

        def load_cold():
            term["rc"], term["report"] = run_loadtest_cli(
                "--port", str(cold.port), "--query", query, "--requests", str(OPS_TAIL),
                "--concurrency", "16", "--sample", sample)

        th = threading.Thread(target=load_cold)
        th.start()
        time.sleep(1.5)
        cold.proc.send_signal(signal.SIGTERM)
        cold.wait_exit()
        th.join(120)
        rep = term["report"]
        require(rep["ok"] > 0 and rep["http5xx"] == 0, f"SIGTERM drain under load: {rep}")
        out["sigterm"] = {"ok": rep["ok"], "shed": rep["shed"], "http5xx": rep["http5xx"],
                          "connection_errors": rep["errors"], "exit": 0,
                          "cold_start_s": cold_ready_s}
        emit({"phase": "serving-ops", "step": "sigterm", "t": time.perf_counter() - t_phase,
              **out["sigterm"]})

        # 10. --kill-after: the load test posts /stop; the server drains
        final = info()
        launches = final["scoreKernelLaunches"] - at_ready["scoreKernelLaunches"]
        dispatches = final["fastpath"][0]["calls"] - at_ready["fastpath"][0]["calls"]
        require(launches == dispatches, f"kernel 1 {launches} launches vs {dispatches} dispatches")
        exited = {}
        watch = threading.Thread(target=lambda: exited.update(
            rc=qs.proc.wait(), t=time.perf_counter() - t_phase), daemon=True)
        watch.start()
        rc, rep = run_loadtest_cli("--port", str(qs.port), "--query", query,
                                   "--requests", str(OPS_TAIL), "--concurrency", "16",
                                   "--sample", sample, "--kill-after", "1.5")
        t_load = time.perf_counter() - t_phase
        qs.wait_exit()
        watch.join(5)
        t_exit = exited.get("t")
        require(rc == 0 and rep["stopPosted"] and rep["http5xx"] == 0 and rep["ok"] > 0,
                f"--kill-after drain: exit {rc}, {rep}")
        require(http_json(f"{es.base}/stop", method="POST")[0] == 202, "event server POST /stop")
        es.wait_exit()
        out["kill_after"] = {"ok": rep["ok"], "shed": rep["shed"], "after_stop": rep["afterStop"],
                             "http5xx": rep["http5xx"], "exit": 0, "load_wall_s": rep["wallSec"],
                             "t_load_done": t_load, "t_deploy_exited": t_exit,
                             "t_eventserver_exited": time.perf_counter() - t_phase}
        emit({"phase": "serving-ops", "step": "kill-after", **out["kill_after"]})
        out.update(deploy_to_ready_s=ready_s, closed=closed, open=opened,
                   highest_rate_p99_within_slo=max(within) if within else None,
                   slo_p99_ms=OPS_SLO_MS, sampled=len(answers), topk_mismatches=0,
                   degraded=0, query_errors=0, launches=launches, dispatches=dispatches,
                   reload_failed=1, cold_start_instance=iid)
    finally:
        for srv in servers:
            srv.kill()
        Storage.reset_instance()
        sqlite.close_all_dbs()
        for k in knobs:
            os.environ.pop(k, None)
        os.environ.update(saved)
        shutil.rmtree(tmp, ignore_errors=True)
    out.update(seconds=time.perf_counter() - t_phase, ok=True)
    emit(out)
    return out


# -- A/B: kernels 1 and 2 of two trees, on one card ---------------------------


# (B·H, T_q, T_kv, h) of the A/B's flash timings, causal: kernel 4 at the
# serving and training shapes, kernels 5 and 6 at BWD_TIMED
AB_FWD = ((1, 256, 256, 50), (128, 256, 256, 50))


def time_flash(seed, device):
    """Kernels 4, 5 and 6 at AB_FWD / BWD_TIMED, causal: ms a call (CUDA
    events) and device µs a call (the trace), through the wrappers whose
    signatures the parent tree shares."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(seed + 12)
    out = []
    for shape in dict.fromkeys(AB_FWD + BWD_TIMED):
        bh, t_q, t_kv, h = shape
        q, k, v, do = (torch.from_numpy(rng.standard_normal((bh, t, h)).astype(np.float32)).to(device)
                       for t in (t_q, t_kv, t_kv, t_q))
        o, lse = fa.flash_attention_reference(q, k, v, True)
        delta, scale = (do * o).sum(-1), fa._f32(1.0 / h ** 0.5)
        calls = {}
        if shape in AB_FWD:
            calls["fwd"] = lambda: fa.flash_block_fwd(q, k, v, True)
        if shape in BWD_TIMED:
            calls["dq"] = lambda: fa._launch_bwd_dq(q, k, v, do, lse, delta, True, scale)
            calls["dkv"] = lambda: fa._launch_bwd_dkv(q, k, v, do, lse, delta, True, scale)
        for kernel, fn in calls.items():
            out.append({"kernel": kernel, "shape": list(shape), "ms": cuda_ms(fn, 200),
                        "device_us": sum(device_us(fn, 50).values())})
    return out


def time_kernels(seed, device, data_path):
    """Kernel 1 at every rung × dtype of the ML-25M serving shape, kernel 2
    over each side's buckets of the first half-step (f32, explicit) and the
    flash kernels 4, 5 and 6 (``time_flash``), through whichever
    ``predictionio_tpu_torch`` is first on ``sys.path``. Uses only the
    wrappers' signatures, which the parent tree shares. The buckets are
    drawn once and kept in ``data_path`` for the other runs of the A/B."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import _build, train_kernel

    t0 = time.perf_counter()
    _build.build_all(("score_topk", "train_normal_eq", "flash_fwd", "flash_bwd"))
    out = {"build_s": time.perf_counter() - t0, "score": [], "train": []}
    out["flash"] = time_flash(seed, device)
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((N_USERS, RANK)).astype(np.float32)
    V = rng.standard_normal((N_ITEMS, RANK)).astype(np.float32)
    for dtype in DTYPES:
        inp = Inputs(U, V, dtype, device)
        for b in RUNGS:
            u_idx = torch.from_numpy(rng.integers(0, N_USERS, b).astype(np.int32)).to(device)

            def kern(u_idx=u_idx, inp=inp):
                return inp.kernel(u_idx, K)

            out["score"].append({"dtype": dtype, "batch": b, "ms": cuda_ms(kern, 200),
                                 "device_us": sum(device_us(kern).values())})
    del inp
    if os.path.exists(data_path):
        z = np.load(data_path)
        sides = {n: ([(z[f"{n}_idx{j}"], z[f"{n}_rat{j}"], z[f"{n}_msk{j}"])
                      for j in range(int(z[f"{n}_n"]))], z[f"{n}_opp"]) for n in ("user", "item")}
    else:
        from predictionio_tpu_torch.models import als

        inter = zipf_interactions(seed, N_USERS, N_ITEMS, N_RATINGS)
        cfg = als.ALSConfig(rank=RANK, iterations=TRAIN_ITERS, seed=seed)
        ub, ib, u_perm, i_perm = als._dense_blocks_for(inter, cfg)
        gen = torch.Generator(device="cpu").manual_seed(cfg.seed)
        U0 = als._initial_factors(cfg, N_USERS, gen)
        V0 = als._initial_factors(cfg, N_ITEMS, gen)
        sides = {"user": (list(zip(ub.idx, ub.rat, ub.msk)), V0[np.argsort(i_perm)]),
                 "item": (list(zip(ib.idx, ib.rat, ib.msk)), U0[np.argsort(u_perm)])}
        arrays = {}
        for n, (bl, opp) in sides.items():
            arrays[f"{n}_n"] = np.array(len(bl))
            arrays[f"{n}_opp"] = opp
            for j, (i, r, m) in enumerate(bl):
                arrays[f"{n}_idx{j}"], arrays[f"{n}_rat{j}"], arrays[f"{n}_msk{j}"] = i, r, m
        np.savez(data_path, **arrays)
    for name, (bl, opp) in sides.items():
        dev = [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in t) for t in bl]
        opp_t = torch.from_numpy(np.ascontiguousarray(opp)).to(device)

        def half(dev=dev, opp_t=opp_t):
            return [train_kernel.fused_train_normal_eq(i, r, m, opp_t) for i, r, m in dev]

        buckets = []
        for i, r, m in dev:
            def one(i=i, r=r, m=m, opp_t=opp_t):
                return train_kernel.fused_train_normal_eq(i, r, m, opp_t)

            buckets.append({"n_b": i.shape[0], "width": i.shape[1], "live_slots": int(m.sum()),
                            "device_us": sum(device_us(one, 10).values())})
        out["train"].append({"side": name, "ms": cuda_ms(half, 10),
                             "device_us": sum(device_us(half, 5).values()), "buckets": buckets})
        del dev
    return out


def ab(parent, seed):
    """Kernels 1, 2, 4, 5 and 6 of the tree at ``parent`` (an unpacked ``git archive``
    of the parent commit, under a directory ``.gitignore`` lists) and of this
    tree, in turns on one card: parent, change, change, parent. Each run is a
    process of its own that puts its tree first on ``sys.path`` and builds
    that tree's kernels into that tree's ``build/``."""
    data = os.path.join(ROOT, "build", "ab_buckets.npz")
    runs = []
    for label, tree in (("parent", parent), ("change", ROOT), ("change", ROOT), ("parent", parent)):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
             "--time-kernels", os.path.abspath(tree), "--data", data],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(f"A/B run of {tree} failed:\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
        runs.append({"tree": label, **json.loads(res.stdout.strip().splitlines()[-1])})
        emit({"phase": "ab-run", "tree": label,
              "score_b64_ms": {r["dtype"]: r["ms"] for r in runs[-1]["score"] if r["batch"] == RUNGS[-1]},
              "train_half_step_ms": {r["side"]: r["ms"] for r in runs[-1]["train"]},
              "train_half_step_device_us": {r["side"]: r["device_us"] for r in runs[-1]["train"]},
              "flash": [{k: r[k] for k in ("kernel", "shape", "ms", "device_us")}
                        for r in runs[-1]["flash"]]})
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ab.json"), "w") as f:
        json.dump(runs, f, indent=1)
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ab", metavar="PARENT_TREE",
                    help="only time kernels 1, 2, 4, 5 and 6 of PARENT_TREE and of this tree, in turns")
    ap.add_argument("--time-kernels", metavar="TREE", help=argparse.SUPPRESS)
    ap.add_argument("--data", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    if args.time_kernels:
        sys.path.insert(0, args.time_kernels)
        emit(time_kernels(args.seed, torch.device("cuda", 0), args.data))
        return 0
    sys.path.insert(0, ROOT)
    if args.ab:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        emit({"phase": "ab", "card": smi})
        ab(args.ab, args.seed)
        return 0
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
          "ptxas": {n: ptxas_usage(out) for n, (_, _, out) in built.items()}})

    _, _, rows, max_err = phase_kernels(args.seed, device)
    inter, cfg, side_rows, bucket_rows, train_err, first = phase_train_kernels(args.seed, device)
    model, train = phase_train(inter, cfg, device, first)
    t0 = time.perf_counter()
    gather_rows, gather_err = phase_gather_kernel(args.seed, device, inter)
    seg_rows, seg_err = phase_segment_kernel(args.seed, device, inter)
    seg_train = phase_train_segment(inter, args.seed, device, model, train)
    del inter
    phase_small_parity(args.seed, device)
    seg_parity = phase_segment_parity(args.seed, device)
    segment_s = time.perf_counter() - t0
    emit({"phase": "segment-seconds", "seconds": segment_s})
    phase_workflow(args.seed, device)
    serving = phase_serving(model, args.seed, device)
    flash_rows, flash_err = phase_sasrec_kernel(args.seed, device)
    sasrec = phase_sasrec_serving(args.seed, device)
    bwd_rows, bwd_err = phase_sasrec_bwd_kernel(args.seed, device)
    sas_train = phase_sasrec_train(args.seed, device)
    phase_sasrec_train_parity(args.seed, device)
    sas_flow = phase_sasrec_train_workflow(args.seed, device)
    quick = phase_quickstart_cli(args.seed, device)
    ops = phase_serving_ops(model, args.seed, device, rows)
    # each kernel's launches on the CLI path, counted as the CLI drove it
    cli_launches = {
        "fused_gather_score_topk": quick["serve"]["launches"],
        "fused_train_normal_eq": quick["train"]["launches"],
        "flash_attention_fwd": quick["sasrec"]["launches"]["fwd"],
        "flash_attention_bwd_dq": quick["sasrec"]["launches"]["bwd_dq"],
        "flash_attention_bwd_dkv": quick["sasrec"]["launches"]["bwd_dkv"],
        "fused_gather_rows": quick["train_segment"]["launches"]["gather"],
        "fused_segment_normal_eq": quick["train_segment"]["launches"]["segment"],
    }

    top = next(r for r in rows if r["dtype"] == "f32" and r["batch"] == RUNGS[-1])
    # the training kernel's line: one iteration's normal equations (both
    # sides' buckets), f32, the main path's configuration
    both = [side_rows[(side, "f32")] for side in ("user", "item")]
    # the gather kernel's line: one call at the main path's shape (a chunk of
    # 65,536 ratings, rank 10, f32), the mean of the two sides' calls
    g32 = [r for r in gather_rows if r["dtype"] == "f32"]
    kernels = {"kernels": [{
        "name": "fused_gather_score_topk",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/score_topk.cu",
        "replaces": "predictionio_tpu/ops/score_kernel.py:125",
        "launches": serving["launches"],
        "max_abs_err": max_err,
        "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"], "library_ms": top["library_ms"],
    }, {
        "name": "fused_train_normal_eq",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/train_normal_eq.cu",
        "replaces": "predictionio_tpu/ops/train_kernel.py:145",
        "launches": train["launches"],
        "max_abs_err": train_err["max_abs_err"],
        # |Δ| over the summed absolute products behind the entry: the full-width
        # sums reach 1e5, so the absolute error alone says little
        "max_rel_err": train_err["max_rel_err"],
        "kernel_vs_f64_rel": train_err["kernel_vs_f64_rel"],
        "plain_vs_f64_rel": train_err["plain_vs_f64_rel"],
        "ms": sum(r["ms"] for r in both), "plain_ms": sum(r["plain_ms"] for r in both),
        "bound_ms": sum(r["bound_ms"] for r in both),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in both) else "operations",
        "library_ms": sum(r["library_ms"] for r in both),
    }, {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "predictionio_tpu/ops/flash_attention.py:62",
        "launches": sasrec["launches"],
        "max_abs_err": flash_err,
        # the serving shape: one query, one head, T = 256, h = 50, causal
        "ms": flash_rows[0]["ms"], "plain_ms": flash_rows[0]["plain_ms"],
        "bound_ms": flash_rows[0]["bound_ms"], "bound_by": flash_rows[0]["bound_by"],
        "library_ms": flash_rows[0]["library_ms"],
    }] + [{
        # the training shape: B·H 128, T 256, h 50, causal; plain_ms and
        # library_ms each compute dq, dk and dv at once
        "name": f"flash_attention_bwd_{part}",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/flash_bwd.cu",
        "replaces": f"predictionio_tpu/ops/flash_attention.py:{line}",
        "launches": sas_train["launches"][f"bwd_{part}"],
        "max_abs_err": bwd_err,
        "ms": bwd_rows[0][f"{part}_ms"], "plain_ms": bwd_rows[0]["plain_ms"],
        "bound_ms": bwd_rows[0][f"{part}_bound_ms"], "bound_by": bwd_rows[0][f"{part}_bound_by"],
        "library_ms": bwd_rows[0]["library_ms"],
    } for part, line in (("dq", 140), ("dkv", 169))] + [{
        # kernel 3 as ported one to one: no path calls it since the segment
        # kernel took its place, so its count inside train_als is 0
        "name": "fused_gather_rows",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/gather_rows.cu",
        "replaces": "predictionio_tpu/ops/train_kernel.py:324",
        "launches": seg_train["gather_launches"],
        "max_abs_err": gather_err,
        **{key: sum(r[key] for r in g32) / len(g32)
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in g32) else "operations",
    }, {
        # kernel 3 redesigned with the chunk body it fed: one iteration's
        # normal equations (both half-steps) at the main path's shape;
        # plain_ms is the chunk loop on the card; no one PyTorch call
        # computes the function
        "name": "fused_segment_normal_eq",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/segment_normal_eq.cu",
        "replaces": "predictionio_tpu/ops/train_kernel.py:324",
        "launches": seg_train["segment_launches"],
        "max_abs_err": seg_err,
        **{key: sum(r[key] for r in seg_rows) for key in ("ms", "plain_ms", "bound_ms")},
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in seg_rows) else "operations",
        "library_ms": None,
    }]}
    for k in kernels["kernels"]:
        k["cli_launches"] = cli_launches[k["name"]]
    # kernel 1 on the operators' path: the deployed server's launches from
    # readiness to the drain (serving-ops)
    kernels["kernels"][0]["ops_launches"] = ops["launches"]
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "rows": rows, "serving": serving,
                   "train_sides": list(side_rows.values()), "train_buckets": bucket_rows,
                   "train": train, "gather": gather_rows, "segment_kernel": seg_rows,
                   "train_segment": seg_train,
                   "segment_parity": seg_parity, "segment_phases_s": segment_s,
                   "flash": flash_rows, "sasrec": sasrec,
                   "flash_bwd": bwd_rows, "sasrec_train": sas_train,
                   "sasrec_train_workflow": sas_flow, "quickstart_cli": quick,
                   "serving_ops": ops,
                   **kernels}, f, indent=1)
    require(score_kernel.launches.count > 0, "kernel launched")
    print(smi, flush=True)
    emit(kernels)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
