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
             this process as the client: closed loops of 1,000 requests, Zipf
             over all 162,541 users, at concurrency 1, 16 and 64; open loops
             ``steady:rate=R,duration=3`` at 200, 800 and 3,200 req/s over
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
14. publish-eval — publish, resume and evaluate, in a fresh ``PIO_FS_BASEDIR``
             sqlite store: the full-width model of phase 4 published as a
             ``CheckpointedALSModel`` (``persistMode: "checkpoint"``) under
             ``PIO_QUANT_DTYPE=int8`` and ``bf16`` (each gate's top-100 overlap and
             seconds printed; a variant the default gate of 0.98 refuses is
             published again under ``PIO_QUANT_MIN_OVERLAP=0.95``, both printed),
             and once under a ``PIO_QUANT_MIN_OVERLAP`` above the
             measured overlap, which must leave no ``quant.blob``; ``deploy
             --batching`` of each dtype as a subprocess, whose ``GET /`` and
             ``/metrics`` must report the dtype asked for, closed loops of 500
             requests (Zipf over every user) at concurrency 1 and 64 beside phase
             13's f32 server, 300 sampled answers held against kernel 1's plain
             version at that dtype, and kernel 1's launches equal to the server's
             dispatches; ``pio batchpredict`` of 1,000 queries against the int8
             instance (kernel 1: one warm-up launch at the top rung and one a chunk of 64), each
             line held against the int8 server's answer; ``PIO_QUANT_DTYPE=f32`` at
             deploy (the rollback) and a corrupt ``quant.blob`` must serve f32, the
             latter with its warning. Then ``train_als`` on phase 9's ML-1M draw
             (ratings 1-5 drawn from the seed) for 10 iterations with checkpoints
             every 5, then 20 from the same directory: kernel 2 launches buckets ×
             10 times in the second run, whose factors must equal an uninterrupted
             20-iteration run's (bit for bit, else within rtol = atol = 1e-4), and a
             permuted copy of the draw must start fresh. SASRec at phase 11's shape
             (maxLen 256): 4 steps with checkpoints every 2, then 8 from the
             directory: the flash kernels launch 2 × 4 times after the resume, each
             step's loss within rtol 1e-5 of an uninterrupted run's (the embedding
             backward's atomics make bit equality impossible). Last ``pio eval`` of
             ``RecommendationEvaluation`` (ranks 4 and 8, 3 folds, 5 iterations,
             Precision/NDCG/MAP@10) over a random 100,000 of the ML-1M draw loaded
             with ``insert_batch``, ``--output-best``: kernel 2 launches Σ buckets ×
             5 times, kernel 1 one warm-up launch a trained model plus ⌈test users /
             64⌉ a fold, every batch-predicted answer held against ``torch.topk(U[u]
             @ V.T)`` on the CPU on that fold's factors, the EvaluationInstance
             EVALCOMPLETED in sqlite and ``best.json`` naming the best rank.
15. streaming — streaming micro-generations, in a fresh sqlite store under
             ``PIO_STREAMING=1``: the full-width model of phase 4 published
             in auto mode (f32) and in checkpoint mode under
             ``PIO_QUANT_DTYPE=int8``, both deployed with ``pio deploy
             --batching`` as subprocesses (one base fingerprint, one delta
             log); the port's ``EventServer(ingest_mode="fast")`` with its
             WAL in this process, its delta publisher on a copy of the
             model. Traffic, as ``bench.py``'s freshness bench: 10 batches of
             24 ``rate`` events for existing users (Zipf s 1.1, q 50, over
             users and items) POSTed to ``/events.json`` (each a 202), each
             folded once committed (fold, gate against the float64 solve,
             seal), its blob pushed to both replicas with ``POST /delta`` in
             place of the router; then 512 events, folded when the 512th
             commits (``PIO_DELTA_MAX_EVENTS``); all under a closed loop of
             ``/queries.json`` at concurrency 16 over both replicas, which
             must see no error. Each event is visible when both replicas
             answer its user as the plain version of kernel 1 does on U′
             (the base plus every sealed delta's rows read back from the
             log, re-quantized at int8); p50/p99 of 202 → visible, fold +
             gate + seal ms, push ms and each replica's patch time (CUDA
             events) are printed. 200 sampled answers of each replica
             against the plain version on U′; every fast-acked id read back
             from sqlite by a fresh process; a third ``pio deploy`` of the
             f32 instance must answer ``/readyz`` 200 first at the log's
             epoch and then as the first replica does; on every replica
             kernel 1's launches equal its dispatches and its warm-ups and
             kernel builds stay as at readiness.
16. ivf — IVF retrieval, in a fresh sqlite store: the full-width model of
             phase 4 published under ``PIO_IVF_NLIST=256`` (≈ √59,047) with
             the default nprobe (32) and ``PIO_IVF_MIN_RECALL`` (0.95), in
             checkpoint mode behind the recall gate (sealing ``ivf.blob`` or
             refusing with its receipt) and in auto mode with the index
             declared as ``train_als`` declares it (no gate). A refused gate
             runs ``pio ivf rebuild --nlist 256 --nprobe N`` with N doubled
             from 64 until it seals (full probing always does: recall 1.0),
             then ``POST /reload``; every recall and N is printed. Both
             instances served by ``pio deploy --batching`` (subprocesses),
             and the auto instance a third time under ``PIO_RETRIEVAL=exact``
             (the rollback: no ``pio_ivf_*`` series; the exact path's
             yardstick under the same loads). Each server:
             ``pio loadtest`` closed loops of 500 at concurrency 1 and 16
             (rung hits, the scanned fraction by rung and realized), ``pio ivf
             show``, ``GET /`` and the ``pio_ivf_*`` series of ``/metrics``;
             200 sampled answers of each, one at a time (rung 1, asserted),
             against the plain version (of the probe mode, or of the exact
             mode for the rollback) on the card, 0
             ``topk_mismatches``; kernel 1's launches equal each server's
             dispatches. Then, in this process, f32/bf16/int8 scorers at every
             rung: the probe mode at full probe (nprobe = nlist) equals the
             exact mode bit for bit and at the default nprobe equals its
             plain version, one probe-mode launch a dispatch; a streaming
             delta (2,000 user rows, 600 item rows) patched into the f32 and
             int8 IVF scorers, their answers equal to the plain version on
             the patched factors, with no warm-up or kernel build. Then
             ``bench.py``'s ``_retrieval_bench`` recipe on the port (a
             clustered Gaussian mixture from seed 16; 96 queries at b = 1,
             k = 10): at its defaults (8,192 items, rank 16, nlist 64) recall@10
             ≥ 0.95 and a scanned fraction ≤ 0.2 (the JAX gate, asserted), and
             at 262,144 items with nlist 256 (reported), with the host k-means
             seconds. Last, kernel 1's probe mode against the exact mode at b =
             1, 8 and 64 on the ML-25M index and the 262,144-item catalog: the
             dispatch (probe selection and one launch) and the launch alone
             (CUDA events), kernel 1's launches a dispatch by its counter
             (one, asserted), device µs a launch by kernel from a trace,
             the plain version, ``torch.topk(U[u] @ V_probed.T)`` over the
             probed clusters' real rows (timed only), the exact kernel on the
             whole catalog, and the bound over the probed clusters' real
             rows (the padding share, P_b·cap_pad over those rows, beside it).
17. templates — the other templates. (a) ``ur-ml25m``: the Universal
             Recommender's ``URAlgorithm.train`` (maxCorrelatorsPerItem 50,
             called directly: a sqlite read of 25 M events would take the
             run) on the card at full width, on the train phase's ML-25M draw:
             primary ``buy`` = the ratings ≥ 4.0, indicator ``view`` = every
             rating, 162,541 users × 59,047 items, so the column-blocked path
             (15 blocks of 4,096 indicator items, int8 products of up to 8
             user blocks each). Held: the first and the last column block of
             each indicator, its counts on the card equal to float64 products
             of the dense 0/1 incidence (exact integers, another route), and
             the last block to scipy's int64 counts; 256 indicator items from
             ``--seed`` (items 0 and 1 among them): their counts equal scipy's
             and their top-50 lists follow the LLR rule against float64 LLR
             of those counts; no item lists itself with a positive score in
             the primary indicator; no padded row wins; 8 seeded users'
             histories in MEMORY storage answered by ``predict`` as plain host
             code over the model's arrays answers them (rule 4). Prints the
             host prep's seconds, the block widths, each indicator's seconds,
             device µs of the scatter, the products, the LLR and the top-k
             on each indicator's first column block (one real
             ``cross_occurrence_block`` and ``score_block`` call traced by
             the profiler, grouped by aten op; the products' int8 TOP/s
             against the H100's dense 1,979), and the peak device memory. (b) ``templates-cli``: in a fresh sqlite
             store, ``QS_BULK`` events of the ML-1M draw as views (1 in 20 also
             a buy), item categories, the ``unavailableItems`` constraint,
             20,000 follows and 2,000 labeled users; then e-commerce,
             similar-product (ALS + LLR co-occurrence, ``deploy --batching``),
             the Universal Recommender, similar-user and classification (NB and
             RF; the forest also served as an engine's first algorithm and held
             against a plain walk of its trees), each through ``pio template get`` → ``build`` → ``train``
             (in this process) → ``deploy`` (a thread of this process, beside
             an in-process event server for e-commerce). Every answer equals
             the deployed instance's model's answer in this process, and the
             rankings hold by rule 4 against plain host code over the model's
             arrays; e-commerce also after a ``view`` posted through the event
             server (the event cache's invalidation drops the item at once)
             and a ``$set`` of ``unavailableItems``. Kernel 2's launches on
             each implicit-ALS ``pio train`` equal buckets × iterations;
             then every bucket of both sides of each of those trainings is
             held against kernel 2's plain version (``check_normal_eq``, the
             trained factors as operands), and the factors against a CPU
             training of the same read from the same seed (rule 4, 1e-4);
             kernel 2 in implicit mode is timed on the e-commerce data (one
             iteration's buckets, its bound, the plain version, ``torch.bmm``
             of the gathered rows, and a whole iteration).
18. fleet — replicas behind the router, in a fresh sqlite store, on the
             full-width model of phase 4. (a) ``fleet-route``: ``pio deploy
             --batching --fleet 3 --canary`` (the router on one port, its
             three replica processes on the next three, each with its own
             CUDA context on the card); each replica's deploy-to-ready
             seconds and whether it loaded kernel 1 from the build cache;
             the router process maps neither libcuda nor libtorch, and
             ``nvidia-smi --query-compute-apps`` lists the replicas and not
             the router (where it shares this machine's pid namespace);
             ``pio loadtest`` closed loops of 500 Zipf queries through the
             router at concurrency 1 and 16, beside 1,000 straight to one
             replica at the same concurrency (p50, p99); on every replica
             kernel 1's launches equal its dispatches, the replicas' queries
             sum to the router's forwarded attempts (answers, retries and
             hedges), and at concurrency 1 so do the launches; 200 answers
             through the router held against the plain version (rule 4).
             (c) ``canary``, under a closed loop of 16: ``pio fleet roll``
             onto a new generation; the same factors published in checkpoint
             mode at int8 through the quantized gate, canaried with ``pio
             canary start`` and promoted (every replica then serves int8 and
             that instance); a third generation, faulted on its replicas by
             ``server:generation:<id>`` error rules, rolled back with a
             quarantine receipt (a seeded rule fails 15% of its answers; the
             router's retries absorb them inside its 10% budget, which hedges
             share, so the few that reach a client are counted and must be
             those injected 500s); a second ``pio fleet roll`` and a kill -9 of
             one replica (a cold restart) both come back on the int8 instance;
             zero client-visible failures through the rolls and the int8 canary. (b) ``fleet-chaos``:
             this process's router and supervisor over two replicas spawned
             as the CLI spawns them; under a closed loop of 16 a seeded
             ``crash:fleet:replica`` rule SIGKILLs the replica its seed names,
             which is readmitted only while its ``/readyz`` answers 200 and
             warm; then the autoscaler (min 1, max 3, ticks of 250 ms, 8 slots
             a replica, up at 30% of them) scales up under a load step of 6 clients and down
             once it stops; zero client-visible failures. (d)
             ``tenants-pipeline``: one replica under ``PIO_TENANTS`` (A with a
             100 qps quota, B none): A's flood of 2,000 is shed with 503 and
             ``Retry-After`` while B's loop sees no failure (B's p99 alone and
             under the flood), then a ``client:tenant:A`` rule opens A's
             breaker only; one replica serving the full-width model with an
             IVF index (nlist 256) under a retrieval → ranking
             ``PIO_PIPELINE`` (2,048 candidates): 200 answers equal the exact
             top-k over their candidates (rule 4), kernel 1's filtered
             launches equal the ranking stage's calls, and a latency rule on
             ``server:pipeline:ranking`` makes answers retrieval-only, tagged
             ``degraded``, with no launch. Each sub-phase's seconds.
19. sharded — the sharded placement on one card, over a mesh of four
             placements of it: the full-width model under a plan of 4 shards
             (``build_plan(strategy="popularity")``, weights the draw's item
             counts), flat and with two host rows (the two-tier merge), at
             every rung × {f32, bf16, int8}: the answers equal the replicated
             exact kernel path's bit for bit and kernel 1 launches 4 × the
             dispatches; an exclusion mask over a third of the catalog; one
             delta (2,000 users, 600 items) patched into the shards' blocks,
             whose answers equal the patched replicated ones; the B = 64
             dispatch and kernel 1's device µs a shard beside the replicated
             kernel's. Then the CLI on 50,000 ML-1M events: ``pio train``
             under ``PIO_SHARD_COUNT=4`` in checkpoint mode, ``pio shards
             show``, ``pio deploy --batching`` (the default one-card mesh:
             ``/readyz`` says ``servingBackend: replicated`` with no
             fingerprint, and the answers equal the unsharded factors'), ``pio
             shards rebuild --shards 2``, ``POST /reload`` (200, the same
             answers), the rebuilt plan sharded on the mesh; an IVF checkpoint
             (nlist 16) under the plan serves exact sharded on the mesh.
20. ring   — sequence parallelism on one card: ``ring_flash_attention`` at
             (B·H 8, T 4,096, D 64), causal, f32, over four placements (blocks
             of 1,024): kernels 4, 5 and 6 launch once per live block pair (10
             each), the forward o and lse and the backward dq, dk, dv match
             the whole-sequence flash kernels and their plain versions; its ms
             against the whole sequence's. ``ulysses_attention`` at the same
             shape (H 8 over four ways, flash local attention). SASRec
             ``seq_parallel`` at ML-1M widths (d 50, 2 blocks, 3,416 items,
             maxLen 256, batch 128) on a {data 1, model 2} mesh of the card:
             20 steps whose loss matches the data-parallel loss of the same
             params and batch within rtol 1e-5, then 20 free-running steps of
             each, timed.
21. dist-collectives — many processes on the one card: ``chip_smoke.py
             --dist-worker DIR`` twice, gloo ranks of a ``torch.distributed``
             launch with 2 placements of ``cuda:0`` each (every number is two
             ranks time-slicing one card). ``all_gather``, ``ppermute``,
             ``all_to_all`` and ``psum`` of ``parallel/mesh.py`` on 4 blocks of
             4,096 × 64 float32 equal the one-process mesh of 4 placements bit
             for bit; ms a call, bytes staged through the host and gloo ms.
22. dist-train-ml25m — the ML-25M draw over 2 × 2 placements, dense, f32,
             rank 10, 5 iterations: each rank takes its 1/2 of the draw as the
             sharded read gives it (its users' and its items' rows; the
             tables exchanged through a sqlite model-data repository,
             ``parallel/ingest.py``), then ``train_als`` on it, the entry
             point (its placement check, the layout's checkpoint fingerprint,
             one coordinator-only save, the coordinator's removal of the
             rendezvous blobs; all asserted): kernel 2 launches buckets × 2
             local shards × 5 in each rank (asserted). The factors equal this
             process's run of the two ranks' blocks on 4 placements bit for
             bit, and its 1-placement ``train_als`` from the same initial draw
             within rtol = atol = 1e-3. s/iteration (without the save), the
             all-gather's staged bytes and ms within it, host bucketing and
             exchange s. Then the segment solver over the
             same 4 placements in one process (kernel 3′ once a shard a
             half-step, asserted).
23. dist-cli — ``pio launch -n 2`` on 100,000 ML-1M events in sqlite:
             ``train`` writes exactly one COMPLETED instance (kernel 2 in both
             ranks, as each rank's ``kernel launches`` line reports), whose
             factors equal bit for bit this process's run of the two ranks'
             blocks (the same 1/2 reads, by two threads) on 2 placements,
             and within rtol = atol = 1e-2 the one-process read of ``pio
             train`` trained on one placement from the launch's start, the
             gap no larger than that run's own distance from a float64
             training from the same start (the float32 floor);
             ``pio deploy --batching`` serves it (kernel 1
             = dispatches, answers by rule 4 against the plain version);
             ``batchpredict`` writes part files equal to a one-process run;
             e-commerce (kernel 2 implicit in both ranks); SASRec for 30 steps
             (kernels 4-6 a layer a step in each rank, as counted; each step's
             loss within rtol 1e-5 of one process's ``train_step`` on the
             same global batches from the same start); a
             worker killed with SIGKILL fails the launch with its code.
24. dist-pod — the ML-25M serving model under a pod plan of 2 groups × 2
             shards over the two ranks, driven in lockstep at every rung ×
             dtype: the answers equal the one-process pod serve bit for bit,
             kernel 1 launches 2 local shards × dispatches in each rank
             (asserted); the published pod instance deployed on that mesh
             answers ``/readyz`` and ``/queries.json`` 503 with the JAX
             server's bodies. Dispatch ms and the cross-process merge's staged
             bytes.

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
previous factors; ``phase_small_parity`` says why). LLR lists (templates):
values within 8 float32 ulp of T·ln T plus 1e-5 relative of the float64 LLR
of the exact counts, indices equal except between items whose float64
values lie within twice that (``testing.llr_topk_mismatches``); counts bit
for bit. Flash kernel: o within
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
            engine_id="default", engine_variant="default", instance_id=""):
    """Write ``model`` as a COMPLETED engine instance with its sealed blob,
    the steps the training workflow takes after training. ``pio deploy``
    looks instances up under ``engine_id`` = the engine.json's factory and
    ``engine_variant`` = its ``id``. A ``PersistentModel`` saves itself and
    the blob holds its manifest (checkpoint mode). ``instance_id`` names
    the instance (a fresh random id when empty)."""
    import datetime as dt

    from predictionio_tpu_torch.core import persistence
    from predictionio_tpu_torch.data.storage.base import EngineInstance, Model

    params = engine.params_from_variant(variant)
    algorithms = engine.make_algorithms(params)
    instances = storage.get_meta_data_engine_instances()
    now = dt.datetime.now(tz=dt.timezone.utc)
    inst = EngineInstance(
        id=instance_id, status=instances.STATUS_INIT, start_time=now, end_time=now,
        engine_id=engine_id, engine_version="default", engine_variant=engine_variant,
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


def http_json(url, body=None, method=None, timeout=60, raw=None):
    """(status, JSON body) of one request, error statuses included; ``raw``
    bytes go as ``application/octet-stream`` instead of a JSON ``body``."""
    import urllib.error

    data = raw if raw is not None else json.dumps(body).encode() if body is not None else None
    ctype = "application/octet-stream" if raw is not None else "application/json"
    req = urllib.request.Request(url, data=data, method=method, headers={"Content-Type": ctype})
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
    from predictionio_tpu_torch.parallel.ingest import _merge_part_reads
    from predictionio_tpu_torch.templates.recommendation import RecommendationEngine
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
        except (ConnectionRefusedError, TimeoutError):
            # refused, or (on some hosts, for a port just closed) no answer
            # within 5 s: either way nothing listens there
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
OPS_REQUESTS = 1000  # each closed-loop load (2,000 until the dist phases came)
OPS_CONCURRENCY = (1, 16, 64)
OPS_RATES = (200, 800, 3200)  # open-loop arrival rates, req/s
OPS_RATE_S = 3  # seconds each open-loop rate runs (6 until the fleet phase, 4 until the sharded and ring phases came)
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


# -- publish-eval: checkpoint mode, the quantized gate, resume and pio eval ----

PE_APP = "default"  # the app RecommendationEvaluation reads
PE_DTYPES = ("int8", "bf16")
PE_CONCURRENCY = (1, 64)  # closed loops of PE_REQUESTS, Zipf over every user
PE_REQUESTS = 500  # each closed loop (2,000 until the fleet phase came, 1,000 until the dist phases)
PE_BATCH_QUERIES = 1000  # pio batchpredict's input lines
PE_ALS_ITERS, PE_ALS_INTERVAL = 20, 5  # resume: 10 iterations, then 20
PE_SAS_EPOCHS, PE_SAS_INTERVAL = 8, 2  # resume: two intervals (4 steps), then 8
EVAL_RANKS, EVAL_FOLDS, EVAL_ITERS, EVAL_K = (4, 8), 3, 5, 10  # RecommendationEvaluation
EVAL_CLASS = "predictionio_tpu_torch.templates.recommendation.RecommendationEvaluation"


def write_engine_json(directory, variant_id, params):
    """``pio template get recommendation`` into ``directory``, filled with
    the app, one ALS algorithm and the engine variant's ``id``."""
    cli_run("template", "get", "recommendation", "--directory", directory)
    path = os.path.join(directory, "engine.json")
    variant = fill_engine_json(path, PE_APP, [{"name": "als", "params": params}])
    variant["id"] = variant_id
    with open(path, "w") as f:
        json.dump(variant, f, indent=2)
    return variant


def hold_topk(got_answers, U, V, users, nums, item_index, what):
    """Each answer (``itemScores`` lists) against ``torch.topk(U[u] @ V.T)``
    on the CPU, by ``topk_mismatches`` at TOL; returns the largest score gap."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.testing import topk_mismatches

    Ut, Vt = (torch.from_numpy(np.ascontiguousarray(F, np.float32)) for F in (U, V))
    k = max(nums)
    rv, ri = (t.numpy() for t in torch.topk(Ut[torch.as_tensor(users)] @ Vt.T, k, dim=1))
    bad, gap = [], 0.0
    for j, (a, n) in enumerate(zip(got_answers, nums)):
        gi = np.array([[item_index[x["item"]] for x in a]])
        gv = np.array([[x["score"] for x in a]])
        bad += topk_mismatches(gv, gi, rv[j:j + 1, :n], ri[j:j + 1, :n], TOL)
        if len(a):
            gap = max(gap, float(np.abs(gv[0] - rv[j, :len(a)]).max()))
    require(not bad, f"{what}: answers disagree with torch.topk(U[u] @ V.T): {bad[:3]}")
    return gap


def phase_publish_eval(model, seed, device, kernel_rows, ops):
    """Publish, resume and evaluate on the card: see the module docstring,
    phase 14. ``kernel_rows``: phase 3's timings (device µs a rung by
    dtype); ``ops``: phase 13's result (the f32 server's loads)."""
    import dataclasses
    import logging
    import math
    import pickle
    import shutil
    import tempfile

    import numpy as np
    import torch

    from predictionio_tpu_torch.core import checkpoint, evaluation
    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.data.batch import interactions_from_arrays
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import sqlite
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.models import als, sequential
    from predictionio_tpu_torch.ops import score_kernel, train_kernel
    from predictionio_tpu_torch.serving.query_server import QueryServer
    from predictionio_tpu_torch.templates import recommendation as rec
    from predictionio_tpu_torch.testing import topk_mismatches

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="pio-publish-eval-")
    knobs = ("PIO_FS_BASEDIR", "PIO_DEVPROF_WINDOW", "PIO_QUANT_DTYPE", "PIO_QUANT_MIN_OVERLAP",
             "PIO_QUANT_EVAL_USERS", "PIO_ALS_SOLVER", "PIO_ALS_COMPUTE_DTYPE", "PIO_RESULT_CACHE",
             "PIO_COALESCE", "PIO_HOTSET_SIZE")
    saved = {k: v for k, v in os.environ.items() if k.startswith("PIO_STORAGE_") or k in knobs}
    for k in saved:
        del os.environ[k]
    os.environ["PIO_FS_BASEDIR"] = os.path.join(tmp, "base")
    os.environ["PIO_DEVPROF_WINDOW"] = "3600"
    Storage.reset_instance()
    store.set_storage(None)
    servers, patches = [], []
    ctx = DeviceContext.create(device=device)
    out = {"phase": "publish-eval"}
    users = [model.user_map.inverse[j] for j in range(len(model.user_map))]
    item_index = {model.item_map.inverse[j]: j for j in range(len(model.item_map))}
    sample = "user=" + ",".join(users)
    query = json.dumps({"user": users[0], "num": OPS_NUM})

    def step(name, **row):
        row["t"] = time.perf_counter() - t_phase
        emit({"phase": "publish-eval", "step": name, **row})
        return row

    try:
        storage = Storage.instance()
        engine = rec.RecommendationEngine.apply()
        ckpt_model = als.CheckpointedALSModel(model.user_factors, model.item_factors,
                                              model.user_map, model.item_map, model.config)

        # 1. publish: checkpoint mode under PIO_QUANT_DTYPE, once a dtype
        def quant_record(iid):
            d = als.CheckpointedALSModel._dir(iid)
            with open(os.path.join(d, "maps.pkl"), "rb") as f:
                return pickle.load(f)["quant"], os.path.exists(os.path.join(d, "quant.blob"))

        engines, pubs = {}, {}
        for dtype in PE_DTYPES:
            engines[dtype] = os.path.join(tmp, f"engine-{dtype}")
            variant = write_engine_json(engines[dtype], dtype,
                                        {"rank": RANK, "persistMode": "checkpoint"})
            os.environ["PIO_QUANT_DTYPE"] = dtype
            t0 = time.perf_counter()
            iid = publish(storage, engine, ckpt_model, variant=variant, engine_id=ALS_FACTORY,
                          engine_variant=dtype)
            publish_s = time.perf_counter() - t0
            rec_, blob = quant_record(iid)
            # the gate at its default threshold must pass the variant
            require(rec_["dtype"] == dtype and blob, f"{dtype} publish: {rec_}, blob {blob}")
            pubs[dtype] = step("publish", dtype=dtype, instance=iid, overlap=rec_["topk_overlap"],
                               threshold=rec_["threshold"], k=rec_["k"], publish_s=publish_s)
        over = pubs["int8"]["overlap"]
        os.environ.update(PIO_QUANT_DTYPE="int8", PIO_QUANT_MIN_OVERLAP=repr(over + 1e-3))
        refuse_dir = os.path.join(tmp, "engine-refused")
        variant = write_engine_json(refuse_dir, "refused", {"rank": RANK, "persistMode": "checkpoint"})
        iid = publish(storage, engine, ckpt_model, variant=variant, engine_id=ALS_FACTORY,
                      engine_variant="refused")
        del os.environ["PIO_QUANT_DTYPE"], os.environ["PIO_QUANT_MIN_OVERLAP"]
        rec_, blob = quant_record(iid)
        require(rec_.get("refused") == "int8" and rec_["dtype"] == "f32" and not blob,
                f"a publish above the measured overlap {over}: {rec_}, blob {blob}")
        out["refused"] = step("publish-refused", threshold=over + 1e-3, record=rec_, quant_blob=blob)
        out["publish"] = pubs

        # 2. deploy --batching of each dtype: the server reports what it serves
        f32_rows = {r["concurrency"]: r for r in ops["closed"]}
        f32_rows[OPS_CONCURRENCY[-1]] = dict(ops["closed_no_feedback"], feedback=False)
        rng = np.random.default_rng(seed + 61)
        deployed = {}
        for dtype in PE_DTYPES:
            rung_us = {r["batch"]: sum(r["kernel_device_us"].values()) for r in kernel_rows
                       if r.get("case", "ml25m") == "ml25m" and r["dtype"] == dtype}
            qs = CliServer(tmp, f"deploy-{dtype}", "deploy", "--engine-dir", engines[dtype],
                           "--batching", "--device", device.type)
            servers.append(qs)
            ready_s = qs.wait_ready()

            def info(srv=qs):
                return http_json(f"{srv.base}/")[1]

            at_ready = info()
            served = at_ready["fastpath"][0]["kernel"]["factor_dtype"]
            with urllib.request.urlopen(f"{qs.base}/metrics", timeout=30) as r:
                metric_text = r.read().decode()
            require(at_ready["engineInstanceId"] == pubs[dtype]["instance"] and served == dtype
                    and f'dtype="{dtype}"' in metric_text,
                    f"deploy of the {dtype} instance serves {served}: {at_ready.get('fastpath')}")
            loads = []
            for c in PE_CONCURRENCY:
                before = info()
                rc, rep = run_loadtest_cli(
                    "--port", str(qs.port), "--query", query, "--requests", str(PE_REQUESTS),
                    "--concurrency", str(c), "--dist", "zipf", "--sample", sample)
                after = info()
                require(rc == 0 and rep["ok"] == PE_REQUESTS and rep["http5xx"] == 0,
                        f"{dtype} closed loop c={c}: exit {rc}, {rep}")
                f32 = f32_rows.get(c, {})
                loads.append(step("closed-loop", dtype=dtype, concurrency=c, qps=rep["qps"],
                                  p50_ms=rep["p50Ms"], p99_ms=rep["p99Ms"],
                                  rung_device_us=rung_us, **ops_load_row(before, after, rep, rung_us),
                                  f32_phase13={k: f32.get(k) for k in (
                                      "qps", "p50_ms", "p99_ms", "rung_hits", "feedback")}))
            picks = [(users[int(j)], int(rng.integers(1, K + 1)))
                     for j in rng.integers(0, len(users), OPS_SAMPLED)]
            answers = []
            for u, n in picks:
                status, a = http_json(f"{qs.base}/queries.json", {"user": u, "num": n})
                require(status == 200, f"{u}: {status} {a}")
                answers.append(a)
            plain = Inputs(model.user_factors, model.item_factors, dtype, device)
            u_idx = torch.tensor([model.user_map[u] for u, _ in picks], dtype=torch.int32,
                                 device=device)
            rv, ri = (t.cpu().numpy() for t in plain.plain(u_idx, K))
            del plain
            bad = []
            for j, ((_, n), a) in enumerate(zip(picks, answers)):
                got_i = np.array([[item_index[x["item"]] for x in a["itemScores"]]])
                got_v = np.array([[x["score"] for x in a["itemScores"]]])
                bad += topk_mismatches(got_v, got_i, rv[j:j + 1, :n], ri[j:j + 1, :n], TOL)
            require(not bad, f"{dtype} served answers vs the plain version at {dtype}: {bad[:3]}")
            deployed[dtype] = {"server": qs, "info": info, "at_ready": at_ready, "loads": loads,
                               "ready_s": ready_s}

        # 3. pio batchpredict against the int8 instance, its lines against
        # the int8 server's answers to the same queries
        qs = deployed["int8"]["server"]
        bq = [{"user": users[int(j)], "num": OPS_NUM}
              for j in rng.integers(0, len(users), PE_BATCH_QUERIES)]
        q_path, o_path = os.path.join(tmp, "queries.jsonl"), os.path.join(tmp, "predicted.jsonl")
        with open(q_path, "w") as f:
            f.writelines(json.dumps(q) + "\n" for q in bq)
        score_kernel.launches.reset()  # the batchpredict path's window
        t0 = time.perf_counter()
        printed = cli_run("batchpredict", "--engine-dir", engines["int8"], "--input", q_path,
                          "--output", o_path, "--device", device.type)
        bp_s = time.perf_counter() - t0
        bp_launches = score_kernel.launches.count
        with open(o_path) as f:
            lines = [json.loads(x) for x in f]
        chunks = math.ceil(PE_BATCH_QUERIES / RUNGS[-1])
        require(len(lines) == PE_BATCH_QUERIES and f"{PE_BATCH_QUERIES} predictions" in printed,
                f"batchpredict wrote {len(lines)} lines: {printed}")
        require(bp_launches == 1 + chunks,
                f"batchpredict: kernel 1 launched {bp_launches} times vs 1 warm-up "
                f"+ {chunks} chunks of {RUNGS[-1]}")
        bad, exact = [], 0
        for q, line in zip(bq, lines):
            require(line["query"] == q, f"line order: {line['query']} vs {q}")
            ref = http_json(f"{qs.base}/queries.json", q)[1]["itemScores"]
            got = line["prediction"]["itemScores"]
            exact += got == ref
            bad += topk_mismatches(
                np.array([[x["score"] for x in got]]), np.array([[item_index[x["item"]] for x in got]]),
                np.array([[x["score"] for x in ref]]), np.array([[item_index[x["item"]] for x in ref]]),
                TOL)
        require(not bad, f"batchpredict lines vs the int8 server's answers: {bad[:3]}")
        out["batchpredict"] = step("batchpredict", queries=PE_BATCH_QUERIES, wall_s=bp_s,
                                   launches=bp_launches, chunks=chunks,
                                   lines_equal_to_server=exact, topk_mismatches=0)

        # the two servers' counters over everything they served
        out["deploy"] = {}
        for dtype in PE_DTYPES:
            dep = deployed[dtype]
            final = dep["info"]()
            launches = final["scoreKernelLaunches"] - dep["at_ready"]["scoreKernelLaunches"]
            dispatches = final["fastpath"][0]["calls"] - dep["at_ready"]["fastpath"][0]["calls"]
            require(launches == dispatches > 0,
                    f"{dtype}: kernel 1 launched {launches} times vs {dispatches} dispatches")
            cli_run("undeploy", "--port", str(dep["server"].port))
            dep["server"].wait_exit()
            out["deploy"][dtype] = {"deploy_to_ready_s": dep["ready_s"], "served_dtype": dtype,
                                    "resident_factor_bytes": dep["at_ready"]["fastpath"][0]["kernel"]
                                    ["resident_factor_bytes"],
                                    "launches": launches, "dispatches": dispatches,
                                    "sampled": OPS_SAMPLED, "topk_mismatches": 0,
                                    "closed": dep["loads"]}

        # 4. the rollback and a corrupt quant.blob, deployed in this process
        def served_dtype(variant_id):
            qsrv = QueryServer(engine, storage=storage, ctx=ctx, engine_id=ALS_FACTORY,
                               engine_variant=variant_id, batching=True)
            base = f"http://127.0.0.1:{qsrv.start('127.0.0.1', 0)}"
            try:
                return http_json(f"{base}/")[1]["fastpath"][0]["kernel"]["factor_dtype"]
            finally:
                qsrv.stop()

        os.environ["PIO_QUANT_DTYPE"] = "f32"
        try:
            rollback = served_dtype("int8")
        finally:
            del os.environ["PIO_QUANT_DTYPE"]
        blob = os.path.join(als.CheckpointedALSModel._dir(pubs["int8"]["instance"]), "quant.blob")
        with open(blob, "rb") as f:
            data = f.read()
        with open(blob, "wb") as f:
            f.write(data[:-7] + b"garbage")
        warned = []
        handler = logging.Handler()
        handler.emit = lambda record: warned.append(record.getMessage())
        logging.getLogger("predictionio_tpu_torch.models.als").addHandler(handler)
        try:
            corrupt = served_dtype("int8")
        finally:
            logging.getLogger("predictionio_tpu_torch.models.als").removeHandler(handler)
        require(rollback == "f32" and corrupt == "f32"
                and any("quantized factors unavailable" in m for m in warned),
                f"rollback serves {rollback}, a corrupt quant.blob {corrupt}, warnings {warned}")
        out["degrade"] = step("degrade", rollback_serves=rollback, corrupt_blob_serves=corrupt,
                              warning=next(m for m in warned if "unavailable" in m))

        # 5. ALS resume on phase 9's ML-1M draw (ratings 1-5 drawn from the seed)
        inter, _ = ml1m_interactions(seed)
        inter = dataclasses.replace(inter, rating=np.random.default_rng(seed + 62).integers(
            1, 6, len(inter.user)).astype(np.float32))

        def als_cfg(iters, d=None):
            return als.ALSConfig(rank=RANK, iterations=iters, checkpoint_dir=d,
                                 checkpoint_interval=PE_ALS_INTERVAL, solver="dense",
                                 compute_dtype="f32")

        def buckets(data, cfg):
            ub, ib, _, _ = als._dense_blocks_for(data, cfg)
            return len(ub.widths) + len(ib.widths)

        n_buckets = buckets(inter, als_cfg(PE_ALS_ITERS))
        d = os.path.join(tmp, "als-checkpoints")
        half = PE_ALS_ITERS // 2
        runs = {}
        for name, data, cfg in (("first", inter, als_cfg(half, d)),
                                ("resumed", inter, als_cfg(PE_ALS_ITERS, d)),
                                ("uninterrupted", inter, als_cfg(PE_ALS_ITERS))):
            train_kernel.launches.reset()
            t0 = time.perf_counter()
            m = als.train_als(ctx, data, cfg)
            runs[name] = (m, train_kernel.launches.count, time.perf_counter() - t0)
            if name == "first":
                steps_after_first = checkpoint.CheckpointManager(d).steps()
        (first, l_first, _), (resumed, l_resumed, s_resumed), (full, _, s_full) = (
            runs["first"], runs["resumed"], runs["uninterrupted"])
        require(steps_after_first == [half - PE_ALS_INTERVAL, half] and l_first == n_buckets * half,
                f"first run: steps {steps_after_first}, {l_first} launches")
        require(l_resumed == n_buckets * (PE_ALS_ITERS - half),
                f"resumed run launched kernel 2 {l_resumed} times vs {n_buckets} buckets × "
                f"{PE_ALS_ITERS - half}: it did not resume at step {half}")
        bit_equal = all(np.array_equal(a, b) for a, b in (
            (resumed.user_factors, full.user_factors), (resumed.item_factors, full.item_factors)))
        gap = max(float(np.abs(resumed.user_factors - full.user_factors).max()),
                  float(np.abs(resumed.item_factors - full.item_factors).max()))
        require(bit_equal or all(np.allclose(a, b, rtol=1e-4, atol=1e-4) for a, b in (
            (resumed.user_factors, full.user_factors), (resumed.item_factors, full.item_factors))),
            f"resumed factors vs the uninterrupted run: largest gap {gap}")
        perm = np.random.default_rng(seed + 63).permutation(len(inter.user))
        permuted = dataclasses.replace(inter, user=inter.user[perm], item=inter.item[perm],
                                       rating=inter.rating[perm], t=inter.t[perm])
        train_kernel.launches.reset()
        als.train_als(ctx, permuted, als_cfg(PE_ALS_ITERS, d))
        l_perm = train_kernel.launches.count
        n_perm = buckets(permuted, als_cfg(PE_ALS_ITERS))
        require(l_perm == n_perm * PE_ALS_ITERS,
                f"a permuted copy launched {l_perm} times vs {n_perm} × {PE_ALS_ITERS}: it resumed")
        out["resume_als"] = step("resume-als", ratings=len(inter), buckets=n_buckets,
                                 launches_first=l_first, launches_resumed=l_resumed,
                                 resumed_at=half, bit_equal=bit_equal, max_abs_gap=gap,
                                 resumed_s=s_resumed, uninterrupted_s=s_full,
                                 permuted_launches=l_perm, permuted_resumed=False)
        del runs, first, resumed, full, permuted

        # 6. SASRec resume at phase 11's shape (maxLen 256)
        srng = np.random.default_rng(seed + 15)  # phase_sasrec_train_workflow's draw
        w = zipf_mandelbrot_weights(1000, 1.1)
        hist = [srng.choice(1000, int(srng.integers(20, 301)), p=w) for _ in range(300)]
        s_user = np.repeat(np.arange(300), [len(h) for h in hist])
        s_t = np.concatenate([np.arange(len(h), dtype=np.float64) for h in hist])
        s_inter = interactions_from_arrays(
            s_user, np.concatenate(hist), np.ones(len(s_user)), 1_767_225_600.0 + s_t,
            (f"wu{u}" for u in range(300)), (f"wi{i}" for i in range(1000)))
        scfg = sequential.SASRecConfig(d_model=SAS_D, n_layers=SAS_LAYERS, n_heads=SAS_HEADS,
                                       max_len=SAS_MAX_LEN, batch_size=SAS_BATCH, lr=SAS_LR,
                                       seed=seed, epochs=PE_SAS_EPOCHS)
        sd = os.path.join(tmp, "sasrec-checkpoints")
        stop_at = 2 * PE_SAS_INTERVAL
        full_s = sequential.train_sasrec(ctx, s_inter, scfg)
        sequential.train_sasrec(ctx, s_inter, dataclasses.replace(
            scfg, epochs=stop_at, checkpoint_dir=sd, checkpoint_interval=PE_SAS_INTERVAL))
        reset_flash_counts()  # the resumed run's window
        resumed_s = sequential.train_sasrec(ctx, s_inter, dataclasses.replace(
            scfg, checkpoint_dir=sd, checkpoint_interval=PE_SAS_INTERVAL))
        counts = flash_counts()
        want = SAS_LAYERS * (PE_SAS_EPOCHS - stop_at)
        require(counts == {"fwd": want, "bwd_dq": want, "bwd_dkv": want},
                f"resumed SASRec flash launches {counts} vs {SAS_LAYERS} layers × "
                f"{PE_SAS_EPOCHS - stop_at} steps")
        rel = np.abs(resumed_s.losses - full_s.losses[stop_at:]) / np.abs(full_s.losses[stop_at:])
        require(len(resumed_s.losses) == PE_SAS_EPOCHS - stop_at and float(rel.max()) <= 1e-5,
                f"resumed losses {resumed_s.losses} vs {full_s.losses[stop_at:]}")
        out["resume_sasrec"] = step("resume-sasrec", events=len(s_user), stopped_at=stop_at,
                                    epochs=PE_SAS_EPOCHS, launches=counts,
                                    loss_max_rel_gap=float(rel.max()),
                                    losses_resumed=[float(x) for x in resumed_s.losses],
                                    losses_uninterrupted=[float(x) for x in full_s.losses])

        # 7. pio eval: a random QS_BULK of the ML-1M draw in sqlite
        cli_run("app", "new", PE_APP)
        app_id = storage.get_meta_data_apps().get_by_name(PE_APP).id
        erng = np.random.default_rng(seed + 21)  # the quickstart's cut
        pick = np.sort(erng.choice(len(inter.user), QS_BULK, replace=False))
        buy = erng.integers(0, QS_BUY_EVERY, QS_BULK) == 0
        stars = erng.integers(1, 6, QS_BULK)
        le = storage.get_l_events()
        t0 = time.perf_counter()
        for c in range(0, QS_BULK, QS_BULK_CHUNK):
            le.insert_batch([
                Event(event="buy" if buy[k] else "rate", entity_type="user",
                      entity_id=f"u{inter.user[pick[k]]}", target_entity_type="item",
                      target_entity_id=f"si{inter.item[pick[k]]}",
                      properties=None if buy[k] else {"rating": int(stars[k])},
                      event_time=float(inter.t[pick[k]]), creation_time=float(inter.t[pick[k]]))
                for k in range(c, min(c + QS_BULK_CHUNK, QS_BULK))], app_id)
        load_s = time.perf_counter() - t0
        del inter
        trained, predicted, reads, results = [], [], [], []
        orig_train, orig_bp = rec.train_als, rec.ALSAlgorithm.batch_predict
        orig_read = rec.RecommendationDataSource.read_eval
        orig_eval = evaluation.MetricEvaluator.evaluate_base

        def timed(log, fn):
            def wrapped(*a, **kw):
                t = time.perf_counter()
                r = fn(*a, **kw)
                log.append((a, r, time.perf_counter() - t))
                return r
            return wrapped

        patches += [(rec, "train_als", orig_train),
                    (rec.ALSAlgorithm, "batch_predict", orig_bp),
                    (rec.RecommendationDataSource, "read_eval", orig_read),
                    (evaluation.MetricEvaluator, "evaluate_base", orig_eval)]
        rec.train_als = timed(trained, orig_train)
        rec.ALSAlgorithm.batch_predict = timed(predicted, orig_bp)
        rec.RecommendationDataSource.read_eval = timed(reads, orig_read)
        evaluation.MetricEvaluator.evaluate_base = timed(results, orig_eval)
        score_kernel.launches.reset()  # the eval path's window
        train_kernel.launches.reset()
        best_path = os.path.join(tmp, "best.json")
        t0 = time.perf_counter()
        printed = cli_run("eval", EVAL_CLASS, "--output-best", best_path, "--device", device.type)
        eval_s = time.perf_counter() - t0
        k1, k2 = score_kernel.launches.count, train_kernel.launches.count
        for obj, name, fn in patches:
            setattr(obj, name, fn)
        patches.clear()
        require(len(reads) == 1 and len(trained) == len(EVAL_RANKS) * EVAL_FOLDS
                and len(predicted) == len(EVAL_RANKS) * EVAL_FOLDS,
                f"{len(reads)} reads, {len(trained)} trainings, {len(predicted)} batch predictions")
        want_k2 = sum(buckets(a[1], a[2]) * a[2].iterations for a, _, _ in trained)
        chunk_calls = sum(math.ceil(len(a[2]) / RUNGS[-1]) for a, _, _ in predicted)
        want_k1 = len(predicted) + chunk_calls  # a top-rung warm-up a trained model
        require(k2 == want_k2, f"pio eval: kernel 2 launched {k2} times vs Σ buckets × "
                               f"{EVAL_ITERS} = {want_k2}")
        require(k1 == want_k1, f"pio eval: kernel 1 launched {k1} times vs {len(predicted)} "
                               f"warm-ups + {chunk_calls} chunks")
        gap = 0.0
        for (algo, m, queries), answers, _ in predicted:
            got = dict(answers)
            gap = max(gap, hold_topk(
                [[{"item": s.item, "score": s.score} for s in got[i].itemScores] for i, _ in queries],
                m.user_factors, m.item_factors, [m.user_map[q.user] for _, q in queries],
                [q.num for _, q in queries],
                {m.item_map.inverse[j]: j for j in range(len(m.item_map))}, "pio eval"))
        iid = printed.split("Instance ID: ")[1].split()[0]
        inst = storage.get_meta_data_evaluation_instances().get(iid)
        with open(best_path) as f:
            best = json.load(f)
        result = results[0][1]
        scores = [r.score for r in result.all_results]
        best_rank = best["bestEngineParams"]["algorithmParamsList"][0]["params"]["rank"]
        require(inst is not None and inst.status == "EVALCOMPLETED"
                and json.loads(inst.evaluator_results_json) == best
                and best_rank == EVAL_RANKS[int(np.argmax(scores))],
                f"evaluation instance {inst and inst.status}, best rank {best_rank}, scores {scores}")
        headers = [result_metric.header for result_metric in
                   [rec.PrecisionAtK(EVAL_K), rec.NDCGAtK(EVAL_K), rec.MAPAtK(EVAL_K)]]
        candidates = [{"rank": rank, **dict(zip(headers, [r.score] + list(r.other_scores)))}
                      for rank, r in zip(EVAL_RANKS, result.all_results)]
        train_s = sum(s for _, _, s in trained)
        predict_s = sum(s for _, _, s in predicted)
        out["eval"] = step(
            "pio-eval", events=QS_BULK, bulk_insert_s=load_s, candidates=candidates,
            best_rank=best_rank, instance=iid, wall_s=eval_s, read_eval_s=reads[0][2],
            train_s=train_s, batch_predict_s=predict_s,
            rest_s=eval_s - reads[0][2] - train_s - predict_s,
            test_users=[len(a[2]) for a, _, _ in predicted[:EVAL_FOLDS]],
            kernel2_launches=k2, kernel1_launches=k1, kernel1_chunks=chunk_calls,
            kernel1_warmups=len(predicted), max_abs_err_answers=gap)
    finally:
        for obj, name, fn in patches:
            setattr(obj, name, fn)
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


# -- streaming micro-generations (phase 15) -----------------------------------


ST_BATCHES, ST_PER_BATCH = 10, 24  # bench.py's freshness defaults: batches × rate events
ST_MAX_EVENTS = 512  # PIO_DELTA_MAX_EVENTS: the size-triggered fold
ST_CONCURRENCY = 16  # the closed loop of /queries.json while the deltas land
ST_SAMPLED = 200  # answers a server holds against the plain version at the end
ST_VISIBLE_S = 10.0  # an event not visible this long after its delta's push fails
ST_APP = "StreamApp"


def phase_streaming(model, seed, device):
    """Streaming micro-generations on the card: see the module docstring,
    phase 15."""
    import copy
    import http.client
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from predictionio_tpu_torch.core import delta as delta_mod
    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.data.api.event_server import EventServer
    from predictionio_tpu_torch.data.storage import sqlite
    from predictionio_tpu_torch.data.storage.base import AccessKey, App
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.ops.quantize import quantize_factors
    from predictionio_tpu_torch.templates import recommendation as rec
    from predictionio_tpu_torch.testing import topk_mismatches

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="pio-streaming-")
    knobs = ("PIO_FS_BASEDIR", "PIO_STREAMING", "PIO_DELTA_DIR", "PIO_DELTA_CATCHUP_MS",
             "PIO_DELTA_FLUSH_MS", "PIO_DELTA_MAX_EVENTS", "PIO_DELTA_MIN_OVERLAP",
             "PIO_DELTA_GATE_SAMPLE", "PIO_FRESHNESS_SLO_MS", "PIO_QUANT_DTYPE",
             "PIO_QUANT_MIN_OVERLAP", "PIO_RESULT_CACHE", "PIO_COALESCE", "PIO_HOTSET_SIZE",
             "PIO_INGEST_BUFFER", "PIO_WAL_DIR", "PIO_ALS_SOLVER", "PIO_ALS_COMPUTE_DTYPE")
    saved = {k: v for k, v in os.environ.items() if k.startswith("PIO_STORAGE_") or k in knobs}
    for k in saved:
        del os.environ[k]
    os.environ.update(
        PIO_FS_BASEDIR=os.path.join(tmp, "base"), PIO_STREAMING="1",
        PIO_DELTA_DIR=os.path.join(tmp, "deltas"),
        # the push is the path measured (the router's hop): the replicas'
        # catch-up poll and the publisher's paced flush are parked, and the
        # phase folds each batch as soon as it has committed, as bench.py does
        PIO_DELTA_CATCHUP_MS="60000", PIO_DELTA_FLUSH_MS="60000")
    Storage.reset_instance()
    store.set_storage(None)
    servers, es, stop_load, loaders = [], None, threading.Event(), []
    out = {"phase": "streaming"}
    users = [model.user_map.inverse[j] for j in range(len(model.user_map))]
    items = [model.item_map.inverse[j] for j in range(len(model.item_map))]
    item_index = {it: j for j, it in enumerate(items)}

    def step(name, **row):
        row["t"] = time.perf_counter() - t_phase
        emit({"phase": "streaming", "step": name, **row})
        return row

    try:
        storage = Storage.instance()
        engine = rec.RecommendationEngine.apply()
        # 1. publish the base generation twice: f32 (auto mode) and int8
        # (checkpoint mode, through the quantized gate); deploy both
        dirs = {d: os.path.join(tmp, f"engine-{d}") for d in ("f32", "int8")}
        inst = {"f32": publish(storage, engine, model, engine_id=ALS_FACTORY, engine_variant="f32",
                               variant=write_engine_json(dirs["f32"], "f32", {"rank": RANK}))}
        os.environ["PIO_QUANT_DTYPE"] = "int8"
        ckpt = als.CheckpointedALSModel(model.user_factors, model.item_factors, model.user_map,
                                        model.item_map, model.config)
        inst["int8"] = publish(storage, engine, ckpt, engine_id=ALS_FACTORY, engine_variant="int8",
                               variant=write_engine_json(dirs["int8"], "int8",
                                                         {"rank": RANK, "persistMode": "checkpoint"}))
        del os.environ["PIO_QUANT_DTYPE"]
        deploy = {d: CliServer(tmp, f"stream-{d}", "deploy", "--engine-dir", dirs[d], "--batching",
                               "--device", device.type) for d in dirs}
        servers += deploy.values()
        ready_s = {d: srv.wait_ready() for d, srv in deploy.items()}
        fp = delta_mod.model_fingerprint(model.user_factors, model.item_factors)
        at_ready = {}
        for d, srv in deploy.items():
            info = http_json(f"{srv.base}/")[1]
            dstats = http_json(f"{srv.base}/delta/stats")[1]
            served = info["fastpath"][0]["kernel"]["factor_dtype"]
            require(served == d and dstats["fingerprint"] == fp and dstats["applied_epoch"] == 0,
                    f"{d} replica serves {served}, fingerprint {dstats.get('fingerprint')} vs {fp}")
            at_ready[d] = info
        log = delta_mod.DeltaLog(dstats["dir"])
        step("deploy", ready_s=ready_s, fingerprint=fp, instances=inst, delta_dir=dstats["dir"])

        # 2. the event plane: the fast-ack event server in this process, its
        # publisher on its own copy of the base generation
        app_id = storage.get_meta_data_apps().insert(App(0, ST_APP))
        key = storage.get_meta_data_access_keys().insert(AccessKey("", app_id, []))
        es = EventServer(storage=storage, ingest_mode="fast", wal_dir=os.path.join(tmp, "wal"),
                         ingest_flush_ms=5.0, telemetry=False)
        es_base = f"http://127.0.0.1:{es.start('127.0.0.1', 0)}"
        sealed_at = {}
        pub = es.enable_delta_publisher(
            copy.deepcopy(model), max_events=ST_MAX_EVENTS,
            on_receipt=lambda r: sealed_at.setdefault(r.get("epoch"), (time.perf_counter(), r)))
        require(pub is not None and pub.base_fingerprint == fp and pub.log.directory == log.directory,
                f"publisher base {pub and pub.base_fingerprint} vs the replicas' {fp}")

        # U′ on the card, as each replica should hold it: the base, patched
        # with every sealed delta's rows read back from the log
        truth = {d: Inputs(model.user_factors, model.item_factors, d, device) for d in dirs}

        def land(dl):
            idx = torch.from_numpy(np.asarray(dl.user_idx, np.int64)).to(device)
            for d, inp in truth.items():
                q, s = quantize_factors(dl.user_rows, d)
                inp.U[idx] = torch.from_numpy(q).to(device)
                if s is not None:
                    inp.us[idx] = torch.from_numpy(s).to(device)

        def want(d, uidx, num):
            vals, idx = truth[d].plain(torch.tensor(uidx, dtype=torch.int32, device=device), num)
            return vals.cpu().numpy(), idx.cpu().numpy()

        def post(conn, path, body):
            conn.request("POST", path, body=json.dumps(body),
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            return r.status, json.loads(r.read())

        # 3. a closed loop of /queries.json at concurrency 16 over both
        # replicas (Zipf over every user) while the deltas land
        w_users = zipf_mandelbrot_weights(len(users), 1.1)
        w_items = zipf_mandelbrot_weights(len(items), 1.1)
        load = {"ok": 0, "errors": 0, "error_samples": []}
        load_lock = threading.Lock()

        def loader(t):
            srv = list(deploy.values())[t % 2]
            draws = np.random.default_rng(seed + 1500 + t).choice(len(users), 20_000, p=w_users)
            conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
            n = 0
            while not stop_load.is_set():
                u = users[int(draws[n % len(draws)])]
                n += 1
                try:
                    status, body = post(conn, "/queries.json", {"user": u, "num": OPS_NUM})
                    ok = status == 200 and len(body["itemScores"]) == OPS_NUM
                except Exception as e:  # a dropped connection counts, then reconnects
                    conn.close()
                    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
                    ok, body = False, repr(e)
                with load_lock:
                    load["ok" if ok else "errors"] += 1
                    if not ok and len(load["error_samples"]) < 5:
                        load["error_samples"].append(str(body)[:300])
            conn.close()

        loaders += [threading.Thread(target=loader, args=(t,), daemon=True)
                    for t in range(ST_CONCURRENCY)]
        for t in loaders:
            t.start()

        # 4. the traffic: batches of rate events for existing users (Zipf),
        # each folded once committed, pushed to both replicas, then watched
        # until every event's user is answered from the patched rows
        erng = np.random.default_rng(seed + 1501)
        es_conn = http.client.HTTPConnection("127.0.0.1", int(es_base.rsplit(":", 1)[1]), timeout=30)
        acked, visible, epochs = [], {}, []
        poll = ThreadPoolExecutor(8)

        def visible_at(d, u, wv, wi, deadline):
            """perf_counter of the first answer for ``u`` on replica ``d``
            that equals the plain version on U′ (``wv``, ``wi``)."""
            conn = http.client.HTTPConnection("127.0.0.1", deploy[d].port, timeout=30)
            try:
                while time.perf_counter() < deadline:
                    status, a = post(conn, "/queries.json", {"user": u, "num": OPS_NUM})
                    now = time.perf_counter()
                    if status == 200:
                        gi = np.array([[item_index[x["item"]] for x in a["itemScores"]]])
                        gv = np.array([[x["score"] for x in a["itemScores"]]])
                        if not topk_mismatches(gv, gi, wv, wi, TOL):
                            return now
            finally:
                conn.close()
            return None

        def run_epoch(n_events, batch_no):
            uu = erng.choice(len(users), n_events, p=w_users)
            ii = erng.choice(len(items), n_events, p=w_items)
            rr = erng.integers(1, 6, n_events)
            epoch = log.last_epoch() + 1
            t_ack = []
            for j in range(n_events):
                eid = f"st-{batch_no:02d}-{j:04d}"
                status, body = post(es_conn, f"/events.json?accessKey={key}", {
                    "event": "rate", "entityType": "user", "entityId": users[uu[j]],
                    "targetEntityType": "item", "targetEntityId": items[ii[j]],
                    "properties": {"rating": int(rr[j])}, "eventId": eid})
                require(status == 202 and body["eventId"] == eid, f"POST {eid}: {status} {body}")
                t_ack.append(time.perf_counter())
                acked.append(eid)
            t_last = t_ack[-1]
            if n_events >= ST_MAX_EVENTS:
                # the size-triggered fold runs inline on the ingest flusher
                deadline = time.perf_counter() + 60
                while epoch not in sealed_at and time.perf_counter() < deadline:
                    time.sleep(0.001)
                t_committed = None
                require(epoch in sealed_at, f"the {n_events}-event fold never sealed")
                t_sealed, receipt = sealed_at[epoch]
                seal_ms = None
            else:
                deadline = time.perf_counter() + 30
                while pub.pending() < n_events and time.perf_counter() < deadline:
                    time.sleep(0.0005)
                t_committed = time.perf_counter()
                receipt = pub.flush()
                t_sealed = time.perf_counter()
                seal_ms = (t_sealed - t_committed) * 1e3
            require(bool(receipt and receipt.get("sealed")) and receipt["epoch"] == epoch,
                    f"batch {batch_no}: {receipt}")
            blob = open(log.path(epoch), "rb").read()
            land(log.read(epoch))
            push_ms, apply = {}, {}
            for d, srv in deploy.items():
                t0 = time.perf_counter()
                status, ack = http_json(f"{srv.base}/delta", method="POST", raw=blob)
                push_ms[d] = (time.perf_counter() - t0) * 1e3
                require(status == 200 and ack.get("applied") and ack["epoch"] == epoch,
                        f"{d} replica's ack of epoch {epoch}: {status} {ack}")
                apply[d] = http_json(f"{srv.base}/delta/stats")[1]["last_apply"]
                require(apply[d]["warmup_executions"]
                        == at_ready[d]["fastpath"][0]["kernel"]["warmup_executions"]
                        and apply[d]["kernel_builds"] == at_ready[d]["kernelBuilds"],
                        f"{d} replica warmed or built again at epoch {epoch}: {apply[d]}")
            t_pushed = time.perf_counter()
            deadline = t_pushed + ST_VISIBLE_S
            uniq = sorted(set(int(u) for u in uu))
            expect = {d: want(d, uniq, OPS_NUM) for d in dirs}
            seen = {(d, u): poll.submit(visible_at, d, users[u], expect[d][0][j:j + 1],
                                        expect[d][1][j:j + 1], deadline)
                    for d in dirs for j, u in enumerate(uniq)}
            first = {}
            for (d, u), f in seen.items():
                t = f.result()
                require(t is not None, f"epoch {epoch}: {users[u]} never answered from U′ on {d}")
                first[u] = max(first.get(u, 0.0), t)
            vis = [(first[int(u)] - ta) * 1e3 for u, ta in zip(uu, t_ack)]
            visible.setdefault("fold" if n_events >= ST_MAX_EVENTS else "batches", []).extend(vis)
            row = {"epoch": epoch, "events": n_events, "users": int(receipt["users"]),
                   "overlap": receipt["overlap"],
                   "commit_ms": None if t_committed is None else (t_committed - t_last) * 1e3,
                   "fold_gate_seal_ms": seal_ms, "last_ack_to_sealed_ms": (t_sealed - t_last) * 1e3,
                   "push_ms": push_ms, "apply_device_ms": {d: a["device_ms"] for d, a in apply.items()},
                   "visible_ms_max": max(vis), "visible_ms_min": min(vis)}
            epochs.append(row)
            return row

        for b in range(ST_BATCHES):
            step("epoch", **run_epoch(ST_PER_BATCH, b))
        step("epoch", **run_epoch(ST_MAX_EVENTS, ST_BATCHES))
        stop_load.set()
        for t in loaders:
            t.join(60)
        poll.shutdown()
        es_conn.close()
        require(load["errors"] == 0 and load["ok"] > 0,
                f"query errors while the deltas landed: {load}")
        head = log.last_epoch()
        require(head == ST_BATCHES + 1 and pub.stats()["sealed"] == head,
                f"log epoch {head}, publisher {pub.stats()}")

        # 5. sampled answers of both replicas against the plain version on U′
        srng = np.random.default_rng(seed + 1502)
        patched = sorted(set().union(*(set(log.read(e).user_idx.tolist()) for e in log.epochs())))
        sample = list(srng.choice(patched, ST_SAMPLED // 2, replace=False)) + \
            list(srng.integers(0, len(users), ST_SAMPLED // 2))
        mism = {}
        for d, srv in deploy.items():
            wv, wi = want(d, [int(u) for u in sample], K)
            bad = []
            for j, u in enumerate(sample):
                n = 1 + j % K
                status, a = http_json(f"{srv.base}/queries.json", {"user": users[int(u)], "num": n})
                require(status == 200, f"{d}: {status} {a}")
                gi = np.array([[item_index[x["item"]] for x in a["itemScores"]]])
                gv = np.array([[x["score"] for x in a["itemScores"]]])
                bad += topk_mismatches(gv, gi, wv[j:j + 1, :n], wi[j:j + 1, :n], TOL)
            mism[d] = len(bad)
            require(not bad, f"{d} replica vs torch.topk(U′[u] @ V.T): {bad[:3]}")

        # 6. the event plane drains; a fresh process reads every acked id back
        es.stop()
        es = None
        probe = subprocess.run(
            [sys.executable, "-c", (
                "import json, sys; sys.modules['jax'] = None\n"
                "from predictionio_tpu_torch.data.storage.registry import Storage\n"
                f"ids = [e.event_id for e in Storage().get_l_events().find({app_id})]\n"
                "print(json.dumps(ids))")],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
            timeout=120)
        require(probe.returncode == 0, f"fresh reader: {probe.stderr[-2000:]}")
        stored = set(json.loads(probe.stdout.strip().splitlines()[-1]))
        lost = [i for i in acked if i not in stored]
        require(not lost, f"{len(lost)} fast-acked events lost: {lost[:5]}")

        # 7. a restarted replica: ready only at the log's epoch, then answers
        # as the first f32 replica does
        again = CliServer(tmp, "stream-restart", "deploy", "--engine-dir", dirs["f32"],
                          "--batching", "--device", device.type)
        servers.append(again)
        t_end, first_ready = time.monotonic() + 300, None
        while first_ready is None and time.monotonic() < t_end:
            require(again.proc.poll() is None, f"restart exited: {again.tail()}")
            try:
                status, rz = http_json(f"{again.base}/readyz", timeout=5)
                if status == 200:
                    first_ready = rz
            except OSError:
                time.sleep(0.02)
        require(first_ready is not None and first_ready["deltaEpoch"] == head
                and first_ready["deltaLogEpoch"] == head,
                f"restarted replica's first ready answer: {first_ready}")
        restart_at = http_json(f"{again.base}/")[1]
        same = 0
        for u in sample[: ST_SAMPLED // 2]:
            q = {"user": users[int(u)], "num": OPS_NUM}
            a, b = (http_json(f"{s.base}/queries.json", q)[1] for s in (again, deploy["f32"]))
            require(a["itemScores"] == b["itemScores"], f"restart vs first replica for {q}: {a} {b}")
            same += 1

        # 8. kernel 1 on each replica: launches = dispatches; no warm-up or build
        launches = {}
        for d, srv, start in (("f32", deploy["f32"], at_ready["f32"]),
                              ("int8", deploy["int8"], at_ready["int8"]),
                              ("restart", again, restart_at)):
            final = http_json(f"{srv.base}/")[1]
            n = final["scoreKernelLaunches"] - start["scoreKernelLaunches"]
            calls = final["fastpath"][0]["calls"] - start["fastpath"][0]["calls"]
            require(n == calls > 0, f"{d}: kernel 1 launched {n} times vs {calls} dispatches")
            require(final["fastpath"][0]["kernel"]["warmup_executions"]
                    == start["fastpath"][0]["kernel"]["warmup_executions"]
                    and final["kernelBuilds"] == start["kernelBuilds"],
                    f"{d}: warm-ups or builds moved: {final['fastpath'][0]['kernel']}")
            launches[d] = {"launches": n, "dispatches": calls,
                           "deltas": final["fastpath"][0]["deltas"]}
            cli_run("undeploy", "--port", str(srv.port))
            srv.wait_exit()
        seal = [r["fold_gate_seal_ms"] for r in epochs if r["fold_gate_seal_ms"] is not None]
        applies = {d: [r["apply_device_ms"][d] for r in epochs] for d in dirs}
        out.update(
            batches=ST_BATCHES, events_per_batch=ST_PER_BATCH, size_fold_events=ST_MAX_EVENTS,
            concurrency=ST_CONCURRENCY, events=len(acked), epochs_sealed=head,
            epochs_applied={d: head for d in dirs}, lost_acked_events=len(lost),
            query_ok=load["ok"], query_errors=load["errors"],
            # 202 → answered from U′: the 24-event batches, then the
            # size-triggered fold, whose first events wait for its last
            visible_ms={kind: {"p50": float(np.percentile(v, 50)), "p99": float(np.percentile(v, 99)),
                               "max": float(max(v)), "n": len(v)} for kind, v in visible.items()},
            fold_gate_seal_ms={"median": float(np.median(seal)), "max": float(max(seal))},
            size_fold_ms=epochs[-1]["last_ack_to_sealed_ms"],
            apply_device_ms={d: {"median": float(np.median(v)), "max": float(max(v))}
                             for d, v in applies.items()},
            push_ms={d: float(np.median([r["push_ms"][d] for r in epochs])) for d in dirs},
            topk_mismatches=mism, sampled=ST_SAMPLED, restart_first_ready=first_ready,
            restart_answers_equal=same, kernel1=launches, deploy_to_ready_s=ready_s,
            epochs=epochs)
    finally:
        stop_load.set()
        for t in loaders:
            t.join(10)
        if es is not None:
            es.stop()
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


# -- IVF retrieval ------------------------------------------------------------


IVF_NLIST = 256  # ≈ √59,047 clusters for the ML-25M catalog
IVF_REQUESTS = 500  # each closed loop (2,000 until the fleet phase came, 1,000 until the dist phases)
IVF_CONCURRENCY = (1, 16)
IVF_SAMPLED = 200  # answers each server holds against the plain version
IVF_TIMED = (1, 8, 64)  # rungs of the probe mode's timings
IVF_DELTA = (2000, 600)  # user rows, item rows of the streaming delta
# bench.py _retrieval_bench: (items, rank, nlist) at its defaults, then a
# catalog where pruning matters; 96 queries, k = 10, seed 16
IVF_RECIPE = ((8192, 16, 64), (262_144, 16, 256))
IVF_RECIPE_QUERIES, IVF_RECIPE_K, IVF_RECIPE_SEED = 96, 10, 16


class IvfInputs:
    """One catalog on the card in an IVF index's cluster layout, as the fast
    path lays it out, with the probe-mode dispatch and its plain version."""

    def __init__(self, U, V, index, dtype, device, k=K):
        import numpy as np
        import torch

        from predictionio_tpu_torch.ops.quantize import factors_to_tensor, quantize_factors
        from predictionio_tpu_torch.ops.score_kernel import pad_block_items
        from predictionio_tpu_torch.serving import sharding

        layout = sharding.build_layout(index.plan, pad_block_items)
        Uq, us = quantize_factors(U, dtype)
        Vq, vs = quantize_factors(V, dtype)
        self.index, self.dtype, self.cap, self.rank = index, dtype, layout.cap_pad, U.shape[1]
        self.exact_pad = pad_block_items(V.shape[0])
        self.U = factors_to_tensor(Uq, device)
        self.V = factors_to_tensor(layout.take_rows(Vq), device)
        self.us = None if us is None else torch.from_numpy(us).to(device)
        self.vs = None if vs is None else torch.from_numpy(layout.take_rows(vs, fill=1.0)).to(device)
        self.C = torch.from_numpy(np.ascontiguousarray(index.centroids, np.float32)).to(device)
        self.gid = torch.from_numpy(layout.gid).to(device)
        self.mask = torch.from_numpy(layout.pad_mask).to(device)
        sizes = np.sort(index.plan.shard_sizes())
        self.min_probes = int(np.searchsorted(np.cumsum(sizes), k) + 1)

    def probes(self, b, nprobe=None):
        """P_b of the fast path at rung ``b``."""
        nprobe = self.index.nprobe if nprobe is None else nprobe
        return min(self.index.nlist, max(self.min_probes, nprobe * b))

    def args(self, u_idx, k, n_probes):
        return (self.U, self.V, self.C, self.gid, self.mask, u_idx, k, n_probes, self.cap)

    def dispatch(self, u_idx, k, n_probes):
        from predictionio_tpu_torch.ops.score_kernel import ivf_score_topk

        return ivf_score_topk(*self.args(u_idx, k, n_probes), u_scale=self.us, v_scale=self.vs)

    def plain(self, u_idx, k, n_probes):
        from predictionio_tpu_torch.ops.score_kernel import ivf_score_topk_reference

        return ivf_score_topk_reference(*self.args(u_idx, k, n_probes), u_scale=self.us,
                                        v_scale=self.vs)


def ivf_bound(batch, real_rows, n_probes, rank, k, dtype):
    """Least time of one probe-mode launch: the probed clusters' real rows
    read once (factors, global ids, int8 scales), the probe table and the B
    user rows, the (B, k) answer written; 2·B·rank operations a real row.
    Pad slots and the pad mask are the layout's cost, not the function's,
    and the centroid product is the probe selection's, not the kernel's."""
    from predictionio_tpu_torch.ops.quantize import FACTOR_BYTES

    e = FACTOR_BYTES[dtype]
    nbytes = real_rows * (rank * e + 4) + n_probes * 4 + batch * (rank * e + 4) + batch * k * 8
    if dtype == "int8":
        nbytes += (real_rows + batch) * 4
    ops = 2 * batch * rank * real_rows
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_probe_mode(U, V, index, device, seed, what, k=K):
    """Kernel 1's probe mode against the exact mode at ``IVF_TIMED`` rungs,
    f32: the dispatch (probe selection + one launch) and the launch alone
    by CUDA events, kernel 1's launches a dispatch by its counter, device
    µs a launch by kernel from a trace (each kernel's traced time over the
    launches the trace kept: ``torch.profiler`` may drop events), the plain
    version, ``torch.topk(U[u] @ V_probed.T)`` over the gathered real rows of
    the probed clusters, the exact kernel on the whole catalog, and the
    bound over those real rows, with the padding share beside it."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import score_kernel

    ivf_in = IvfInputs(U, V, index, "f32", device, k)
    exact = Inputs(U, V, "f32", device)
    rng = np.random.default_rng(seed)
    rows = []
    for b in IVF_TIMED:
        u = torch.from_numpy(rng.integers(0, U.shape[0], b).astype(np.int32)).to(device)
        p_b = ivf_in.probes(b)
        probes = score_kernel.select_probes(ivf_in.U, u, ivf_in.C, p_b)
        slots = (probes.long()[:, None] * ivf_in.cap
                 + torch.arange(ivf_in.cap, device=device)).reshape(-1)
        real = slots[~ivf_in.mask[slots]]
        Vp = ivf_in.V[real].contiguous()
        Uf = ivf_in.U

        def launch():
            return score_kernel.fused_probed_score_topk(
                ivf_in.U, ivf_in.V, u, k, probes, ivf_in.gid, ivf_in.cap, ivf_in.mask)

        def per_launch(traced):
            return {name: us / traced["launches"][name] for name, us in traced["kernels"].items()
                    if traced["launches"].get(name)}

        before = score_kernel.ivf_launches.count
        for _ in range(10):
            ivf_in.dispatch(u, k, p_b)
        torch.cuda.synchronize()
        per_dispatch = (score_kernel.ivf_launches.count - before) / 10
        require(per_dispatch == 1.0, f"{what} b={b}: {per_dispatch} probe-mode launches a dispatch")
        traced = op_device_us(lambda: ivf_in.dispatch(u, k, p_b), n=10)
        n_real = int(real.numel())
        bound_ms, bound_by = ivf_bound(b, n_real, p_b, ivf_in.rank, k, "f32")
        rows.append({
            "catalog": what, "batch": b, "probes": p_b, "cap_pad": ivf_in.cap,
            "scanned_rows": p_b * ivf_in.cap, "real_rows": n_real,
            "padding_share": p_b * ivf_in.cap / n_real, "exact_rows": ivf_in.exact_pad,
            "scanned_fraction": p_b * ivf_in.cap / ivf_in.exact_pad,
            "ms": cuda_ms(lambda: ivf_in.dispatch(u, k, p_b), 50),
            "kernel_ms": cuda_ms(launch, 50),
            "device_us_per_launch": per_launch(traced),
            "traced_launches_per_dispatch": traced["launches"],
            "kernel1_launches_per_dispatch": per_dispatch,
            "plain_ms": cuda_ms(lambda: ivf_in.plain(u, k, p_b), 3),
            "library_ms": cuda_ms(lambda: torch.topk(Uf[u.long()] @ Vp.T, k, dim=1), 50),
            "exact_ms": cuda_ms(lambda: exact.kernel(u, k), 50),
            "exact_device_us_per_launch": per_launch(op_device_us(lambda: exact.kernel(u, k), n=10)),
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
        emit({"phase": "ivf", "step": "probe-mode-times", **rows[-1]})
    return rows


def retrieval_recipe(n_items, rank, nlist, device):
    """``bench.py``'s ``_retrieval_bench`` on the port: a clustered Gaussian
    mixture (seed 16), the exact and the IVF scorer at the default nprobe,
    recall@10 of 96 queries served one at a time, the scanned fraction from
    the scorer's own accounting, and the host k-means seconds."""
    import numpy as np

    from predictionio_tpu_torch.core.evaluation import recall_at_k
    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.ops import ivf
    from predictionio_tpu_torch.serving.fastpath import BucketedScorer

    k = IVF_RECIPE_K
    rng = np.random.default_rng(IVF_RECIPE_SEED)
    centers = (rng.normal(size=(nlist, rank)) * 4.0).astype(np.float32)
    V = (centers[rng.integers(0, nlist, size=n_items)]
         + rng.normal(size=(n_items, rank)) * 0.25).astype(np.float32)
    U = (centers[rng.integers(0, nlist, size=IVF_RECIPE_QUERIES)]
         + rng.normal(size=(IVF_RECIPE_QUERIES, rank)) * 0.25).astype(np.float32)
    t0 = time.perf_counter()
    index = ivf.build_index(V, nlist)
    kmeans_s = time.perf_counter() - t0
    ctx = DeviceContext.create(device=device)
    exact_sc = BucketedScorer(ctx, U, V, max_k=k)
    ivf_sc = BucketedScorer(ctx, U, V, max_k=k, ivf_index=index, retrieval="ivf")
    exact_rows, approx_rows = [], []
    for u in range(IVF_RECIPE_QUERIES):
        one = np.array([u])
        exact_rows.append(exact_sc.score_topk(one, k)[0][0])
        approx_rows.append(ivf_sc.score_topk(one, k)[0][0])
    recall = recall_at_k(np.stack(exact_rows), np.stack(approx_rows), k)
    st = ivf_sc.stats()["retrieval"]
    return {"n_items": n_items, "rank": rank, "k": k, "queries": IVF_RECIPE_QUERIES,
            "nlist": st["nlist"], "nprobe": st["nprobe"], "min_probes": st["min_probes"],
            "cap_pad": st["cap_pad"], "recall_at_10": float(recall),
            "scanned_fraction_b1": st["scanned_fraction"],
            "jax_gate_pass": bool(recall >= 0.95 and st["scanned_fraction"] <= 0.2),
            "kmeans_s": kmeans_s, "fingerprint": st["fingerprint"]}, U, V, index


def phase_ivf(model, seed, device):
    """IVF retrieval on the card: see the module docstring, phase 16."""
    import contextlib
    import dataclasses
    import io
    import pickle
    import re
    import shutil
    import tempfile

    import numpy as np
    import torch

    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.data.storage import sqlite
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.ops import _build, ivf, score_kernel
    from predictionio_tpu_torch.ops.quantize import quantize_factors
    from predictionio_tpu_torch.serving.fastpath import BucketedScorer
    from predictionio_tpu_torch.templates import recommendation as rec
    from predictionio_tpu_torch.tools import cli
    from predictionio_tpu_torch.testing import topk_mismatches

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="pio-ivf-")
    knobs = ("PIO_FS_BASEDIR", "PIO_DEVPROF_WINDOW", "PIO_IVF_NLIST", "PIO_IVF_NPROBE",
             "PIO_IVF_MIN_RECALL", "PIO_IVF_EVAL_USERS", "PIO_RETRIEVAL", "PIO_QUANT_DTYPE",
             "PIO_QUANT_MIN_OVERLAP", "PIO_RESULT_CACHE", "PIO_COALESCE", "PIO_HOTSET_SIZE",
             "PIO_STREAMING", "PIO_ALS_SOLVER", "PIO_ALS_COMPUTE_DTYPE")
    saved = {k: v for k, v in os.environ.items() if k.startswith("PIO_STORAGE_") or k in knobs}
    for k in saved:
        del os.environ[k]
    os.environ["PIO_FS_BASEDIR"] = os.path.join(tmp, "base")
    os.environ["PIO_DEVPROF_WINDOW"] = "3600"
    Storage.reset_instance()
    store.set_storage(None)
    servers = []
    ctx = DeviceContext.create(device=device)
    out = {"phase": "ivf"}
    U, V = model.user_factors, model.item_factors
    users = [model.user_map.inverse[j] for j in range(len(model.user_map))]
    item_index = {model.item_map.inverse[j]: j for j in range(len(model.item_map))}
    sample = "user=" + ",".join(users)
    query = json.dumps({"user": users[0], "num": OPS_NUM})
    rng = np.random.default_rng(seed + 71)
    exact_pad = score_kernel.pad_block_items(V.shape[0])

    def step(name, **row):
        row["t"] = time.perf_counter() - t_phase
        emit({"phase": "ivf", "step": name, **row})
        return row

    def pio(*argv):
        """(exit code, stdout, stderr) of ``pio <argv>`` in this process."""
        o, e = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
            rc = cli.main(list(argv))
        return rc, o.getvalue(), e.getvalue()

    try:
        storage = Storage.instance()
        engine = rec.RecommendationEngine.apply()
        dirs = {m: os.path.join(tmp, f"engine-{m}") for m in ("checkpoint", "auto")}

        # 1. publish twice under PIO_IVF_NLIST: checkpoint mode behind the
        # recall gate, auto mode with the index declared as train_als declares it
        os.environ["PIO_IVF_NLIST"] = str(IVF_NLIST)
        ckpt = als.CheckpointedALSModel(U, V, model.user_map, model.item_map, model.config)
        t0 = time.perf_counter()
        inst = {"checkpoint": publish(
            storage, engine, ckpt, engine_id=ALS_FACTORY, engine_variant="checkpoint",
            variant=write_engine_json(dirs["checkpoint"], "checkpoint",
                                      {"rank": RANK, "persistMode": "checkpoint"}))}
        publish_s = time.perf_counter() - t0
        d_ckpt = als.CheckpointedALSModel._dir(inst["checkpoint"])
        with open(os.path.join(d_ckpt, "maps.pkl"), "rb") as f:
            record = pickle.load(f)["ivf"]
        sealed = os.path.exists(os.path.join(d_ckpt, "ivf.blob"))
        require(sealed == bool(record.get("nlist")) and ("refused" in record) != sealed,
                f"checkpoint publish: record {record}, blob {sealed}")
        out["publish_checkpoint"] = step("publish-checkpoint", record=record, sealed=sealed,
                                         publish_s=publish_s)
        t0 = time.perf_counter()
        auto = als._declare_ivf_partition(als.ALSModel(
            user_factors=U, item_factors=V, user_map=model.user_map, item_map=model.item_map,
            config=model.config))
        declare_s = time.perf_counter() - t0
        require(auto.ivf_index is not None and auto.ivf_index.nlist == IVF_NLIST
                and auto.ivf_index.nprobe == ivf.default_nprobe(IVF_NLIST),
                f"auto declaration: {auto.ivf_index and auto.ivf_index.describe()}")
        if sealed:
            require(record["fingerprint"] == auto.ivf_index.fingerprint,
                    "one k-means, two fingerprints")
        inst["auto"] = publish(storage, engine, auto, engine_id=ALS_FACTORY,
                               engine_variant="auto",
                               variant=write_engine_json(dirs["auto"], "auto", {"rank": RANK}))
        del os.environ["PIO_IVF_NLIST"]
        sizes = auto.ivf_index.plan.shard_sizes()
        out["index"] = step("declare-auto", declare_s=declare_s, **auto.ivf_index.describe(),
                            cluster_sizes_p50=float(np.median(sizes)))

        # 2. pio deploy --batching of both instances, and of the auto
        # instance once more under PIO_RETRIEVAL=exact: the rollback, and the
        # exact path's yardstick under the same loads
        deploy, at_ready = {}, {}
        dirs["exact"], inst["exact"] = dirs["auto"], inst["auto"]
        for m in ("checkpoint", "auto", "exact"):  # all three start at once
            if m == "exact":
                os.environ["PIO_RETRIEVAL"] = "exact"
            qs = CliServer(tmp, f"deploy-{m}", "deploy", "--engine-dir", dirs[m], "--batching",
                           "--device", device.type)
            os.environ.pop("PIO_RETRIEVAL", None)
            servers.append(qs)
            deploy[m] = {"server": qs}
        for m, d in deploy.items():
            qs = d["server"]
            d["ready_s"] = qs.wait_ready()
            at_ready[m] = http_json(f"{qs.base}/")[1]
            require(at_ready[m]["engineInstanceId"] == inst[m], f"{m}: {at_ready[m]}")
        backend = {m: at_ready[m]["fastpath"][0]["retrieval_backend"] for m in at_ready}
        require(backend == {"checkpoint": "ivf" if sealed else "exact", "auto": "ivf",
                            "exact": "exact"}, f"deployed backends {backend}")

        # 3. a refused gate: pio ivf rebuild with nprobe doubled from 64 until
        # it seals, then POST /reload
        rebuilds = []
        n = 64
        while not sealed:
            rc, so, se = pio("ivf", "rebuild", "--instance", inst["checkpoint"], "--nlist",
                             str(IVF_NLIST), "--nprobe", str(n))
            if rc == 0:
                recall = json.loads(so.split("\n[INFO]")[0])["recall_at_publish"]
            else:
                m_ = re.search(r"recall@10 ([0-9.]+) <", se)
                require(m_ is not None, f"pio ivf rebuild --nprobe {n}: {rc} {se}")
                recall = float(m_.group(1))
            rebuilds.append(step("ivf-rebuild", nprobe=n, exit=rc, recall=recall))
            sealed = rc == 0
            require(sealed or n < IVF_NLIST, "a full-probe rebuild refused")
            n = min(2 * n, IVF_NLIST)
        out["rebuilds"] = rebuilds
        if rebuilds:
            qs = deploy["checkpoint"]["server"]
            status, body = http_json(f"{qs.base}/reload", {}, method="POST")
            require(status == 200, f"POST /reload: {status} {body}")
            at_ready["checkpoint"] = http_json(f"{qs.base}/")[1]
            require(at_ready["checkpoint"]["fastpath"][0]["retrieval_backend"] == "ivf",
                    f"after the rebuild and reload: {at_ready['checkpoint']['fastpath'][0]}")
        indices = {"checkpoint": ivf.load_index(os.path.join(d_ckpt, "ivf.blob")),
                   "auto": auto.ivf_index}

        # 4. each server: closed loops, pio ivf show, GET /, /metrics, sampled
        # answers against the plain version, launches against dispatches
        served = {}
        for m in ("checkpoint", "auto", "exact"):
            qs = deploy[m]["server"]
            info = http_json(f"{qs.base}/")[1]
            rv_ = info["fastpath"][0]["retrieval"]
            require(m == "exact" or rv_["fingerprint"] == indices[m].fingerprint,
                    f"{m} serves {rv_}, sealed {indices.get(m)}")
            loads = []
            for c in IVF_CONCURRENCY:
                before = http_json(f"{qs.base}/")[1]
                rc, rep = run_loadtest_cli(
                    "--port", str(qs.port), "--query", query, "--requests", str(IVF_REQUESTS),
                    "--concurrency", str(c), "--dist", "zipf", "--sample", sample,
                    "--scrape-metrics")
                after = http_json(f"{qs.base}/")[1]
                require(rc == 0 and rep["ok"] == IVF_REQUESTS and rep["http5xx"] == 0,
                        f"{m} closed loop c={c}: exit {rc}, {rep}")
                rb = before["fastpath"][0]["retrieval"] or {"scanned_rows": 0, "dispatches": 0}
                ra = after["fastpath"][0]["retrieval"] or {"scanned_rows": 0, "dispatches": 0}
                disp = ra["dispatches"] - rb["dispatches"]
                hits = _delta(after["fastpath"][0]["bucket_hits"], before["fastpath"][0]["bucket_hits"])
                loads.append(step(
                    "closed-loop", server=m, concurrency=c, qps=rep["qps"], p50_ms=rep["p50Ms"],
                    p99_ms=rep["p99Ms"], rung_hits=hits,
                    scanned_fraction=(ra["scanned_rows"] - rb["scanned_rows"])
                    / (disp * exact_pad) if disp else None,
                    scanned_fraction_by_rung={b: ra["probes_per_rung"][b] * ra["cap_pad"]
                                              / exact_pad for b in hits} if disp else None,
                    launches=after["scoreKernelLaunches"] - before["scoreKernelLaunches"],
                    dispatches=after["fastpath"][0]["calls"] - before["fastpath"][0]["calls"],
                    retrieval_summary={k: (rep.get("serverMetrics") or {}).get(k) for k in (
                        "retrievalBackend", "ivfNprobe", "ivfScannedFraction")}))
            shown = pio("ivf", "show", "--instance", inst[m])
            require(shown[0] == 0, f"pio ivf show {m}: {shown}")
            with urllib.request.urlopen(f"{qs.base}/metrics", timeout=30) as r:
                ivf_series = [x for x in r.read().decode().splitlines()
                              if x.startswith("pio_ivf_")]
            require(not ivf_series if m == "exact" else any(
                x.startswith(f'pio_ivf_info{{fingerprint="{indices[m].fingerprint}"}}')
                for x in ivf_series), f"{m} /metrics: {ivf_series}")
            # the sampled answers, one at a time: each a dispatch at rung 1
            before = http_json(f"{qs.base}/")[1]
            picks = [(int(j), int(rng.integers(1, K + 1)))
                     for j in rng.integers(0, len(users), IVF_SAMPLED)]
            answers = []
            for j, num in picks:
                status, a = http_json(f"{qs.base}/queries.json", {"user": users[j], "num": num})
                require(status == 200, f"{users[j]}: {status} {a}")
                answers.append(a["itemScores"])
            after = http_json(f"{qs.base}/")[1]
            hits = _delta(after["fastpath"][0]["bucket_hits"], before["fastpath"][0]["bucket_hits"])
            require(hits == {"1": IVF_SAMPLED}, f"{m}: sampled queries went to rungs {hits}")
            if m == "exact":
                plain = Inputs(U, V, "f32", device)

                def answer(u):
                    return plain.plain(u, K)
            else:
                plain = IvfInputs(U, V, indices[m], "f32", device)
                p1 = after["fastpath"][0]["retrieval"]["probes_per_rung"]["1"]
                require(p1 == plain.probes(1), f"{m}: P_1 {p1} vs {plain.probes(1)}")

                def answer(u):
                    return plain.plain(u, K, p1)
            bad = []
            for (j, num), got in zip(picks, answers):
                u = torch.tensor([j], dtype=torch.int32, device=device)
                rv, ri = (t.cpu().numpy() for t in answer(u))
                bad += topk_mismatches(
                    np.array([[x["score"] for x in got]]),
                    np.array([[item_index[x["item"]] for x in got]]), rv[:, :num], ri[:, :num], TOL)
            require(not bad, f"{m}: served answers vs the plain version: {bad[:3]}")
            del plain
            final = http_json(f"{qs.base}/")[1]
            launches = final["scoreKernelLaunches"] - at_ready[m]["scoreKernelLaunches"]
            calls = final["fastpath"][0]["calls"] - at_ready[m]["fastpath"][0]["calls"]
            require(launches == calls > 0,
                    f"{m}: kernel 1 launched {launches} times vs {calls} dispatches")
            served[m] = step("served", server=m, instance=inst[m], ready_s=deploy[m]["ready_s"],
                             launches=launches, dispatches=calls, topk_mismatches=0,
                             sampled=IVF_SAMPLED, loads=loads, ivf_show=shown[1].strip(),
                             metrics=ivf_series, retrieval=final["fastpath"][0]["retrieval"])
            cli_run("undeploy", "--port", str(qs.port))
            qs.wait_exit()
        out["served"] = served

        # 5. parity on the card: full probe equals the exact mode bit for bit,
        # the default nprobe equals the plain version, every rung and dtype
        index = indices["auto"]
        parity, scorers = {}, {}
        for dtype in DTYPES:
            Uq, us = quantize_factors(U, dtype)
            Vq, vs = quantize_factors(V, dtype)
            kw = dict(max_k=K, factor_dtype=dtype, user_scale=us, item_scale=vs)
            exact = BucketedScorer(ctx, Uq, Vq, **kw)
            full = BucketedScorer(ctx, Uq, Vq, retrieval="ivf", **kw,
                                  ivf_index=dataclasses.replace(index, nprobe=index.nlist))
            pruned = BucketedScorer(ctx, Uq, Vq, ivf_index=index, retrieval="ivf", **kw)
            gaps = []
            for b in RUNGS:
                who = rng.integers(0, len(users), b)
                before = score_kernel.ivf_launches.count
                ei, ev = exact.score_topk(who, K)
                fi, fv = full.score_topk(who, K)
                pi, pv = pruned.score_topk(who, K)
                require(score_kernel.ivf_launches.count == before + 2,
                        f"{dtype} b={b}: {score_kernel.ivf_launches.count - before} probe launches")
                require(np.array_equal(ei, fi) and ev.tobytes() == fv.tobytes(),
                        f"{dtype} b={b}: full probe differs from the exact mode")
                f = pruned._factors
                rv, ri = score_kernel.ivf_score_topk_reference(
                    f[0], f[1], f[4], f[5], f[6], torch.from_numpy(who.astype(np.int32)).to(device),
                    K, pruned._probes[b], pruned._ivf_layout.cap_pad, u_scale=f[2], v_scale=f[3])
                rv, ri = rv.cpu().numpy(), ri.cpu().numpy()
                bad = topk_mismatches(pv, pi, rv, ri, TOL)
                require(not bad, f"{dtype} b={b}: probe mode vs plain version: {bad[:3]}")
                gaps.append(float(np.abs(pv - rv).max()))
            parity[dtype] = {"full_probe_bitwise": True, "topk_mismatches": 0,
                             "max_abs_err": max(gaps)}
            scorers[dtype] = pruned
            del exact, full
        out["parity"] = step("parity", **parity)

        # 6. a streaming delta on the IVF replicas (f32 and int8): user and
        # item rows patched in place, answers from the patched rows
        deltas = {}
        for dtype in ("f32", "int8"):
            sc = scorers[dtype]
            who_u = rng.choice(len(users), IVF_DELTA[0], replace=False)
            who_i = rng.choice(V.shape[0], IVF_DELTA[1], replace=False)
            U2, V2 = U.copy(), V.copy()
            U2[who_u] = rng.normal(size=(len(who_u), RANK)).astype(np.float32)
            V2[who_i] = rng.normal(size=(len(who_i), RANK)).astype(np.float32) * 2
            warm, builds = sc.warmup_executions, len(_build.build_log)
            receipt = sc.apply_delta_rows(who_u, U2[who_u], who_i, V2[who_i])
            require((receipt["warmup_executions"], receipt["kernel_builds"]) == (warm, builds)
                    and receipt["users"] == len(who_u) and receipt["items"] == len(who_i),
                    f"{dtype} delta: {receipt}")
            plain = IvfInputs(U2, V2, index, dtype, device)
            bad = []
            for b in RUNGS:
                who = np.concatenate([who_u[:b], rng.integers(0, len(users), b)])[:b]
                gi, gv = sc.score_topk(who, K)
                rv, ri = (t.cpu().numpy() for t in plain.plain(
                    torch.from_numpy(who.astype(np.int32)).to(device), K, plain.probes(b)))
                bad += topk_mismatches(gv, gi, rv, ri, TOL)
            require(not bad, f"{dtype} IVF delta vs the plain version on U', V': {bad[:3]}")
            require(sc.warmup_executions == warm and len(_build.build_log) == builds,
                    f"{dtype}: a delta warmed or built")
            deltas[dtype] = {"users": receipt["users"], "items": receipt["items"],
                             "device_ms": receipt["device_ms"], "topk_mismatches": 0}
        del scorers
        out["delta"] = step("delta", **deltas)

        # 7. the JAX package's own IVF gate recipe on the port, then kernel 1's
        # probe mode against the exact mode
        recipes = []
        for n_items, rank, nlist in IVF_RECIPE:
            row, rU, rV, rindex = retrieval_recipe(n_items, rank, nlist, device)
            recipes.append(step("recipe", **row))
        require(recipes[0]["jax_gate_pass"],
                f"the JAX gate at bench.py's defaults: {recipes[0]}")
        out["recipes"] = recipes
        times = time_probe_mode(U, V, index, device, seed + 73, "ml25m")
        times += time_probe_mode(rU, rV, rindex, device, seed + 79, f"recipe-{rV.shape[0]}",
                                 k=IVF_RECIPE_K)
        out["times"] = times
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
    emit({k: v for k, v in out.items() if k not in ("served", "times")})
    return out


# -- templates: the Universal Recommender at ML-25M width, and every ported
# -- template through the CLI ---------------------------------------------------

UR_K = 50  # maxCorrelatorsPerItem: the UR default
UR_SAMPLED = 256  # indicator items whose top-50 lists are held to the LLR rule
UR_QUERIES = 8  # users whose predict answers are held against plain host code
UR_PEAK_INT8_OPS_S = 1979e12  # H100 SXM data sheet: dense int8 tensor-core rate
TPL_APP = "Templates"
TPL_ITERS = 10  # implicit ALS iterations of each template's training
TPL_FOLLOWS = 20_000  # user → user follow events (two communities)
TPL_LABELED = 2_000  # users with $set attr0..attr2 and a plan label
TPL_QUERIES = 12  # queries a deployed template answers, beside the scripted ones


def ur_exact_columns(a_p_t, a_s, cols):
    """Exact int64 cross-occurrence counts of the indicator columns ``cols``
    (primary items × len(cols)) from the binarized incidences (scipy)."""
    return (a_p_t @ a_s[:, cols]).toarray()


def ur_block_reference64(a_p, a_s, start, width, p_pad, s_pad, device):
    """One column block's counts from float64 products of the dense 0/1
    incidence, user block by user block on the card: every partial sum is
    an integer below 2⁵³, so the result is exact by another route than the
    int8 product (the rows come from scipy's CSR, not ``block_incidence``)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.models import cooccurrence as co

    a_s = a_s[:, start:start + width].tocsr()
    C = torch.zeros((p_pad, s_pad), dtype=torch.float64, device=device)
    for u0 in range(0, a_p.shape[0], co._USER_BLOCK):
        dense = []
        for m, n_pad in ((a_p[u0:u0 + co._USER_BLOCK], p_pad), (a_s[u0:u0 + co._USER_BLOCK], s_pad)):
            rows = np.repeat(np.arange(m.shape[0]), np.diff(m.indptr))
            d = torch.zeros((co._USER_BLOCK, n_pad), dtype=torch.float64, device=device)
            d[torch.from_numpy(rows).to(device), torch.from_numpy(m.indices.astype(np.int64)).to(device)] = 1.0
            dense.append(d)
        C += dense[0].T @ dense[1]
        del dense
    return C


def ur_block_device_us(p_dev, s_dev, p_pad, s_pad, pc, sc, n_items, total, k, exclude_diagonal):
    """Device µs of one column block as ``cross_occurrence_topn`` computes
    it: one real ``cross_occurrence_block`` and one real ``score_block``
    call, each traced by the profiler, their device time grouped by the
    aten op that launched it. The block call splits into the int8 product
    (``_int_mm``), the accumulate and the conversions (``add_``, ``copy_``:
    C to f32, and the incidence's small index arrays to int64) and the
    scatter (the rest: the zeros of the incidences and of C, the slot
    indices and ``index_fill_``); the score call into the top-k (``topk``, ``gather``)
    and the LLR with its masks and the two-key packing (the rest). Beside
    them, the library's ``torch.topk`` over the same scores (no tie order;
    timed only)."""
    import torch

    from predictionio_tpu_torch.models import cooccurrence as co

    def block():
        return co.cross_occurrence_block(*p_dev, *s_dev, p_pad, s_pad)

    C = block()
    traced = {"block": op_device_us(block, n=1),
              "score": op_device_us(lambda: co.score_block(
                  C, pc, sc, 0, n_items, k, True, total, exclude_diagonal), n=1)}
    b_ops, s_ops = traced["block"]["ops"], traced["score"]["ops"]
    require(b_ops.get("aten::_int_mm", 0) > 0 and s_ops.get("aten::topk", 0) > 0,
            f"ur block trace without device time: {sorted(b_ops)} {sorted(s_ops)}")
    us = {"product": b_ops["aten::_int_mm"],
          "accumulate_convert": sum(b_ops.get(op, 0.0) for op in ("aten::add_", "aten::copy_")),
          "topk": sum(s_ops.get(op, 0.0) for op in ("aten::topk", "aten::gather"))}
    us["scatter"] = sum(b_ops.values()) - us["product"] - us["accumulate_convert"]
    us["llr_masks_keys"] = sum(s_ops.values()) - us["topk"]
    scores = co.llr_cross_scores(C, pc, sc, total)
    del C
    us["library_topk"] = sum(device_us(lambda: torch.topk(scores.T, k, dim=1), n=3).values())
    del scores
    n_blocks = p_dev[0].shape[0]
    groups = co.product_groups(n_blocks, p_pad, s_pad)
    ops = 2.0 * p_pad * s_pad * n_blocks * co._USER_BLOCK
    rate = ops / (us["product"] * 1e-6)
    return {"device_us": us, "device_us_by_op": {k_: t["ops"] for k_, t in traced.items()},
            "device_us_by_kernel": {k_: t["kernels"] for k_, t in traced.items()},
            "products": len(groups),
            "users_per_product": (groups[0][1] - groups[0][0]) * co._USER_BLOCK,
            "product_ops": ops, "product_tops_s": rate / 1e12,
            "product_share_of_int8_peak": rate / UR_PEAK_INT8_OPS_S}


def ur_predict_plain(model, history, black_list=()):
    """The UR's scores from its arrays, in plain host code: each history
    item votes its indicator row's positive scores. Returns (scores, keep):
    bought items, the blacklist and items no vote reached drop out."""
    import numpy as np

    scores = np.zeros(len(model.item_map), np.float64)
    keep = np.ones(len(model.item_map), bool)
    for name, items in history.items():
        top_items, top_scores = model.indicators[name]
        for item in items:
            j = model.item_map.get(item)
            if j is None:
                continue
            if name == model.primary_event:
                keep[j] = False
            pos = top_scores[j] > 0
            np.add.at(scores, top_items[j][pos], top_scores[j][pos].astype(np.float64))
    for item in black_list:
        if item in model.item_map:
            keep[model.item_map[item]] = False
    return scores, keep & (scores > 0)


def phase_ur_ml25m(seed, device, inter):
    """(a) of the templates phase: ``URAlgorithm.train`` on the card at the
    ML-25M shape, its counts, LLR lists and answers held (module docstring)."""
    import collections
    import uuid

    import numpy as np
    import scipy.sparse as sps
    import torch

    from predictionio_tpu_torch import testing
    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import base
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.models import cooccurrence as co
    from predictionio_tpu_torch.templates import universal as ur

    t_phase = time.perf_counter()
    ctx = DeviceContext.create(device=device)
    n_users, n_items = len(inter.user_map), len(inter.item_map)
    buy = inter.subset(inter.rating >= 4.0)
    td = ur.TrainingData(per_event={"buy": buy, "view": inter}, user_map=inter.user_map,
                         item_map=inter.item_map, primary_event="buy")
    td.sanity_check()
    names = list(td.per_event)
    rng = np.random.default_rng(seed + 31)
    sampled = np.sort(np.concatenate([[0, 1], rng.choice(np.arange(2, n_items), UR_SAMPLED - 2,
                                                          replace=False)]))
    n_blocks_col = -(-n_items // 4096)
    checked_blocks = (0, n_blocks_col - 1)

    # host prep and the per-indicator device work, timed by wrapping what
    # URAlgorithm.train calls; the wrapper of cross_occurrence_block keeps
    # the checked blocks' counts and the sampled columns (its own time is
    # taken out of the indicator's)
    host_s = collections.defaultdict(float)
    kept, cols_got, per_indicator = {}, {}, []
    counts = []  # distinct_item_counts' results in call order: primary, then each indicator
    current = {"name": None, "block": 0, "keep_s": 0.0}
    real = {"ur.block_incidence": ur.block_incidence, "ur.distinct_item_counts": ur.distinct_item_counts,
            "co.block_incidence": co.block_incidence, "ur.cross_occurrence_topn": ur.cross_occurrence_topn,
            "co.cross_occurrence_block": co.cross_occurrence_block}

    def timed_host(key, fn):
        def wrapped(*a, **kw):
            t = time.perf_counter()
            try:
                out = fn(*a, **kw)
            finally:
                host_s[key] += time.perf_counter() - t
            if key == "distinct_counts":
                counts.append(out)
            return out
        return wrapped

    def block(*a):
        C = real["co.cross_occurrence_block"](*a)
        t = time.perf_counter()
        name, bi = current["name"], current["block"]
        start = bi * 4096
        if bi in checked_blocks:
            kept[(name, bi)] = (start, C.clone())
        hit = (sampled >= start) & (sampled < start + C.shape[1])
        if hit.any():
            cols = torch.from_numpy(sampled[hit] - start).to(C.device)
            cols_got[name][:, hit] = C[:n_items, cols].cpu().numpy()
        torch.cuda.synchronize()
        current["block"] += 1
        current["keep_s"] += time.perf_counter() - t
        return C

    def topn(*a, **kw):
        name = names[len(per_indicator)]
        current.update(name=name, block=0, keep_s=0.0)
        cols_got[name] = np.zeros((n_items, len(sampled)), np.float32)
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = real["ur.cross_occurrence_topn"](*a, **kw)
        torch.cuda.synchronize()
        require(current["block"] == n_blocks_col, f"ur {name}: {current['block']} column blocks")
        per_indicator.append({"indicator": name, "column_blocks": n_blocks_col,
                              "seconds": time.perf_counter() - t - current["keep_s"]})
        return res

    ur.block_incidence = timed_host("block_primary", real["ur.block_incidence"])
    ur.distinct_item_counts = timed_host("distinct_counts", real["ur.distinct_item_counts"])
    co.block_incidence = timed_host("block_secondary", real["co.block_incidence"])
    co.cross_occurrence_block = block
    ur.cross_occurrence_topn = topn
    algo = ur.URAlgorithm(ur.URAlgorithmParams(appName="URApp", maxCorrelatorsPerItem=UR_K))
    torch.cuda.synchronize(device)  # the allocator's stats exist once CUDA is up
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    try:
        t0 = time.perf_counter()
        model = algo.train(ctx, td)
        train_s = time.perf_counter() - t0
    finally:
        ur.block_incidence = real["ur.block_incidence"]
        ur.distinct_item_counts = real["ur.distinct_item_counts"]
        co.block_incidence = real["co.block_incidence"]
        co.cross_occurrence_block = real["co.cross_occurrence_block"]
        ur.cross_occurrence_topn = real["ur.cross_occurrence_topn"]
    peak = torch.cuda.max_memory_allocated(device)
    n_users_pad = co.pad_to_multiple(n_users, co._USER_BLOCK)
    primary_blocked = co.block_incidence(buy, n_users_pad)
    widths = {"primary": int(primary_blocked.local_user.shape[1])}
    out = {"phase": "templates", "step": "ur-ml25m", "users": n_users, "items": n_items,
           "events": {"buy": len(buy), "view": len(inter)}, "train_s": train_s,
           "host_prep_s": dict(host_s), "indicators": per_indicator,
           "max_memory_allocated": peak,
           "host_primary_blocked_bytes": sum(a.nbytes for a in (
               primary_blocked.local_user, primary_blocked.item, primary_blocked.mask))}
    emit(out)

    # exact counts: scipy int64 of the binarized incidences
    t0 = time.perf_counter()
    a = {}
    for name, x in td.per_event.items():
        m = sps.csr_matrix((np.ones(len(x), np.int64), (x.user, x.item)), shape=(n_users, n_items))
        m.sum_duplicates()
        m.data[:] = 1
        a[name] = m
    a_p_t = a["buy"].T.tocsr()
    p_pad = co.pad_to_multiple(n_items, 128)
    exact_s = {"scipy_build_s": time.perf_counter() - t0}
    pc = counts[0]
    s_counts = dict(zip(names, counts[1:]))
    atol = testing.llr_atol(n_users)
    rule = {}
    for name in names:
        a_s = a[name].tocsc()
        for bi in checked_blocks:
            start, C = kept.pop((name, bi))
            width = min(4096, n_items - start)
            t0 = time.perf_counter()
            ref = ur_block_reference64(a["buy"], a[name], start, width, p_pad, C.shape[1], device)
            require(torch.equal(C, ref.to(torch.float32)) and float(ref.max()) < 2 ** 24,
                    f"ur {name} column block {bi}: counts differ from float64 products at "
                    f"{int((C != ref.to(torch.float32)).sum())} entries")
            exact_s[f"{name}_{bi}_f64_s"] = time.perf_counter() - t0
            if bi == checked_blocks[-1]:
                t0 = time.perf_counter()
                ex = ur_exact_columns(a_p_t, a_s, np.arange(start, start + width))
                require(np.array_equal(C[:n_items, :width].cpu().numpy(), ex.astype(np.float32)),
                        f"ur {name} last column block: counts differ from scipy's int64")
                exact_s[f"{name}_{bi}_scipy_s"] = time.perf_counter() - t0
            del C, ref
        # the sampled indicator items: exact columns, then their lists by the LLR rule
        ex = ur_exact_columns(a_p_t, a_s, sampled)
        require(np.array_equal(cols_got[name], ex.astype(np.float32)),
                f"ur {name}: sampled columns' counts differ from scipy's int64")
        ref64 = testing.llr_reference64(ex, pc, s_counts[name][sampled], n_users)
        if name == "buy":
            ref64[sampled, np.arange(len(sampled))] = -1.0
        idx, vals = model.indicators[name]
        bad, gap, share = [], 0.0, 0.0
        for c, j in enumerate(sampled):
            bad += [f"item {j}: {m}" for m in testing.llr_topk_mismatches(idx[j], vals[j], ref64[:, c], atol)]
            ref = np.maximum(ref64[idx[j], c], 0.0)
            gap = max(gap, float(np.abs(vals[j] - ref).max()))
            # the gap over its tolerance: how close the rule came to failing
            share = max(share, float((np.abs(vals[j] - ref) / (atol + testing.LLR_RTOL * ref)).max()))
        require(not bad, f"ur {name}: LLR rule broken: {bad[:3]}")
        require(int(idx.max()) < n_items, f"ur {name}: a padded row won")
        if name == "buy":
            require(not np.any((idx == np.arange(n_items)[:, None]) & (vals > 0)),
                    "ur buy: an item lists itself with a positive score")
        rule[name] = {"sampled": len(sampled), "largest_gap_to_float64": gap, "atol": atol,
                      "largest_gap_over_tolerance": share,
                      "positive_share": float((vals > 0).mean())}
    del a_p_t
    exact_s["seconds"] = sum(v for v in exact_s.values())
    emit({"phase": "templates", "step": "ur-ml25m-exact", "checked_blocks": list(checked_blocks),
          **exact_s, "llr_rule": rule, "ok": True})

    # per-op device times on each indicator's first (widest) column block
    ops = {}
    p_dev = co._on_device(primary_blocked, device)
    pc_dev = torch.from_numpy(np.pad(pc, (0, p_pad - n_items))).to(device)
    for name, x in td.per_event.items():
        first = x.subset(x.item < 4096)
        s_blocked = co.block_incidence(first, n_users_pad)
        widths[name] = int(s_blocked.local_user.shape[1])
        sc = s_counts[name][:4096]
        ops[name] = ur_block_device_us(p_dev, co._on_device(s_blocked, device), p_pad, 4096,
                                       pc_dev, torch.from_numpy(sc).to(device), n_items,
                                       float(n_users), UR_K, name == "buy")
        del s_blocked
    del p_dev
    torch.cuda.empty_cache()
    emit({"phase": "templates", "step": "ur-ml25m-ops", "block_widths": widths, "ops": ops})

    # answers: seeded users' histories in MEMORY storage, through predict
    name_ = "UR" + uuid.uuid4().hex[:8].upper()
    mem = Storage(env={f"PIO_STORAGE_SOURCES_{name_}_TYPE": "memory"})
    app_id = mem.get_meta_data_apps().insert(base.App(0, "URApp"))
    users = rng.choice(n_users, UR_QUERIES, replace=False)
    order = np.argsort(inter.user, kind="stable")
    bounds = np.searchsorted(inter.user[order], np.arange(n_users + 1))
    inv_u, inv_i = inter.user_map.inverse, inter.item_map.inverse
    histories, events = {}, []
    for u in users:
        rows = order[bounds[u]:bounds[u + 1]]
        hist = {"buy": [], "view": []}
        for k, r in enumerate(rows):
            item = inv_i[int(inter.item[r])]
            for name in (("buy", "view") if inter.rating[r] >= 4.0 else ("view",)):
                events.append(Event(event=name, entity_type="user", entity_id=inv_u[int(u)],
                                    target_entity_type="item", target_entity_id=item,
                                    event_time=1_767_225_600.0 + k))
                hist[name].append(item)
        # the latest maxQueryEvents of each event type, as the live read takes them
        histories[inv_u[int(u)]] = {n: list(reversed(h))[:algo.params.maxQueryEvents]
                                    for n, h in hist.items()}
    mem.get_l_events().insert_batch(events, app_id)
    store.set_storage(mem)
    try:
        gaps = []
        for user, hist in histories.items():
            got = algo.predict(model, ur.Query(user=user, num=20))
            rows = [{"item": x.item, "score": x.score} for x in got.itemScores]
            scores, keep = ur_predict_plain(model, hist)
            require(len(rows) > 0, f"ur predict {user}: no answer")
            gaps.append(hold_topn(rows, scores, keep, 20, model.item_map, f"ur predict {user}"))
    finally:
        store.set_storage(None)
    out = {"phase": "templates", "step": "ur-ml25m-predict", "users": len(histories),
           "history_events": len(events), "max_abs_err": max(gaps), "tol": 1e-5,
           "seconds": time.perf_counter() - t_phase, "ok": True}
    emit(out)
    return {"train_s": train_s, "host_prep_s": dict(host_s), "indicators": per_indicator,
            "max_memory_allocated": peak, "block_widths": widths, "ops": ops, "exact": exact_s,
            "llr_rule": rule, "predict": out, "seconds": time.perf_counter() - t_phase}


class ThreadServer:
    """``pio <argv>`` serving on 127.0.0.1:port in a thread of this process
    (so the event server's invalidations reach the deployed template's
    event cache, and the kernels' counters see what it launches)."""

    def __init__(self, *argv):
        import threading

        from predictionio_tpu_torch.tools import cli

        self.port = free_port()
        self.base = f"http://127.0.0.1:{self.port}"
        self.rc = []
        self.thread = threading.Thread(
            target=lambda: self.rc.append(cli.main(list(argv) + ["--ip", "127.0.0.1",
                                                                  "--port", str(self.port)])),
            daemon=True)
        self.t0 = time.perf_counter()
        self.thread.start()

    def wait_ready(self, deadline_s=120) -> float:
        t_end = time.monotonic() + deadline_s
        while time.monotonic() < t_end:
            require(self.thread.is_alive(), f"{self.base} exited {self.rc}")
            try:
                with urllib.request.urlopen(f"{self.base}/readyz", timeout=5) as r:
                    if r.status == 200:
                        return time.perf_counter() - self.t0
            except OSError:
                pass
            time.sleep(0.02)
        raise RuntimeError(f"check failed: {self.base}/readyz never answered 200")

    def stop(self, verb_argv):
        cli_run(*verb_argv)
        self.thread.join(60)
        require(not self.thread.is_alive() and self.rc == [0], f"{self.base} stop: {self.rc}")


def template_events(seed, rng):
    """The templates-cli draw: ``QS_BULK`` events of the ML-1M draw as views
    (1 in ``QS_BUY_EVERY`` a buy, which also counts as a view), item
    categories, the ``unavailableItems`` constraint, ``TPL_FOLLOWS`` follows
    in two communities and ``TPL_LABELED`` labeled users."""
    import numpy as np

    from predictionio_tpu_torch.data.event import Event

    inter, _ = ml1m_interactions(seed)
    pick = np.sort(rng.choice(len(inter.user), QS_BULK, replace=False))
    user, item, t = inter.user[pick], inter.item[pick], inter.t[pick]
    buy = rng.integers(0, QS_BUY_EVERY, QS_BULK) == 0
    events = []
    for k in range(QS_BULK):
        for name in (("view", "buy") if buy[k] else ("view",)):
            events.append(Event(event=name, entity_type="user", entity_id=f"u{user[k]}",
                                target_entity_type="item", target_entity_id=f"si{item[k]}",
                                event_time=float(t[k]), creation_time=float(t[k])))
    t_end = float(t.max()) + 1
    for j in range(SAS_ITEMS):
        events.append(Event(event="$set", entity_type="item", entity_id=f"si{j}",
                            properties={"categories": [f"g{j % 5}", "even" if j % 2 == 0 else "odd"]},
                            event_time=t_end))
    frm = rng.integers(0, ML1M_USERS, TPL_FOLLOWS)
    to = (frm % 2 + 2 * rng.integers(0, ML1M_USERS // 2, TPL_FOLLOWS)) % ML1M_USERS
    for k, (a, b) in enumerate(zip(frm, to)):
        if a != b:
            events.append(Event(event="follow", entity_type="user", entity_id=f"u{a}",
                                target_entity_type="user", target_entity_id=f"u{b}",
                                event_time=t_end + k))
    attrs = rng.uniform(0, 10, (TPL_LABELED, 3))
    for c, (a0, a1, a2) in enumerate(attrs):
        events.append(Event(event="$set", entity_type="user", entity_id=f"c{c}",
                            properties={"attr0": float(a0), "attr1": float(a1), "attr2": float(a2),
                                        "plan": "premium" if a0 + a1 > 10 else "basic"},
                            event_time=t_end))
    return events, {"views": QS_BULK, "buys": int(buy.sum()), "items": SAS_ITEMS,
                    "follows": int((frm != to).sum()), "labeled": TPL_LABELED}


def hold_implicit_training(name, inter, model, params, device):
    """Kernel 2 in implicit mode at an ALS template's own shapes: every
    bucket of both sides held against its plain version (and float64 sums)
    by ``check_normal_eq``, the trained factors as the other side; and the
    factors ``pio train`` made on the card against a CPU training of the
    same read from the same seed (rule 4: rtol = atol = 1e-4). ``params``
    are the template algorithm's, turned into its ``ALSConfig``."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.models import als

    cfg = als.ALSConfig(rank=params.rank, iterations=params.numIterations, reg=params.reg,
                        implicit=True, alpha=params.alpha,
                        seed=3 if params.seed is None else params.seed)
    ub, ib, u_perm, i_perm = als._dense_blocks_for(inter, cfg)
    U = torch.from_numpy(model.user_factors[np.argsort(u_perm)]).to(device)
    V = torch.from_numpy(model.item_factors[np.argsort(i_perm)]).to(device)
    errs = []
    for side, (blocks, opp) in enumerate(((ub, V), (ib, U))):
        for j, t in enumerate(zip(blocks.idx, blocks.rat, blocks.msk)):
            b = [torch.from_numpy(x).to(device) for x in t]
            errs.append(check_normal_eq(*b, opp, "f32", True,
                                        f"{name} kernel 2 implicit, side {side} bucket {j}",
                                        alpha=cfg.alpha))
    t0 = time.perf_counter()
    host = als.train_als(DeviceContext.create(device="cpu"), inter, cfg)
    cpu_s = time.perf_counter() - t0
    pairs = ((model.user_factors, host.user_factors), (model.item_factors, host.item_factors))
    diff = max(float(np.abs(a - b).max()) for a, b in pairs)
    for a, b in pairs:
        require(np.allclose(a, b, rtol=1e-4, atol=1e-4),
                f"{name}: card factors vs a CPU training, max |Δ| {diff}")
    return {"buckets_held": len(errs), "alpha": cfg.alpha,
            "max_abs_err": max(e["abs"] for e in errs), "max_rel_err": max(e["rel"] for e in errs),
            "kernel_vs_f64_rel": max(e["kernel_f64"] for e in errs),
            "plain_vs_f64_rel": max(e["plain_f64"] for e in errs),
            "factors_vs_cpu_max_abs": diff, "factors_tol": 1e-4, "cpu_training_s": cpu_s}


def rf_plain(model, x):
    """The forest's label for ``x`` by a plain walk of its arrays: bin each
    feature, follow each tree (an unsplit node routes left), majority vote
    (the first class on a tie)."""
    import numpy as np

    xb = [int(np.searchsorted(model.bin_edges[f], x[f], side="right")) for f in range(len(x))]
    votes = np.zeros(len(model.label_map), np.int64)
    leaf_base = 2 ** model.max_depth - 1
    for t in range(model.split_feature.shape[0]):
        node = 0
        for _ in range(model.max_depth):
            f = int(model.split_feature[t, node])
            node = 2 * node + 1 + int(f >= 0 and xb[f] > model.split_bin[t, node])
        votes[model.leaf_class[t, node - leaf_base]] += 1
    return model.label_map.inverse[int(np.argmax(votes))]


def same_json(got, want) -> bool:
    """An HTTP answer against the in-process result (fields that are None
    are left out by the server's encoder)."""
    import dataclasses

    def strip(o):
        if isinstance(o, dict):
            return {k: strip(v) for k, v in o.items() if v is not None}
        if isinstance(o, list):
            return [strip(v) for v in o]
        return o

    return strip(got) == strip(json.loads(json.dumps(dataclasses.asdict(want))))


def hold_topn(rows, scores, keep, num, index, what, field="item"):
    """Rule 4 (1e-5) of one served ranking against plain host code over the
    deployed model's arrays: ``scores`` of every entry and ``keep``, the
    entries the query allows. The answer holds the ``num`` best allowed
    entries: each row's score is its plain score, and the scores, sorted,
    are the best plain scores; entries that tie may come in either order.
    Returns the largest gap."""
    import numpy as np

    allowed = np.flatnonzero(keep & np.isfinite(scores))
    n = min(num, len(allowed))
    require(len(rows) == n, f"{what}: {len(rows)} answers vs {n}")
    if not n:
        return 0.0
    idx = np.array([index[r[field]] for r in rows])
    got = np.array([r["score"] for r in rows], np.float64)
    require(len(set(idx.tolist())) == n and bool(keep[idx].all()), f"{what}: {rows}")
    best = np.sort(scores[allowed])[::-1][:n]
    gaps = np.concatenate([np.abs(got - scores[idx]), np.abs(np.sort(got)[::-1] - best)])
    slack = 1e-5 + 1e-5 * np.concatenate([np.abs(scores[idx]), np.abs(best)])
    require(bool((gaps <= slack).all()), f"{what}: gaps {gaps.max()} beyond rule 4")
    require(bool(np.all(np.diff(got) <= slack[:n - 1])), f"{what}: not in score order")
    return float(gaps.max())


def phase_templates_cli(seed, device):
    """(b) of the templates phase: e-commerce, similar-product, the Universal
    Recommender, similar-user and classification through ``pio template
    get`` → ``build`` → ``train`` → ``deploy`` (module docstring)."""
    import re
    import shutil
    import tempfile

    import numpy as np
    import torch

    from predictionio_tpu_torch.core import workflow
    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.data.storage import sqlite
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.ops import train_kernel
    from predictionio_tpu_torch.tools import cli

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="pio-templates-")
    saved = {k: v for k, v in os.environ.items()
             if k.startswith("PIO_STORAGE_") or k in ("PIO_FS_BASEDIR", "PIO_ALS_SOLVER",
                                                       "PIO_ALS_COMPUTE_DTYPE", "PIO_IVF_NLIST")}
    for k in saved:
        del os.environ[k]
    os.environ["PIO_FS_BASEDIR"] = os.path.join(tmp, "base")
    Storage.reset_instance()
    store.set_storage(None)
    ctx = DeviceContext.create(device=device)
    rng = np.random.default_rng(seed + 41)
    out = {"phase": "templates", "step": "templates-cli", "templates": {}}
    servers = []
    try:
        key = re.search(r"Access Key: (\S+)", cli_run("app", "new", TPL_APP)).group(1)
        storage = Storage.instance()
        app_id = storage.get_meta_data_apps().get_by_name(TPL_APP).id
        t0 = time.perf_counter()
        events, counts = template_events(seed, rng)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for c in range(0, len(events), QS_BULK_CHUNK):
            storage.get_l_events().insert_batch(events[c:c + QS_BULK_CHUNK], app_id)
        out["events"] = {**counts, "stored": len(events), "build_s": build_s,
                         "insert_s": time.perf_counter() - t0}
        emit({"phase": "templates", "step": "templates-cli-events", **out["events"]})
        del events

        reads = []
        find_interactions = sqlite.SqlitePEvents.find_interactions

        def recording(self, *a, **kw):
            reads.append(find_interactions(self, *a, **kw))
            return reads[-1]

        def train(name, algorithms, directory=None, **datasource):
            """template get → build → train in this process; the instance,
            its engine and models, and kernel 2's launches."""
            t_start[0] = time.perf_counter()
            eng = os.path.join(tmp, directory or name)
            cli_run("template", "get", name, "--directory", eng)
            variant = fill_engine_json(os.path.join(eng, "engine.json"), TPL_APP, algorithms,
                                       **datasource)
            cli_run("build", "--engine-dir", eng)
            reads.clear()
            sqlite.SqlitePEvents.find_interactions = recording
            train_kernel.launches.reset()
            try:
                t0 = time.perf_counter()
                trained = cli_run("train", "--engine-dir", eng, "--device", device.type)
                train_s = time.perf_counter() - t0
            finally:
                sqlite.SqlitePEvents.find_interactions = find_interactions
            launches = train_kernel.launches.count
            iid = re.search(r"Engine instance ID: (\S+)", trained).group(1)
            inst = storage.get_meta_data_engine_instances().get(iid)
            require(inst.status == "COMPLETED", f"{name}: pio train instance {inst.status}")
            engine = cli.resolve_engine_from_variant(variant)
            ep = engine.params_from_variant(variant)
            _, _, _, models = workflow.prepare_deploy(engine, inst, storage=storage, ctx=ctx)
            row = {"instance": iid, "train_s": train_s, "kernel2_launches": launches}
            if reads:  # an implicit-ALS template: every bucket, every iteration
                cfg = als.ALSConfig(rank=RANK, iterations=TPL_ITERS, implicit=True)
                ub, ib, _, _ = als._dense_blocks_for(reads[-1], cfg)
                buckets = len(ub.widths) + len(ib.widths)
                row.update(ratings=len(reads[-1]), buckets=buckets, iterations=TPL_ITERS)
                require(launches == buckets * TPL_ITERS,
                        f"{name}: kernel 2 launched {launches} times vs {buckets} buckets × {TPL_ITERS}")
                # after the count: these comparison launches do not count
                row["kernel2_implicit_held"] = hold_implicit_training(
                    name, reads[-1], models[0].als, engine.make_algorithms(ep)[0].params, device)
            else:
                require(launches == 0, f"{name}: kernel 2 launched {launches} times")
            return eng, engine, ep, models, row

        t_start = [0.0]  # when the template now under way began

        def in_process(engine, ep, models, query):
            algos, serving = engine.make_algorithms(ep), engine.make_serving(ep)
            q = serving.supplement(engine.query_cls(**query))
            return serving.serve(q, [a.predict(m, q) for a, m in zip(algos, models)])

        def serve_and_hold(name, eng, engine, ep, models, queries, plain=None, batching=False):
            """Deploy, answer ``queries`` over HTTP, each equal to the same
            model's answer in this process and, where ``plain`` gives one, to
            plain host code by rule 4."""
            qs = ThreadServer("deploy", "--engine-dir", eng, "--device", device.type,
                              *(["--batching"] if batching else []))
            servers.append(qs)
            ready_s = qs.wait_ready()
            store.set_storage(storage)
            gap = 0.0
            try:
                for q in queries:
                    status, got = http_json(f"{qs.base}/queries.json", q)
                    require(status == 200, f"{name} {q}: {status} {got}")
                    got.pop("degraded", None)
                    want = in_process(engine, ep, models, q)
                    require(same_json(got, want), f"{name} {q}: served {got} vs in process {want}")
                    if plain is not None:
                        p = plain(q)
                        if p is not None:
                            gap = max(gap, p(got))
            finally:
                store.set_storage(None)
            return qs, {"deploy_to_ready_s": ready_s, "queries": len(queries),
                        "max_abs_err_plain": gap}

        # -- e-commerce: implicit ALS, popular fallback, live business rules
        eng, engine, ep, models, row = train("ecommercerecommendation", [{
            "name": "ecomm", "params": {"appName": TPL_APP, "rank": RANK,
                                        "numIterations": TPL_ITERS, "unseenOnly": True}}])
        m = models[0]
        inv = m.als.item_map.inverse
        cats = {j: set(m.item_categories.get(inv[j], ())) for j in range(len(inv))}

        def seen(user):
            return {e.target_entity_id for e in storage.get_l_events().find(
                app_id, entity_type="user", entity_id=user, event_names=["view", "buy"])}

        def unavailable():
            evs = list(storage.get_l_events().find(
                app_id, entity_type="constraint", entity_id="unavailableItems",
                event_names=["$set"], reversed=True, limit=1))
            return set(evs[0].properties.get("items") or []) if evs else set()

        def ecomm_plain(q):
            u = m.als.user_map.get(q["user"])
            scores = (m.als.item_factors.astype(np.float64) @ m.als.user_factors[u] if u is not None
                      else m.popular.astype(np.float64))
            drop = seen(q["user"]) | unavailable() | set(q.get("blackList") or ())
            keep = np.array([inv[j] not in drop for j in range(len(inv))])
            if q.get("whiteList"):
                keep &= np.array([inv[j] in set(q["whiteList"]) for j in range(len(inv))])
            if q.get("categories"):
                keep &= np.array([bool(cats[j] & set(q["categories"])) for j in range(len(inv))])
            return lambda got: hold_topn(got["itemScores"], scores, keep, q["num"],
                                         m.als.item_map, f"ecommerce {q}")

        users = [m.als.user_map.inverse[int(u)] for u in rng.choice(len(m.als.user_map), TPL_QUERIES,
                                                                     replace=False)]
        popular_items = [inv[int(j)] for j in np.argsort(-m.popular)[:40]]
        queries = ([{"user": u, "num": 10} for u in users]
                   + [{"user": users[0], "num": 8, "categories": ["g1", "even"]},
                      {"user": users[1], "num": 5, "whiteList": popular_items[::2]},
                      {"user": users[2], "num": 6, "blackList": popular_items[:10]},
                      {"user": "no-such-user", "num": 10}])
        es = ThreadServer("eventserver")
        servers.append(es)
        es.wait_ready()
        qs, serve = serve_and_hold("ecommerce", eng, engine, ep, models, queries, ecomm_plain)
        # unseenOnly through the event cache: a view posted now drops the
        # item from that user's next answer (event-driven invalidation)
        user = users[3]
        first = http_json(f"{qs.base}/queries.json", {"user": user, "num": 5})[1]["itemScores"]
        top = first[0]["item"]
        status, _ = http_json(f"{es.base}/events.json?accessKey={key}", {
            "event": "view", "entityType": "user", "entityId": user,
            "targetEntityType": "item", "targetEntityId": top})
        require(status == 201, f"POST view: {status}")
        after = http_json(f"{qs.base}/queries.json", {"user": user, "num": 5})[1]["itemScores"]
        require(top not in {r["item"] for r in after}, f"ecommerce unseenOnly: {top} still served")
        # the unavailableItems constraint, $set through the event server
        banned = [r["item"] for r in after[:2]]
        status, _ = http_json(f"{es.base}/events.json?accessKey={key}", {
            "event": "$set", "entityType": "constraint", "entityId": "unavailableItems",
            "properties": {"items": banned}})
        require(status == 201, f"POST $set constraint: {status}")
        store.set_storage(storage)
        try:
            for q in ({"user": user, "num": 5}, {"user": "no-such-user", "num": 5}):
                got = http_json(f"{qs.base}/queries.json", q)[1]
                require(not {r["item"] for r in got["itemScores"]} & set(banned),
                        f"ecommerce unavailableItems {q}: {got}")
                serve["max_abs_err_plain"] = max(serve["max_abs_err_plain"], ecomm_plain(q)(got))
        finally:
            store.set_storage(None)
        metrics = urllib.request.urlopen(f"{qs.base}/metrics", timeout=10).read().decode()
        inval = re.search(r"^pio_event_cache_invalidated_total (\S+)$", metrics, re.M)
        require(inval is not None and float(inval.group(1)) >= 1,
                f"pio_event_cache_invalidated_total: {inval}")
        serve["event_cache_invalidated"] = float(inval.group(1))
        qs.stop(["undeploy", "--port", str(qs.port)])
        require(http_json(f"{es.base}/stop", method="POST")[0] == 202, "eventserver POST /stop")
        es.thread.join(60)
        row.update(serve)

        # kernel 2, implicit, on this template's training data: one
        # iteration's buckets (both sides) at f32, against its bound and the
        # gathered-rows bmm yardstick; then a whole iteration
        read = reads[-1]
        cfg = als.ALSConfig(rank=RANK, iterations=TPL_ITERS, implicit=True, seed=3)
        ub, ib, u_perm, i_perm = als._dense_blocks_for(read, cfg)
        U = torch.from_numpy(m.als.user_factors[np.argsort(u_perm)]).to(device)
        V = torch.from_numpy(m.als.item_factors[np.argsort(i_perm)]).to(device)
        geo, calls, yard = [], [], []
        for blocks, opp in ((ub, V), (ib, U)):
            dev_blocks = [tuple(torch.from_numpy(x).to(device) for x in t)
                          for t in zip(blocks.idx, blocks.rat, blocks.msk)]
            geo.append(([(mk.shape[0], mk.shape[1], int(mk.sum())) for mk in blocks.msk], opp.shape[0]))
            calls += [(b, opp) for b in dev_blocks]
            yard += [(opp[b[0].long()] * b[2][:, :, None]).contiguous() for b in dev_blocks]

        def kern():
            return [train_kernel.fused_train_normal_eq(*b, opp, implicit=True, alpha=1.0)
                    for b, opp in calls]

        def iteration():
            Un = als._dense_half_step([b for b, _ in calls[:len(ub.widths)]], V, als._gram(V), cfg)
            return als._dense_half_step([b for b, _ in calls[len(ub.widths):]], Un, als._gram(Un), cfg)

        bms = [train_bound(g, n_opp, RANK, "f32") for g, n_opp in geo]
        iter_s = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            iteration()
            torch.cuda.synchronize()
            iter_s.append(time.perf_counter() - t0)
        dev = device_us(kern, 5)
        row["kernel2_implicit"] = {
            "buckets": len(calls), "ms": cuda_ms(kern, 10),
            "device_us": sum(v for k, v in dev.items() if "normal_eq" in k or "train" in k),
            "device_us_by_kernel": dev,
            "plain_ms": cuda_ms(lambda: [train_kernel.train_normal_eq_reference(
                *b, opp, implicit=True, alpha=1.0) for b, opp in calls], 3),
            "bound_ms": sum(b for b, _ in bms),
            "bound_by": "bytes" if all(by == "bytes" for _, by in bms) else "operations",
            "library_ms": cuda_ms(lambda: [torch.bmm(W.transpose(1, 2), W) for W in yard], 10),
            "iteration_ms": sorted(iter_s)[2] * 1e3, "iteration_ms_all": [s * 1e3 for s in iter_s]}
        del calls, yard, U, V
        row["seconds"] = time.perf_counter() - t_start[0]
        out["templates"]["ecommercerecommendation"] = row
        emit({"phase": "templates", "step": "ecommercerecommendation", **row})

        # -- similar-product: implicit ALS + LLR co-occurrence, SumServing, batched
        eng, engine, ep, models, row = train("similarproduct", [
            {"name": "als", "params": {"rank": RANK, "numIterations": TPL_ITERS}},
            {"name": "cooccurrence", "params": {"n": 20, "llr": True}}])
        am, cm = models[0], models[1].cooccurrence
        inv = am.als.item_map.inverse
        cats = {j: set(am.item_categories.get(inv[j], ())) for j in range(len(inv))}

        def sp_plain(q):
            """SumServing adds the ALS list (mean cosine) and the LLR
            co-occurrence list (summed indicator scores), each cut to ``num``
            on its own; the plain check holds the ALS algorithm's part and
            the co-occurrence part in this process, then the served sum."""
            idx = [am.als.item_map[i] for i in q["items"] if i in am.als.item_map]
            keep = np.ones(len(inv), bool)
            keep[idx] = False
            for i in q.get("blackList") or ():
                if i in am.als.item_map:
                    keep[am.als.item_map[i]] = False
            if q.get("categories"):
                keep &= np.array([bool(cats[j] & set(q["categories"])) for j in range(len(inv))])
            sims = am.norm_factors.astype(np.float64) @ am.norm_factors[idx].mean(axis=0)
            co_scores = np.zeros(len(inv))
            for j in idx:
                top_items, top_scores = cm.similar(j, 20)
                co_scores[top_items] += top_scores
            algos = engine.make_algorithms(ep)
            query = engine.query_cls(**q)
            parts = [algos[0].predict(am, query), algos[1].predict(models[1], query)]
            gap = max(
                hold_topn([{"item": x.item, "score": x.score} for x in parts[0].itemScores],
                          sims, keep, q["num"], am.als.item_map, f"similarproduct als {q}"),
                hold_topn([{"item": x.item, "score": x.score} for x in parts[1].itemScores],
                          co_scores, keep & (co_scores > 0), q["num"], am.als.item_map,
                          f"similarproduct cooccurrence {q}"))
            total = np.zeros(len(inv))
            for part in parts:
                for x in part.itemScores:
                    total[am.als.item_map[x.item]] += x.score
            return lambda got: max(gap, hold_topn(got["itemScores"], total, total != 0, q["num"],
                                                  am.als.item_map, f"similarproduct {q}"))

        items = [inv[int(j)] for j in rng.choice(len(inv), TPL_QUERIES, replace=False)]
        queries = ([{"items": [i], "num": 10} for i in items]
                   + [{"items": items[:3], "num": 8},
                      {"items": [items[0]], "num": 6, "categories": ["g2"]},
                      {"items": [items[1]], "num": 6, "blackList": items[2:6]}])
        qs, serve = serve_and_hold("similarproduct", eng, engine, ep, models, queries, sp_plain,
                                   batching=True)
        qs.stop(["undeploy", "--port", str(qs.port)])
        row.update(serve)
        row["seconds"] = time.perf_counter() - t_start[0]
        out["templates"]["similarproduct"] = row
        emit({"phase": "templates", "step": "similarproduct", **row})

        # -- the Universal Recommender: buy + view, answers from live histories
        eng, engine, ep, models, row = train("universalrecommender", [
            {"name": "ur", "params": {"appName": TPL_APP, "maxCorrelatorsPerItem": UR_K}}],
            eventNames=["buy", "view"])
        um = models[0]
        buyers = sorted({e.entity_id for e in storage.get_l_events().find(
            app_id, entity_type="user", event_names=["buy"])})
        users = [buyers[int(k)] for k in rng.choice(len(buyers), TPL_QUERIES, replace=False)]

        def ur_plain(q):
            hist = {n: [e.target_entity_id for e in storage.get_l_events().find(
                app_id, entity_type="user", entity_id=q["user"], event_names=[n],
                target_entity_type="item", limit=100, reversed=True)] for n in ("buy", "view")}
            scores, keep = ur_predict_plain(um, hist, q.get("blackList") or ())
            return lambda got: hold_topn(got["itemScores"], scores, keep, q["num"], um.item_map,
                                         f"ur {q}")

        queries = [{"user": u, "num": 10} for u in users] + [
            {"user": users[0], "num": 5, "blackList": [users[0]]}, {"user": "no-such-user", "num": 5}]
        qs, serve = serve_and_hold("universalrecommender", eng, engine, ep, models, queries, ur_plain)
        qs.stop(["undeploy", "--port", str(qs.port)])
        row.update(serve)
        row["seconds"] = time.perf_counter() - t_start[0]
        out["templates"]["universalrecommender"] = row
        emit({"phase": "templates", "step": "universalrecommender", **row})

        # -- similar-user: implicit ALS over follows
        eng, engine, ep, models, row = train("similaruser", [
            {"name": "als", "params": {"rank": RANK, "numIterations": TPL_ITERS}}])
        sm = models[0]
        finv = sm.als.item_map.inverse

        def su_plain(q):
            idx = [sm.als.item_map[u] for u in q["users"] if u in sm.als.item_map]
            if not idx:
                return None
            sims = sm.norm_factors.astype(np.float64) @ sm.norm_factors[idx].sum(axis=0)
            keep = sims > 0
            keep[idx] = False
            for u in q.get("blackList") or ():
                if u in sm.als.item_map:
                    keep[sm.als.item_map[u]] = False
            return lambda got: hold_topn(got["similarUserScores"], sims, keep, q["num"],
                                         sm.als.item_map, f"similaruser {q}", field="user")

        followed = [finv[int(j)] for j in rng.choice(len(finv), TPL_QUERIES, replace=False)]
        queries = ([{"users": [u], "num": 10} for u in followed]
                   + [{"users": followed[:2], "num": 8, "blackList": followed[2:5]}])
        qs, serve = serve_and_hold("similaruser", eng, engine, ep, models, queries, su_plain)
        qs.stop(["undeploy", "--port", str(qs.port)])
        row.update(serve)
        row["seconds"] = time.perf_counter() - t_start[0]
        out["templates"]["similaruser"] = row
        emit({"phase": "templates", "step": "similaruser", **row})

        # -- classification: naive Bayes and a random forest over $set properties
        eng, engine, ep, models, row = train("classification", [
            {"name": "naive", "params": {"lambda": 1.0}},
            {"name": "randomforest", "params": {"numTrees": 10, "maxDepth": 5, "seed": seed}}])
        nb_model, rf_model = models
        t_cls = t_start[0]
        feats = rng.uniform(0, 10, (TPL_QUERIES, 3))
        queries = [{"features": [float(x) for x in f]} for f in feats]
        qs, serve = serve_and_hold("classification", eng, engine, ep, models, queries)
        qs.stop(["undeploy", "--port", str(qs.port)])
        # plain host code: NB's argmax of x·log θᵀ + log prior, and the tree
        # walk of the forest's first algorithm slot is FirstServing's answer
        for f in feats:
            s = f.astype(np.float32) @ nb_model.log_theta.T + nb_model.log_prior
            want = nb_model.label_map.inverse[int(np.argmax(s))]
            got = in_process(engine, ep, models, {"features": [float(x) for x in f]}).label
            require(got == want, f"classification {f}: {got} vs NB argmax {want}")
        truth = ["premium" if a + b > 10 else "basic" for a, b, _ in feats]
        row["nb_accuracy_on_queries"] = float(np.mean([
            nb_model.predict(f.astype(np.float32)) == t for f, t in zip(feats, truth)]))
        row["rf_accuracy_on_queries"] = float(np.mean([
            rf_model.predict(f.astype(np.float32)) == t for f, t in zip(feats, truth)]))
        row.update(serve)
        # the forest served: an engine whose first algorithm is the forest,
        # held against the plain tree walk of its arrays
        eng, engine, ep, models, rf_row = train("classification", [
            {"name": "randomforest", "params": {"numTrees": 10, "maxDepth": 5, "seed": seed}}],
            directory="classification-rf")
        qs, rf_serve = serve_and_hold("classification-rf", eng, engine, ep, models, queries)
        qs.stop(["undeploy", "--port", str(qs.port)])
        for f in feats:
            want = rf_plain(models[0], f.astype(np.float32))
            got = in_process(engine, ep, models, {"features": [float(x) for x in f]}).label
            require(got == want, f"classification (forest) {f}: {got} vs tree walk {want}")
        row["randomforest_served"] = {"train_s": rf_row["train_s"], **rf_serve}
        row["seconds"] = time.perf_counter() - t_cls
        out["templates"]["classification"] = row
        emit({"phase": "templates", "step": "classification", **row})
    finally:
        for srv in servers:
            if srv.thread.is_alive():
                try:
                    urllib.request.urlopen(urllib.request.Request(f"{srv.base}/stop", method="POST"),
                                           timeout=5).close()
                except OSError:
                    pass
                srv.thread.join(30)
        store.set_storage(None)
        Storage.reset_instance()
        sqlite.close_all_dbs()
        os.environ.pop("PIO_FS_BASEDIR", None)
        os.environ.update(saved)
        shutil.rmtree(tmp, ignore_errors=True)
    out.update(seconds=time.perf_counter() - t_phase, ok=True)
    emit(out)
    return out


# -- A/B: kernels 1 and 2 of two trees, on one card ---------------------------


# (B·H, T_q, T_kv, h) of the A/B's flash timings, causal: kernel 4 at the
# serving and training shapes, kernels 5 and 6 at BWD_TIMED
# -- fleet: replicas behind the router, chaos, canary, tenants, pipeline -------

FLEET_APP = "Fleet"
FLEET_N = 3  # replicas of `pio deploy --fleet`
FLEET_REQUESTS = 500  # each closed loop through the router (2,000 until the sharded and ring phases came, 1,000 until the dist phases)
FLEET_CONCURRENCY = (1, 16)
FLEET_DIRECT_REQUESTS = 500  # one replica's own closed loop at the same concurrency (1,000 until the dist phases)
FLEET_SAMPLED = 200  # answers through the router held against the plain version
FLEET_CLIENTS = 16  # the closed loop under the kill, the rolls and the canaries
FLEET_BAD_ID = "fleet-bad-generation"  # the faulted canary candidate's instance id
FLEET_BAD_P = 0.15  # the share of its answers the faulted candidate fails
FLEET_SCALE_CLIENTS = 6  # the autoscaler's load step, against 8 slots a replica
TEN_QUOTA_QPS = 100.0  # tenant A's quota
TEN_FLOOD = 2000  # tenant A's requests in the flood (16 clients)
TEN_B_REQUESTS = 1000  # tenant B's closed loop (4 clients), alone and under the flood
PIPE_CANDIDATES = 2048  # the retrieval stage's candidates (under ALSScorer.MAX_FILTER)
PIPE_QUERIES = 200  # pipeline answers held against the exact top-k over their candidates


def free_port_run(n: int) -> int:
    """A port p with p .. p+n-1 all free (the fleet's router and replicas)."""
    import random
    import socket

    rng = random.Random()
    for _ in range(200):
        base = rng.randrange(20_000, 60_000 - n)
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("check failed: no run of free ports")


class ClosedLoop:
    """``clients`` workers, one keep-alive connection each, sending the next
    query of a seeded Zipf stream over ``users`` as soon as the last one
    answered, until stopped or ``total`` requests were sent. Every answer
    but a 200, and every transport error, is a client-visible failure,
    kept with its status, body and ``Retry-After``."""

    def __init__(self, port, users, seed, clients=FLEET_CLIENTS, total=None, extra=None,
                 headers=None):
        import threading

        import numpy as np

        self.port, self.users, self.total = port, users, total
        self.extra, self.headers = dict(extra or {}), dict(headers or {})
        p = zipf_mandelbrot_weights(len(users), 1.1)
        rng = np.random.default_rng(seed)
        self.picks = [rng.choice(len(users), size=4096, p=p) for _ in range(clients)]
        self.stop_evt = threading.Event()
        self.lock = threading.Lock()
        self.sent = 0
        self.ok = 0
        self.failures = []
        self.latencies_ms = []
        self.threads = [threading.Thread(target=self._run, args=(i,), daemon=True)
                        for i in range(clients)]

    def _ticket(self) -> bool:
        with self.lock:
            if self.total is not None and self.sent >= self.total:
                return False
            self.sent += 1
            return True

    def _run(self, i):
        import http.client

        conn = None
        j = 0
        while not self.stop_evt.is_set() and self._ticket():
            user = self.users[int(self.picks[i][j % len(self.picks[i])])]
            j += 1
            body = json.dumps({"user": user, "num": OPS_NUM, **self.extra})
            t0 = time.perf_counter()
            try:
                if conn is None:
                    conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
                conn.request("POST", "/queries.json", body,
                             {"Content-Type": "application/json", **self.headers})
                r = conn.getresponse()
                data = r.read()
                status, retry = r.status, r.getheader("Retry-After")
                if r.getheader("Connection", "").lower() == "close":
                    conn.close()
                    conn = None
            except (OSError, http.client.HTTPException) as e:
                if conn is not None:
                    conn.close()
                conn = None
                with self.lock:
                    self.failures.append({"error": f"{type(e).__name__}: {e}"})
                continue
            ms = (time.perf_counter() - t0) * 1e3
            with self.lock:
                if status == 200:
                    self.ok += 1
                    self.latencies_ms.append(ms)
                else:
                    self.failures.append({"status": status, "retry_after": retry,
                                          "body": data[:200].decode("utf-8", "replace")})
        if conn is not None:
            conn.close()

    def start(self) -> "ClosedLoop":
        for t in self.threads:
            t.start()
        return self

    def wait_ok(self, n, timeout=60.0):
        t_end = time.monotonic() + timeout
        while self.ok < n and time.monotonic() < t_end:
            time.sleep(0.02)
        require(self.ok >= n, f"the closed loop answered {self.ok} of {n} queries in {timeout} s")

    def stop(self) -> dict:
        """Stop (a loop of ``total`` requests runs to its end first) and
        tally what the clients saw."""
        import numpy as np

        if self.total is None:
            self.stop_evt.set()
        for t in self.threads:
            t.join(120)
        lat = np.asarray(self.latencies_ms or [0.0])
        return {"sent": self.sent, "ok": self.ok, "failures": len(self.failures),
                "first_failures": self.failures[:3],
                "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99))}


def phase_fleet(model, seed, device):
    """The fleet on the card: see the module docstring, phase 18."""
    import contextlib
    import pickle
    import random
    import re
    import shutil
    import signal
    import tempfile

    import numpy as np

    from predictionio_tpu_torch.common import faults
    from predictionio_tpu_torch.core import persistence
    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.data.storage import sqlite
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.serving.autoscaler import Autoscaler
    from predictionio_tpu_torch.serving.fleet import PREEMPT_SITE, FleetSupervisor
    from predictionio_tpu_torch.serving.pipeline import _ivf_candidates
    from predictionio_tpu_torch.serving.router import ADMITTED, Router
    from predictionio_tpu_torch.templates import recommendation as rec
    from predictionio_tpu_torch.testing import topk_mismatches
    from predictionio_tpu_torch.tools import cli

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="pio-fleet-")
    knobs = ("PIO_FS_BASEDIR", "PIO_DEVPROF_WINDOW", "PIO_QUANT_DTYPE", "PIO_QUANT_MIN_OVERLAP",
             "PIO_IVF_NLIST", "PIO_IVF_NPROBE", "PIO_RETRIEVAL", "PIO_RESULT_CACHE",
             "PIO_COALESCE", "PIO_STREAMING", "PIO_TENANTS", "PIO_PIPELINE", "PIO_FAULT_SPEC",
             "PIO_FAULT_SEED", "PIO_PIN_INSTANCE", "PIO_AUTOSCALE", "PIO_CANARY")
    saved = {k: v for k, v in os.environ.items()
             if k.startswith(("PIO_STORAGE_", "PIO_FLEET_", "PIO_CANARY_", "PIO_ROUTER_",
                              "PIO_HEDGE_", "PIO_AUTOSCALE_", "PIO_TENANT")) or k in knobs}
    for k in saved:
        del os.environ[k]
    os.environ["PIO_FS_BASEDIR"] = os.path.join(tmp, "base")
    Storage.reset_instance()
    store.set_storage(None)
    procs, routers = [], []
    out = {"phase": "fleet", "seconds": {}}
    U, V = model.user_factors, model.item_factors
    users = [model.user_map.inverse[j] for j in range(len(model.user_map))]
    sample = "user=" + ",".join(users)
    query = json.dumps({"user": users[0], "num": OPS_NUM})
    rng = np.random.default_rng(seed + 97)

    def step(name, **row):
        row["t"] = time.perf_counter() - t_phase
        emit({"phase": "fleet", "step": name, **row})
        return row

    def info(port):
        return http_json(f"http://127.0.0.1:{port}/")[1]

    def spawn(name, argv, env=None):
        log = open(os.path.join(tmp, f"{name}.log"), "w")
        # a session of its own: the fleet router's replicas share its
        # process group, so one killpg ends them all whatever happened
        p = subprocess.Popen(CLI + argv, cwd=ROOT, stdout=subprocess.DEVNULL, stderr=log,
                             env=dict(os.environ, PYTHONPATH=ROOT, **(env or {})),
                             start_new_session=True)
        p.log_path = log.name
        procs.append(p)
        return p

    def tail(p):
        with open(p.log_path) as f:
            return f.read()[-3000:]

    def wait_ready(port, proc, t0, timeout=300.0):
        """Seconds from ``t0`` to the first 200 on the server's /readyz."""
        t_end = time.monotonic() + timeout
        while time.monotonic() < t_end:
            require(proc.poll() is None, f"server exited {proc.returncode}: {tail(proc)}")
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz", timeout=5) as r:
                    if r.status == 200:
                        return time.perf_counter() - t0
            except OSError:
                pass
            time.sleep(0.02)
        raise RuntimeError(f"check failed: :{port}/readyz never answered 200: {tail(proc)}")

    def wait_for(cond, what, timeout=120.0, every=0.05):
        t_end = time.monotonic() + timeout
        while time.monotonic() < t_end:
            v = cond()
            if v:
                return v
            time.sleep(every)
        raise RuntimeError(f"check failed: {what} within {timeout} s")

    def no_failures(load, what):
        r = load.stop()
        require(r["failures"] == 0 and r["ok"] > 0, f"{what}: client-visible failures {r}")
        return r

    try:
        storage = Storage.instance()
        cli_run("app", "new", FLEET_APP)
        engine = rec.RecommendationEngine.apply()
        eng = os.path.join(tmp, "engine-fleet")
        variant = write_engine_json(eng, "fleet", {"rank": RANK})
        ckpt_variant = write_engine_json(os.path.join(tmp, "engine-int8"), "fleet",
                                         {"rank": RANK, "persistMode": "checkpoint"})

        def pub(m, v=variant, **kw):
            return publish(storage, engine, m, variant=v, engine_id=ALS_FACTORY,
                           engine_variant="fleet", **kw)

        gen = {"base": pub(model)}

        # (a) fleet-route: pio deploy --batching --fleet 3, the router on
        # `base`, the replicas on the next three ports
        t_a = time.perf_counter()
        base = free_port_run(1 + FLEET_N)
        rports = [base + 1 + i for i in range(FLEET_N)]
        fleet_env = {
            # the bad canary candidate's seeded error rule (replicas consult
            # it on /queries.json while that instance is deployed; nothing
            # else matches it): 15% of its answers fail, 5% of the fleet's,
            # inside the router's 10% retry budget
            "PIO_FAULT_SPEC": (f"site=server:generation:{FLEET_BAD_ID},kind=error,status=500,"
                               f"p={FLEET_BAD_P}"),
            "PIO_FAULT_SEED": str(seed),
            "PIO_CANARY_TICK_MS": "100", "PIO_CANARY_MIN_SAMPLES": "30",
            "PIO_CANARY_WINDOW_S": "3", "PIO_CANARY_SOAK_S": "2",
            "PIO_CANARY_P99_SLO_MS": "1000",
            # one device-time accountant window a replica for the phase
            "PIO_DEVPROF_WINDOW": "3600",
        }
        t_spawn = time.perf_counter()
        router_proc = spawn("fleet-router", [
            "deploy", "--engine-dir", eng, "--batching", "--fleet", str(FLEET_N), "--canary",
            "--device", device.type, "--ip", "127.0.0.1", "--port", str(base)], fleet_env)
        ready_s = {p: wait_ready(p, router_proc, t_spawn) for p in rports}

        def fleet_view():
            return http_json(f"http://127.0.0.1:{base}/")[1]

        wait_for(lambda: (lambda v: v["available"] == FLEET_N and all(
            r["state"] == ADMITTED and r["instanceId"] == gen["base"] and r["warm"]
            for r in v["replicas"]))(fleet_view()), "the router admitting all three replicas")
        router_ready_s = time.perf_counter() - t_spawn
        replicas = http_json(f"http://127.0.0.1:{base}/fleet")[1]["fleet"]["replicas"]
        pids = {r["port"]: r["pid"] for r in replicas}
        at_ready = {p: info(p) for p in rports}
        builds = {p: at_ready[p]["kernelBuildCached"] for p in rports}
        require(all(b.get("score_topk") for b in builds.values()),
                f"every replica loads kernel 1 from the build cache: {builds}")
        # the router is host code: no CUDA context, no torch in its process
        smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.split()
        smi_pids = {int(x) for x in smi if x.strip().isdigit()}
        with open(f"/proc/{router_proc.pid}/maps") as f:
            maps = f.read()
        router_libs = {lib: lib in maps for lib in ("libcuda.so", "libtorch", "libcudart")}
        require(not router_libs["libcuda.so"] and not router_libs["libtorch"],
                f"the router process maps {router_libs}")
        same_ns = bool(smi_pids & set(pids.values()))
        if same_ns:
            require(set(pids.values()) <= smi_pids and router_proc.pid not in smi_pids,
                    f"nvidia-smi compute apps {sorted(smi_pids)}: replicas {pids}, "
                    f"router {router_proc.pid}")
        out["deploy"] = step(
            "deploy", replicas=FLEET_N, deploy_to_ready_s=ready_s,
            router_admits_all_s=router_ready_s, build_cached=builds,
            kernel_builds={p: at_ready[p]["kernelBuilds"] for p in rports},
            replica_pids=pids, router_pid=router_proc.pid, nvidia_smi_pids=sorted(smi_pids),
            nvidia_smi_shares_pid_namespace=same_ns, router_maps=router_libs)

        def router_attempts(before, after):
            c = {k: after["counters"].get(k, 0) - before["counters"].get(k, 0)
                 for k in after["counters"]}
            return c, c["ok"] + c["client_error"] + c["failed"] + c["retries"] + c["hedges_fired"]

        loops = []
        for c in FLEET_CONCURRENCY:
            rb, b4 = fleet_view(), {p: info(p) for p in rports}
            rc, rep = run_loadtest_cli(
                "--port", str(base), "--query", query, "--requests", str(FLEET_REQUESTS),
                "--concurrency", str(c), "--dist", "zipf", "--sample", sample)
            ra, aft = fleet_view(), {p: info(p) for p in rports}
            require(rc == 0 and rep["ok"] == FLEET_REQUESTS and rep["http5xx"] == 0,
                    f"router closed loop c={c}: exit {rc}, {rep}")
            per = {}
            for p in rports:
                launches = aft[p]["scoreKernelLaunches"] - b4[p]["scoreKernelLaunches"]
                dispatches = aft[p]["fastpath"][0]["calls"] - b4[p]["fastpath"][0]["calls"]
                served = aft[p]["requestCount"] - b4[p]["requestCount"]
                require(launches == dispatches, f"c={c} :{p}: kernel 1 launched {launches} "
                                                f"times vs {dispatches} dispatches")
                per[p] = {"launches": launches, "dispatches": dispatches, "queries": served}
            busy = {p: _device_totals(aft[p])["busy_s"] - _device_totals(b4[p])["busy_s"]
                    for p in rports}
            counters, attempts = router_attempts(rb, ra)
            require(counters["failed"] == 0 and counters["shed"] == 0, f"router {counters}")
            require(sum(r["queries"] for r in per.values()) == attempts,
                    f"c={c}: replicas served {per}, the router forwarded {attempts} ({counters})")
            if c == 1:  # one query at a time a replica: a launch each
                require(sum(r["launches"] for r in per.values()) == attempts,
                        f"c=1: launches {per} vs forwarded attempts {attempts}")
            rc, drep = run_loadtest_cli(
                "--port", str(rports[0]), "--query", query, "--requests",
                str(FLEET_DIRECT_REQUESTS), "--concurrency", str(c), "--dist", "zipf",
                "--sample", sample)
            require(rc == 0 and drep["ok"] == FLEET_DIRECT_REQUESTS, f"direct c={c}: {drep}")
            loops.append(step(
                "route", concurrency=c, requests=rep["requests"], qps=rep["qps"],
                p50_ms=rep["p50Ms"], p99_ms=rep["p99Ms"], direct_p50_ms=drep["p50Ms"],
                direct_p99_ms=drep["p99Ms"], direct_qps=drep["qps"], forwarded=attempts,
                retries=counters["retries"], hedges_fired=counters["hedges_fired"],
                hedges_won=counters["hedges_won"], hedges_denied=counters["hedges_denied"],
                wall_s=rep["wallSec"], card_busy_s=busy,
                card_busy_share=sum(busy.values()) / rep["wallSec"], per_replica=per))
        out["route"] = loops
        picks = [(users[int(j)], int(rng.integers(1, K + 1)))
                 for j in rng.integers(0, len(users), FLEET_SAMPLED)]
        answers = []
        for u, n in picks:
            status, a = http_json(f"http://127.0.0.1:{base}/queries.json", {"user": u, "num": n})
            require(status == 200, f"{u}: {status} {a}")
            answers.append(a)
        out["route_max_gap"] = hold_topk(
            [a["itemScores"] for a in answers], U, V, [model.user_map[u] for u, _ in picks],
            [n for _, n in picks], model.item_map, "answers through the router")
        out["seconds"]["fleet-route"] = time.perf_counter() - t_a
        step("fleet-route", seconds=out["seconds"]["fleet-route"], held=FLEET_SAMPLED,
             max_gap=out["route_max_gap"])

        # (b) the roll under load: every replica restarts onto the newest
        # COMPLETED generation, zero client-visible failures
        t_b = time.perf_counter()
        gen["roll"] = pub(model)

        def replica_ports():
            return [r["port"] for r in http_json(f"http://127.0.0.1:{base}/fleet")[1]["fleet"]
                    ["replicas"]]

        def roll(what):
            t0 = time.perf_counter()
            load = ClosedLoop(base, users, seed + 1).start()
            load.wait_ok(100)
            cli_run("fleet", "roll", "--ip", "127.0.0.1", "--port", str(base), "--timeout", "300")
            r = no_failures(load, what)
            return {"seconds": time.perf_counter() - t0, "load": r,
                    "instances": {p: info(p)["engineInstanceId"] for p in replica_ports()}}

        rolled = roll("the roll")
        require(set(rolled["instances"].values()) == {gen["roll"]}, f"after the roll {rolled}")
        out["roll"] = step("roll", **rolled)

        # (c) canary: the int8 publish of the same factors promotes; a
        # faulted generation rolls back, is quarantined and stays skipped
        os.environ["PIO_QUANT_DTYPE"] = "int8"
        gen["int8"] = pub(als.CheckpointedALSModel(U, V, model.user_map, model.item_map,
                                                   model.config), v=ckpt_variant)
        del os.environ["PIO_QUANT_DTYPE"]
        with open(os.path.join(als.CheckpointedALSModel._dir(gen["int8"]), "maps.pkl"), "rb") as f:
            quant = pickle.load(f)["quant"]
        require(quant.get("dtype") == "int8", f"int8 publish: {quant}")

        def canary(what):
            t0 = time.perf_counter()
            load = ClosedLoop(base, users, seed + 2).start()
            load.wait_ok(100)
            cli_run("canary", "start", "--ip", "127.0.0.1", "--port", str(base))
            st = wait_for(lambda: (lambda s: s if s["state"] == "idle" and s.get("lastOutcome")
                                   else None)(http_json(f"http://127.0.0.1:{base}/canary")[1]),
                          f"the {what} canary ending", timeout=180)
            if what != "faulted":
                return st, {"seconds": time.perf_counter() - t0,
                            "load": no_failures(load, f"the {what} canary")}
            # the router retries an HTTP failure only inside its 10% retry
            # budget, which hedges share: a few of the candidate's injected
            # 500s may reach a client, and nothing else may
            r = load.stop()
            require(r["ok"] > 0 and all(f.get("status") == 500 and '"injected":true' in f["body"]
                                        for f in load.failures),
                    f"the faulted canary: failures other than its injected 500s {r}")
            return st, {"seconds": time.perf_counter() - t0, "load": r}

        st, good = canary("int8")
        require(st["lastOutcome"].get("outcome") == "promoted"
                and st["lastOutcome"].get("candidate") == gen["int8"], f"int8 canary: {st}")
        served = {p: info(p) for p in replica_ports()}
        require(all(i["engineInstanceId"] == gen["int8"]
                    and i["fastpath"][0]["kernel"]["factor_dtype"] == "int8"
                    for i in served.values()),
                f"after the promotion: {[(i['engineInstanceId'], i['fastpath'][0]['kernel']) for i in served.values()]}")
        out["canary_good"] = step("canary-promote", quant_overlap=quant.get("topk_overlap"),
                                  outcome=st["lastOutcome"], **good)
        gen["bad"] = pub(model, instance_id=FLEET_BAD_ID)
        st, bad = canary("faulted")
        require(st["lastOutcome"].get("outcome") == "quarantined"
                and st["lastOutcome"].get("candidate") == gen["bad"], f"faulted canary: {st}")
        receipt = os.path.join(persistence.quarantine_dir(ALS_FACTORY, "default", "fleet"),
                               f"{FLEET_BAD_ID}.json")
        require(persistence.is_quarantined(FLEET_BAD_ID, ALS_FACTORY, "default", "fleet")
                and os.path.exists(receipt), f"no quarantine receipt at {receipt}")
        rec_ = json.loads(persistence.open_blob_file(receipt))
        rolled = roll("the roll after the rollback")
        require(set(rolled["instances"].values()) == {gen["int8"]},
                f"the roll after the rollback deployed {rolled['instances']}")
        victim_port = replica_ports()[0]
        old_pid = {r["port"]: r["pid"] for r in http_json(
            f"http://127.0.0.1:{base}/fleet")[1]["fleet"]["replicas"]}[victim_port]
        t0 = time.perf_counter()
        os.kill(old_pid, signal.SIGKILL)
        wait_for(lambda: any(r["port"] == victim_port and r["pid"] != old_pid and r["alive"]
                             for r in http_json(f"http://127.0.0.1:{base}/fleet")[1]["fleet"]
                             ["replicas"]), "the killed replica respawned")
        cold_s = wait_ready(victim_port, router_proc, t0)
        cold = info(victim_port)
        require(cold["engineInstanceId"] == gen["int8"],
                f"the cold restart deployed {cold['engineInstanceId']}")
        out["canary_bad"] = step(
            "canary-rollback", outcome=st["lastOutcome"], receipt=rec_, **bad,
            roll_after=rolled, cold_restart={"instance": cold["engineInstanceId"],
                                             "deploy_to_ready_s": cold_s})
        status, _ = http_json(f"http://127.0.0.1:{base}/stop", {}, method="POST")
        require(status == 200, f"router stop: {status}")
        router_proc.wait(timeout=60)
        out["seconds"]["canary"] = time.perf_counter() - t_b
        step("canary", seconds=out["seconds"]["canary"])

        # (b) fleet-chaos: this process's router and supervisor over two
        # replicas (the CLI's own child argv); a seeded crash:fleet:replica
        # rule SIGKILLs one under load, then the autoscaler steps 1 → 3 → 1
        t_c = time.perf_counter()
        args = cli.build_parser().parse_args(
            ["deploy", "--engine-dir", eng, "--batching", "--device", device.type])
        chaos_log = open(os.path.join(tmp, "chaos-replicas.log"), "w")

        def spawn_replica(port):
            p = subprocess.Popen(cli._child_deploy_argv(args, port), cwd=ROOT,
                                 stdout=subprocess.DEVNULL, stderr=chaos_log,
                                 env=dict(os.environ, PYTHONPATH=ROOT))
            procs.append(p)
            return p

        ports = [free_port(), free_port()]
        router = Router([f"http://127.0.0.1:{p}" for p in ports], telemetry=False)
        routers.append(router)
        router.health_interval_ms, router.eject_after, router.readmit_after = 100.0, 2, 2
        router.slow_start_s = 0.5
        sup = FleetSupervisor(spawn_replica, ports, router=router, port_allocator=free_port)
        sup.restart_backoff_s = 0.2
        router.attach_fleet(sup)
        sup.start()
        rport = router.start("127.0.0.1", 0)
        wait_for(lambda: all(r["state"] == ADMITTED and r["instanceId"] is not None and r["warm"]
                             for r in router.stats()["replicas"]),
                 "the chaos fleet admitted", timeout=300)
        load = ClosedLoop(rport, users, seed + 3).start()
        load.wait_ok(200)
        spec, fseed = f"site={PREEMPT_SITE},kind=crash,times=1", seed + 5
        before = {r["url"]: r["pid"] for r in sup.status()["replicas"]}
        alive = sorted(before.values())
        want = alive[random.Random(f"{fseed}:0:0:victim").randrange(len(alive))]
        plan = faults.FaultPlan(faults.parse_spec(spec), seed=fseed)
        t_kill = time.perf_counter()
        faults.install(plan)
        wait_for(lambda: plan.stats()["rules"][0]["fired"] == 1, "the preemption firing", 10)
        faults.clear()
        victim = wait_for(lambda: next((u for u, pid in before.items() if any(
            r["url"] == u and r["pid"] != pid for r in sup.status()["replicas"])), None),
            "the preempted replica respawned", 30)
        require(before[victim] == want, f"killed {before[victim]}, the seeded plan names {want}")
        # the respawn: once the router has ejected it, it may be admitted
        # only while its /readyz answers 200 and warm
        seen_ejected, early, t_ready = False, [], None
        t_end = time.monotonic() + 300
        while time.monotonic() < t_end:
            st_ = next(r for r in router.stats()["replicas"] if r["url"] == victim)
            seen_ejected |= st_["state"] != ADMITTED
            try:
                with urllib.request.urlopen(victim + "/readyz", timeout=2) as r:
                    ready = r.status == 200 and json.loads(r.read())["fastpathWarm"]
            except OSError:
                ready = False
            if ready and t_ready is None:
                t_ready = time.perf_counter() - t_kill
            if seen_ejected and st_["state"] == ADMITTED:
                if not ready:
                    early.append(st_)
                break
            time.sleep(0.02)
        require(seen_ejected and not early and t_ready is not None,
                f"respawn admission: ejected {seen_ejected}, admitted cold {early}")
        load.wait_ok(load.ok + 200)
        kill = no_failures(load, "the preemption")
        out["preempt"] = step("preempt", spec=spec, seed=fseed, victim_pid=before[victim],
                              respawn_ready_s=t_ready, router_counters=router.counters.snapshot(),
                              load=kill)
        scaler = Autoscaler(router, sup)
        scaler.interval_ms = 250.0
        scaler.min_replicas, scaler.max_replicas = 1, 3
        scaler.up_threshold, scaler.down_threshold = 0.3, 0.05
        scaler.up_cooldown_s, scaler.down_cooldown_s, scaler.down_after = 2.0, 2.0, 3
        scaler.busy_enabled = False
        router.replica_max_inflight = 8  # 6 clients fill 37% of two replicas' slots
        router.attach_autoscaler(scaler)
        load = ClosedLoop(rport, users, seed + 4, clients=FLEET_SCALE_CLIENTS).start()
        load.wait_ok(100)
        t0 = time.perf_counter()
        scaler.start()
        wait_for(lambda: scaler.stats()["scaleUps"] >= 1 and router.available_count() >= 3,
                 "the autoscaler scaling up under the load step", timeout=300)
        up_s = time.perf_counter() - t0
        load.wait_ok(load.ok + 200)
        scaled = no_failures(load, "the autoscaler's load step")
        t0 = time.perf_counter()
        wait_for(lambda: scaler.stats()["scaleDowns"] >= 1 and len(sup.status()["replicas"]) < 3,
                 "the autoscaler scaling down after the load", timeout=120)
        out["autoscale"] = step("autoscale", up_s=up_s, down_s=time.perf_counter() - t0,
                                stats=scaler.stats(), load=scaled,
                                router_counters=router.counters.snapshot())
        scaler.stop()
        router.shutdown()
        out["seconds"]["fleet-chaos"] = time.perf_counter() - t_c
        step("fleet-chaos", seconds=out["seconds"]["fleet-chaos"])

        # (d) tenants-pipeline: one replica with two tenants, one with the
        # IVF model under a retrieval → ranking pipeline
        t_d = time.perf_counter()
        os.environ["PIO_IVF_NLIST"] = "256"
        ivf_model = als._declare_ivf_partition(als.ALSModel(
            user_factors=U, item_factors=V, user_map=model.user_map, item_map=model.item_map,
            config=model.config))
        del os.environ["PIO_IVF_NLIST"]
        require(ivf_model.ivf_index is not None and ivf_model.ivf_index.nlist == 256,
                "the IVF declaration")
        pipe_dir = os.path.join(tmp, "engine-pipeline")
        gen["ivf"] = publish(storage, engine, ivf_model, engine_id=ALS_FACTORY,
                             engine_variant="pipeline",
                             variant=write_engine_json(pipe_dir, "pipeline", {"rank": RANK}))
        pipeline = {"name": "ivf-als", "stages": [
            {"name": "retrieval", "kind": "retrieval", "budgetFraction": 0.4,
             "params": {"candidates": PIPE_CANDIDATES}},
            {"name": "ranking", "kind": "ranking", "budgetFraction": 0.5}]}
        tenants = [{"tenantId": "A", "accessKey": "key-A", "quotaQps": TEN_QUOTA_QPS},
                   {"tenantId": "B", "accessKey": "key-B"}]
        tport, pport = free_port(), free_port()
        t0 = time.perf_counter()
        tproc = spawn("tenants", ["deploy", "--engine-dir", eng, "--batching", "--device",
                                  device.type, "--ip", "127.0.0.1", "--port", str(tport)], {
            "PIO_TENANTS": json.dumps(tenants),
            "PIO_FAULT_SPEC": f"site=client:tenant:A,kind=error,after={TEN_FLOOD},times=5"})
        pproc = spawn("pipeline", ["deploy", "--engine-dir", pipe_dir, "--batching", "--device",
                                   device.type, "--ip", "127.0.0.1", "--port", str(pport)], {
            "PIO_PIPELINE": json.dumps(pipeline),
            "PIO_FAULT_SPEC": (f"site=server:pipeline:ranking,kind=latency,latency_ms=400,"
                               f"after={PIPE_QUERIES},times=3")})
        ready = {"tenants": wait_ready(tport, tproc, t0), "pipeline": wait_ready(pport, pproc, t0)}
        alone = ClosedLoop(tport, users, seed + 6, clients=4, total=TEN_B_REQUESTS,
                           extra={"accessKey": "key-B"}).start()
        alone_r = no_failures(alone, "tenant B alone")
        flood = ClosedLoop(tport, users, seed + 7, clients=16, total=TEN_FLOOD,
                           extra={"accessKey": "key-A"}).start()
        b_load = ClosedLoop(tport, users, seed + 8, clients=4, total=TEN_B_REQUESTS,
                            extra={"accessKey": "key-B"}).start()
        b_r = no_failures(b_load, "tenant B under A's flood")
        flood_r = flood.stop()
        shed = flood.failures
        require(flood_r["sent"] == TEN_FLOOD and shed
                and all(f.get("status") == 503 and f.get("retry_after") for f in shed),
                f"tenant A's flood: sent {flood_r['sent']}, {len(shed)} not 200, e.g. {shed[:3]}")
        reasons = sorted({m.group(1) for f in shed
                          if (m := re.search(r'"reason":"(\w+)"', f.get("body", "")))})
        injected = []
        for _ in range(5):
            status, body = http_json(f"http://127.0.0.1:{tport}/queries.json",
                                     {"user": users[0], "num": OPS_NUM, "accessKey": "key-A"})
            injected.append((status, body.get("injected")))
        status_a, body_a = http_json(f"http://127.0.0.1:{tport}/queries.json",
                                     {"user": users[0], "num": OPS_NUM, "accessKey": "key-A"})
        status_b, _ = http_json(f"http://127.0.0.1:{tport}/queries.json",
                                {"user": users[1], "num": OPS_NUM, "accessKey": "key-B"})
        ten = info(tport)["tenancy"]
        require(injected == [(503, True)] * 5 and status_a == 503
                and body_a.get("reason") == "breaker" and status_b == 200
                and ten["A"]["breaker"] == "open" and ten["B"]["breaker"] == "closed",
                f"client:tenant:A: {injected}, then A {status_a} {body_a}, B {status_b}, {ten}")
        out["tenants"] = step(
            "tenants", quota_qps=TEN_QUOTA_QPS, a_sent=flood_r["sent"], a_ok=flood_r["ok"],
            a_shed=len(shed), a_shed_reasons=reasons, b_alone=alone_r, b_flooded=b_r,
            breaker={"A": ten["A"]["breaker"], "B": ten["B"]["breaker"]},
            deploy_to_ready_s=ready["tenants"])

        index = ivf_model.ivf_index
        before = info(pport)
        picks = [(users[int(j)], int(rng.integers(1, K + 1)))
                 for j in rng.integers(0, len(users), PIPE_QUERIES)]
        bad = []
        for u, n in picks:
            status, a = http_json(f"http://127.0.0.1:{pport}/queries.json", {"user": u, "num": n})
            require(status == 200 and not a.get("degraded"), f"pipeline {u}: {status} {a}")
            q = U[model.user_map[u]]
            cand, _ = _ivf_candidates(index, q, PIPE_CANDIDATES)
            exact = V[cand].astype(np.float64) @ q.astype(np.float64)
            order = np.lexsort((cand, -exact))[:n]
            got_i = np.array([[model.item_map[x["item"]] for x in a["itemScores"]]])
            got_v = np.array([[x["score"] for x in a["itemScores"]]])
            bad += topk_mismatches(got_v, got_i, exact[order][None, :].astype(np.float32),
                                   cand[order][None, :], TOL)
        require(not bad, f"pipeline answers vs the exact top-k over the candidates: {bad[:3]}")
        after = info(pport)
        launches = after["scoreKernelLaunches"] - before["scoreKernelLaunches"]
        ranking = (after["pipeline"]["stages"]["ranking"]["runs"]
                   - before["pipeline"]["stages"]["ranking"]["runs"])
        require(launches == ranking == PIPE_QUERIES,
                f"kernel 1 launched {launches} times, ranking ran {ranking}, {PIPE_QUERIES} queries")
        degraded = []
        for u, n in picks[:3]:
            req = urllib.request.Request(
                f"http://127.0.0.1:{pport}/queries.json",
                data=json.dumps({"user": u, "num": n}).encode(), method="POST",
                headers={"Content-Type": "application/json", "X-Request-Deadline": "300"})
            with urllib.request.urlopen(req, timeout=30) as r:
                a = json.loads(r.read())
            cand, _ = _ivf_candidates(index, U[model.user_map[u]], PIPE_CANDIDATES)
            keep = set(cand.tolist())
            degraded.append(a.get("degraded") is True and a.get("pipelineStage") == "ranking"
                            and len(a["itemScores"]) == n
                            and all(model.item_map[x["item"]] in keep for x in a["itemScores"]))
        last = info(pport)
        require(all(degraded) and last["scoreKernelLaunches"] == after["scoreKernelLaunches"],
                f"ranking latency rule: degraded {degraded}, launches "
                f"{last['scoreKernelLaunches'] - after['scoreKernelLaunches']}")
        out["pipeline"] = step(
            "pipeline", nlist=index.nlist, candidates=PIPE_CANDIDATES, queries=PIPE_QUERIES,
            ranking_calls=ranking, kernel1_launches=launches, degraded=len(degraded),
            stages=last["pipeline"]["stages"], deploy_to_ready_s=ready["pipeline"])
        for port, proc in ((tport, tproc), (pport, pproc)):
            http_json(f"http://127.0.0.1:{port}/stop", {}, method="POST")
            proc.wait(timeout=60)
        out["seconds"]["tenants-pipeline"] = time.perf_counter() - t_d
        out["seconds"]["total"] = time.perf_counter() - t_phase
        step("tenants-pipeline", seconds=out["seconds"]["tenants-pipeline"])
        emit({"phase": "fleet", "seconds": out["seconds"], "ok": True})
        return out
    finally:
        faults.clear()
        for r in routers:
            r.stop()
        for p in procs:
            with contextlib.suppress(OSError):  # the group may be gone
                os.killpg(p.pid, signal.SIGKILL)
            if p.poll() is None:
                p.kill()
            p.wait()
        Storage.reset_instance()
        store.set_storage(None)
        sqlite.close_all_dbs()
        for k in [k for k in os.environ if k.startswith(("PIO_STORAGE_", "PIO_FLEET_"))
                  or k in knobs]:
            del os.environ[k]
        os.environ.update(saved)
        shutil.rmtree(tmp, ignore_errors=True)


SH_SHARDS = 4  # the plan's shards, on four placements of the one card
SH_HOST_GROUPS = 2  # the one-process pod plan's host rows
SH_TIMED = 50  # calls of each timed dispatch at B = 64
SH_CLI_EVENTS = 50_000  # the quickstart's bulk events for `pio train` under the plan
SH_CLI_USERS = 40  # users asked through the deployed server
SH_IVF_NLIST = 16  # the IVF index published under a plan (full probe: recall 1.0)
RING_SHAPE = (8, 4096, 64)  # B·H, T, D of ring_flash_attention
RING_WAYS = 4  # placements of the ring: blocks of 1,024
RING_PAIRS = RING_WAYS * (RING_WAYS + 1) // 2  # live (q, kv) block pairs, causal
RING_O_TOL = 2e-5  # rtol = atol, forward
RING_GRAD_RTOL, RING_GRAD_ATOL = 2e-4, 2e-5
RING_TIMED = 10
SP_STEPS = 20  # SASRec seq_parallel training steps, and the data-parallel run beside it


def same_topk(a, b) -> bool:
    """Bit-for-bit equality of two (indices, values) answers."""
    import numpy as np

    return bool(np.array_equal(a[0], b[0]) and np.asarray(a[1]).tobytes() == np.asarray(b[1]).tobytes())


def phase_sharded(model, seed, device, item_counts):
    """The sharded placement on one card: see the module docstring, phase 19."""
    import contextlib
    import io
    import pickle
    import shutil
    import tempfile

    import numpy as np
    import torch

    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import sqlite
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.ops import score_kernel
    from predictionio_tpu_torch.ops.quantize import quantize_factors
    from predictionio_tpu_torch.serving import sharding
    from predictionio_tpu_torch.serving.fastpath import BucketedScorer
    from predictionio_tpu_torch.tools import cli

    t_phase = time.perf_counter()
    U, V = model.user_factors, model.item_factors
    n_users, n_items = U.shape[0], V.shape[0]
    one = DeviceContext.create(device=device)
    mesh = DeviceContext.create(devices=[device] * SH_SHARDS)
    out = {"phase": "sharded"}

    def step(name, **row):
        row["t"] = time.perf_counter() - t_phase
        emit({"phase": "sharded", "step": name, **row})
        return row

    # 1. the plans: popularity-balanced by the draw's item counts, flat and
    # in two host rows
    t0 = time.perf_counter()
    plans = {"flat": sharding.build_plan(n_items, SH_SHARDS, weights=item_counts),
             "pod": sharding.build_plan(n_items, SH_SHARDS, weights=item_counts,
                                        host_groups=SH_HOST_GROUPS)}
    out["plans"] = step("plans", build_s=time.perf_counter() - t0,
                        **{k: p.describe() for k, p in plans.items()})

    # 2. every rung × dtype, flat and pod: the replicated exact kernel path's
    # answers first, then the sharded scorers' inside the counted window
    scorers, want, users_of = {}, {}, {}
    rng = np.random.default_rng(seed + 91)
    for dtype in DTYPES:
        if dtype == "f32":
            args, kw = (U, V), {}
        else:
            Uq, us = quantize_factors(U, dtype)
            Vq, vs = quantize_factors(V, dtype)
            args, kw = (Uq, Vq), {"factor_dtype": dtype, "user_scale": us, "item_scale": vs}
        repl = BucketedScorer(one, *args, max_k=K, **kw)
        for layout, plan in plans.items():
            fp = BucketedScorer(mesh, *args, max_k=K, plan=plan, **kw)
            require(fp.sharding == "sharded" and fp._pod == (layout == "pod"),
                    f"{layout} {dtype}: {fp.sharding}, pod {fp._pod}")
            scorers[(layout, dtype)] = fp
        scorers[("replicated", dtype)] = repl
        for b in RUNGS:
            users_of[(dtype, b)] = rng.integers(0, n_users, b).astype(np.int32)
            want[(dtype, b)] = repl.score_topk(users_of[(dtype, b)], K)
    score_kernel.launches.reset()
    dispatches = 0
    for (layout, dtype), fp in scorers.items():
        if layout == "replicated":
            continue
        for b in RUNGS:
            got = fp.score_topk(users_of[(dtype, b)], K)
            dispatches += 1
            require(same_topk(got, want[(dtype, b)]),
                    f"{layout} {dtype} B = {b}: sharded answers differ from replicated")
    launches = score_kernel.launches.count
    require(launches == SH_SHARDS * dispatches,
            f"kernel 1 launched {launches} times for {dispatches} dispatches of {SH_SHARDS} shards")
    stats = scorers[("flat", "f32")].stats()["sharding"]
    pod_stats = scorers[("pod", "f32")].stats()["pod"]
    require(pod_stats["dispatches"] == len(RUNGS), f"pod dispatches {pod_stats}")
    out["rungs"] = step("rungs", dispatches=dispatches, launches=launches,
                        result_wins=stats["result_wins"], merge_bytes=stats["merge_bytes"],
                        resident_bytes=stats["resident_bytes"],
                        pod_cross_host_merge_bytes=pod_stats["cross_host_merge_bytes"])

    # 3. an exclusion mask spanning the shards, and one delta on the layout
    excl = rng.choice(n_items, n_items // 3, replace=False)
    for layout in plans:
        got = scorers[(layout, "f32")].score_topk_filtered(7, K, excl, None)
        require(same_topk(got, scorers[("replicated", "f32")].score_topk_filtered(7, K, excl, None)),
                f"{layout}: a filtered call differs from replicated")
    d_users = rng.choice(n_users, 2000, replace=False)
    d_items = rng.choice(n_items, 600, replace=False)
    u_rows = (rng.standard_normal((len(d_users), U.shape[1])) * 0.5).astype(np.float32)
    i_rows = (rng.standard_normal((len(d_items), V.shape[1])) * 0.5).astype(np.float32)
    applied = {}
    for key in (("flat", "f32"), ("replicated", "f32"), ("flat", "int8"), ("replicated", "int8")):
        applied[key] = scorers[key].apply_delta_rows(d_users, u_rows, d_items, i_rows)
    for dtype in ("f32", "int8"):
        for b in (1, 64):
            who = np.concatenate([d_users[:b // 2 + 1], rng.integers(0, n_users, b)])[:b]
            got = scorers[("flat", dtype)].score_topk(who.astype(np.int32), K)
            require(same_topk(got, scorers[("replicated", dtype)].score_topk(who.astype(np.int32), K)),
                    f"{dtype} B = {b}: the patched sharded rows differ from replicated")
    out["delta"] = step("delta", users=len(d_users), items=len(d_items),
                        device_ms={f"{k[0]}-{k[1]}": r["device_ms"] for k, r in applied.items()})

    # 4. times at B = 64, f32: the dispatch (four launches and the merge)
    # against the replicated exact kernel; kernel 1's device µs a shard
    u64 = torch.from_numpy(users_of[("f32", 64)]).to(device)
    flat, repl = scorers[("flat", "f32")], scorers[("replicated", "f32")]
    dispatch_ms = cuda_ms(lambda: flat._score(u64, 64), SH_TIMED)
    pod_ms = cuda_ms(lambda: scorers[("pod", "f32")]._score(u64, 64), SH_TIMED)
    exact_ms = cuda_ms(lambda: repl._score(u64, 64), SH_TIMED)
    users64 = users_of[("f32", 64)]
    flat.score_topk(users64, K)
    t0 = time.perf_counter()
    for _ in range(SH_TIMED):
        flat.score_topk(users64, K)
    host_ms = (time.perf_counter() - t0) / SH_TIMED * 1e3
    t0 = time.perf_counter()
    for _ in range(SH_TIMED):
        repl.score_topk(users64, K)
    repl_host_ms = (time.perf_counter() - t0) / SH_TIMED * 1e3
    dev = device_us(lambda: flat._score(u64, 64), 20)
    dev_repl = device_us(lambda: repl._score(u64, 64), 20)
    out["times"] = step(
        "times-b64", dispatch_ms=dispatch_ms, pod_dispatch_ms=pod_ms, exact_ms=exact_ms,
        dispatch_host_ms=host_ms, exact_host_ms=repl_host_ms,
        kernel_us_per_shard=dev.get("score_select", 0.0) / SH_SHARDS,
        exact_kernel_us=dev_repl.get("score_select", 0.0), device_us=dev,
        cap_pad=flat._n_items_pad, local_k=flat._local_k)

    # 5. the CLI: `pio train` under PIO_SHARD_COUNT in checkpoint mode, `pio
    # shards show|rebuild`, `pio deploy --batching` on the one-card default
    # mesh (replicated, no fingerprint), POST /reload; an IVF checkpoint
    # under a plan on the four-placement mesh serves exact
    tmp = tempfile.mkdtemp(prefix="pio-sharded-")
    knobs = ("PIO_FS_BASEDIR", "PIO_SHARD_COUNT", "PIO_SHARD_HBM_BUDGET", "PIO_SHARD_STRATEGY",
             "PIO_POD_HOST_GROUPS", "PIO_SERVING_SHARDING", "PIO_IVF_NLIST", "PIO_IVF_NPROBE",
             "PIO_IVF_MIN_RECALL", "PIO_RETRIEVAL", "PIO_QUANT_DTYPE", "PIO_ALS_SOLVER",
             "PIO_ALS_COMPUTE_DTYPE")
    saved = {k: v for k, v in os.environ.items() if k.startswith("PIO_STORAGE_") or k in knobs}
    for k in saved:
        del os.environ[k]
    os.environ["PIO_FS_BASEDIR"] = os.path.join(tmp, "base")
    Storage.reset_instance()
    store.set_storage(None)
    servers = []

    def pio(*argv):
        o, e = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
            rc = cli.main(list(argv))
        require(rc == 0, f"pio {' '.join(argv)} exited {rc}: {e.getvalue()[-500:]}")
        return o.getvalue()

    try:
        pio("app", "new", "ShardApp")
        storage = Storage.instance()
        app_id = storage.get_meta_data_apps().get_by_name("ShardApp").id
        inter, _ = ml1m_interactions(seed)
        pick = np.sort(np.random.default_rng(seed + 93).choice(len(inter.user), SH_CLI_EVENTS,
                                                               replace=False))
        stars = np.random.default_rng(seed + 94).integers(1, 6, SH_CLI_EVENTS)
        storage.get_l_events().insert_batch([
            Event(event="rate", entity_type="user", entity_id=f"u{inter.user[k]}",
                  target_entity_type="item", target_entity_id=f"si{inter.item[k]}",
                  properties={"rating": int(stars[j])}, event_time=float(inter.t[k]),
                  creation_time=float(inter.t[k]))
            for j, k in enumerate(pick)], app_id)
        del inter
        eng = os.path.join(tmp, "engine")
        pio("template", "get", "recommendation", "--directory", eng)
        fill_engine_json(os.path.join(eng, "engine.json"), "ShardApp", [
            {"name": "als", "params": {"rank": RANK, "numIterations": 10,
                                       "persistMode": "checkpoint"}}])
        pio("build", "--engine-dir", eng)
        os.environ["PIO_SHARD_COUNT"] = str(SH_SHARDS)
        t0 = time.perf_counter()
        trained = pio("train", "--engine-dir", eng, "--device", device.type)
        train_s = time.perf_counter() - t0
        del os.environ["PIO_SHARD_COUNT"]
        iid = trained.split("Engine instance ID: ")[1].split()[0]
        shown = json.loads(pio("shards", "show", "--instance", iid))
        require(shown[0]["n_shards"] == SH_SHARDS and shown[0]["strategy"] == "popularity",
                f"pio shards show: {shown}")
        fp_trained = shown[0]["fingerprint"]
        loaded = als.CheckpointedALSModel.load(iid, None, one)
        require(loaded.sharding_plan.fingerprint == fp_trained, "the loaded plan is the sealed one")

        qs = CliServer(tmp, "deploy", "deploy", "--engine-dir", eng, "--batching",
                       "--device", device.type)
        servers.append(qs)
        ready_s = qs.wait_ready()
        _, ready = http_json(f"{qs.base}/readyz")
        require(ready.get("servingBackend") == "replicated" and "shardingFingerprint" not in ready,
                f"a one-card deploy of a plan: {ready}")
        names = [loaded.user_map.inverse[j] for j in range(0, len(loaded.user_map),
                                                           len(loaded.user_map) // SH_CLI_USERS)]

        def answers():
            got = []
            for u in names[:SH_CLI_USERS]:
                status, a = http_json(f"{qs.base}/queries.json", {"user": u, "num": 20})
                require(status == 200, f"query {u}: {status} {a}")
                got.append([(x["item"], x["score"]) for x in a["itemScores"]])
            return got

        served = answers()
        # an unsharded deploy's answers: the same factors with no plan
        loaded.sharding_plan = None
        unsharded = als.ALSScorer(one, loaded).enable_fastpath()
        inv = loaded.item_map.inverse
        for u, got in zip(names, served):
            idx, vals = unsharded.score_topk(np.array([loaded.user_map[u]], np.int32), 20)
            ref = [(inv[int(i)], float(v)) for i, v in zip(idx[0], vals[0])]
            require(got == ref, f"{u}: deployed {got[:3]} vs unsharded {ref[:3]}")
        rebuilt = pio("shards", "rebuild", "--instance", iid, "--shards", "2")
        require("POST /reload" in rebuilt, rebuilt)
        shown2 = json.loads(pio("shards", "show", "--instance", iid))
        require(shown2[0]["n_shards"] == 2 and shown2[0]["fingerprint"] != fp_trained,
                f"after the rebuild: {shown2}")
        status, body = http_json(f"{qs.base}/reload", {}, method="POST")
        require(status == 200 and body.get("engineInstanceId") == iid, f"reload {status} {body}")
        _, ready2 = http_json(f"{qs.base}/readyz")
        require(ready2.get("servingBackend") == "replicated" and "shardingFingerprint" not in ready2,
                f"after the reload: {ready2}")
        require(answers() == served, "answers changed across the reload")
        status, _ = http_json(f"{qs.base}/stop", {}, method="POST")
        qs.wait_exit()
        # the same instance on the four placements: sharded under the rebuilt plan
        on_mesh = als.CheckpointedALSModel.load(iid, None, mesh)
        fp_mesh = als.ALSScorer(mesh, on_mesh).enable_fastpath()
        require(fp_mesh.sharding == "sharded"
                and fp_mesh.stats()["sharding"]["plan"]["fingerprint"] == shown2[0]["fingerprint"],
                "the rebuilt plan serves sharded on the mesh")
        users_cli = np.array([loaded.user_map[u] for u in names[:SH_CLI_USERS]], np.int32)
        require(same_topk(fp_mesh.score_topk(users_cli, 20), unsharded.score_topk(users_cli, 20)),
                "the CLI instance sharded on the mesh differs from replicated")
        out["cli"] = step("cli", train_s=train_s, events=SH_CLI_EVENTS, ready_s=ready_s,
                          fingerprint_trained=fp_trained,
                          fingerprint_rebuilt=shown2[0]["fingerprint"],
                          ready=ready, ready_after_reload=ready2, answers_checked=len(served))

        # 6. an IVF checkpoint under a plan: the mesh serves it exact sharded
        os.environ.update(PIO_IVF_NLIST=str(SH_IVF_NLIST), PIO_IVF_NPROBE=str(SH_IVF_NLIST))
        ck = als.CheckpointedALSModel(U, V, model.user_map, model.item_map, model.config,
                                      sharding_plan=plans["flat"])
        t0 = time.perf_counter()
        ck.save("sharded-ivf", None)
        publish_s = time.perf_counter() - t0
        for k in ("PIO_IVF_NLIST", "PIO_IVF_NPROBE"):
            del os.environ[k]
        with open(os.path.join(als.CheckpointedALSModel._dir("sharded-ivf"), "maps.pkl"), "rb") as f:
            meta = pickle.load(f)
        back = als.CheckpointedALSModel.load("sharded-ivf", None, mesh)
        require(back.ivf_index is not None and back.sharding_plan is not None,
                f"IVF and plan sealed: {meta['ivf']} {meta['sharding']}")
        fp_ivf = als.ALSScorer(mesh, back).enable_fastpath()
        require((fp_ivf.sharding, fp_ivf.retrieval) == ("sharded", "exact"),
                f"an IVF index under a plan: {fp_ivf.sharding}, {fp_ivf.retrieval}")
        fp_one = als.ALSScorer(one, als.CheckpointedALSModel.load("sharded-ivf", None, one))
        fp_one = fp_one.enable_fastpath()
        require((fp_one.sharding, fp_one.retrieval) == ("replicated", "ivf"), "one card: IVF")
        for b in (1, 64):
            require(same_topk(fp_ivf.score_topk(users_of[("f32", b)], K), want[("f32", b)]),
                    f"IVF under a plan, B = {b}: not the exact answers")
        out["ivf"] = step("ivf-under-plan", nlist=SH_IVF_NLIST, publish_s=publish_s,
                          record=meta["ivf"], one_card=fp_one.retrieval)
    finally:
        for s in servers:
            s.kill()
        Storage.reset_instance()
        store.set_storage(None)
        sqlite.close_all_dbs()
        for k in [k for k in os.environ if k.startswith("PIO_STORAGE_") or k in knobs]:
            del os.environ[k]
        os.environ.update(saved)
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = launches
    out["dispatches"] = dispatches
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "sharded", "seconds": out["seconds"], "launches": launches,
          "dispatches": dispatches, "ok": True})
    return out


def phase_ring(seed, device):
    """Sequence parallelism on one card: see the module docstring, phase 20."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.models import sequential as seq
    from predictionio_tpu_torch.ops import flash_attention as fa
    from predictionio_tpu_torch.parallel import ring, ulysses

    t_phase = time.perf_counter()
    out = {"phase": "ring"}
    mesh = DeviceContext.create(devices=[device] * RING_WAYS)

    def step(name, **row):
        row["t"] = time.perf_counter() - t_phase
        emit({"phase": "ring", "step": name, **row})
        return row

    def gap(a, b):
        return float((a.double() - b.double()).abs().max())

    g = torch.Generator(device="cpu").manual_seed(seed + 101)
    q, k, v, w = (torch.randn(*RING_SHAPE, generator=g).to(device) for _ in range(4))
    scale = 1.0 / RING_SHAPE[-1] ** 0.5

    # 1. the main path: one forward and backward of ring_flash_attention,
    # counts set to 0 just before and read just after
    qs, ks, vs = (x.clone().requires_grad_(True) for x in (q, k, v))
    reset_flash_counts()
    o_ring = ring.ring_flash_attention(mesh, qs, ks, vs, causal=True)
    (o_ring * w).sum().backward()
    torch.cuda.synchronize(device)
    launches = flash_counts()
    require(launches == {"fwd": RING_PAIRS, "bwd_dq": RING_PAIRS, "bwd_dkv": RING_PAIRS},
            f"ring launches {launches}, want {RING_PAIRS} each")
    # o and lse of the blocks against the whole sequence
    devs = ring.axis_devices(mesh, "data")
    blocks = [ring._blocks(x, devs) for x in (q, k, v)]
    with torch.no_grad():
        o_b, lse_b = ring._ring_flash_fwd_impl(*blocks, True, scale, devs)
        o_whole, lse_whole = fa.flash_block_fwd(q, k, v, True, scale)
        o_plain, lse_plain = fa.flash_attention_reference(q, k, v, True, scale)
    o_cat, lse_cat = torch.cat(o_b, -2), torch.cat(lse_b, -1)
    for name, got, ref in (("o vs kernel", o_cat, o_whole), ("o vs plain", o_cat, o_plain),
                           ("lse vs kernel", lse_cat, lse_whole), ("lse vs plain", lse_cat, lse_plain)):
        torch.testing.assert_close(got, ref, rtol=RING_O_TOL, atol=RING_O_TOL, msg=name)
    torch.testing.assert_close(o_ring.detach(), o_whole, rtol=RING_O_TOL, atol=RING_O_TOL)
    qw, kw_, vw = (x.clone().requires_grad_(True) for x in (q, k, v))
    (fa.flash_attention(qw, kw_, vw, causal=True) * w).sum().backward()
    do = w.contiguous()
    with torch.no_grad():
        plain_grads = fa.flash_attention_bwd_reference(q, k, v, o_plain, lse_plain, do, True, scale)
    errs = {}
    for name, got, ref_k, ref_p in zip(("dq", "dk", "dv"), (qs.grad, ks.grad, vs.grad),
                                       (qw.grad, kw_.grad, vw.grad), plain_grads):
        torch.testing.assert_close(got, ref_k, rtol=RING_GRAD_RTOL, atol=RING_GRAD_ATOL, msg=name)
        torch.testing.assert_close(got, ref_p, rtol=RING_GRAD_RTOL, atol=RING_GRAD_ATOL, msg=name)
        errs[name] = {"vs_kernel": gap(got, ref_k), "vs_plain": gap(got, ref_p)}
    errs["o"] = {"vs_kernel": gap(o_cat, o_whole), "vs_plain": gap(o_cat, o_plain)}
    errs["lse"] = {"vs_kernel": gap(lse_cat, lse_whole), "vs_plain": gap(lse_cat, lse_plain)}

    # times: the ring's forward, and forward + backward, against the whole
    # sequence's kernels
    def ring_fb():
        a, b, c = (x.detach().requires_grad_(True) for x in (q, k, v))
        (ring.ring_flash_attention(mesh, a, b, c, causal=True) * w).sum().backward()

    def whole_fb():
        a, b, c = (x.detach().requires_grad_(True) for x in (q, k, v))
        (fa.flash_attention(a, b, c, causal=True) * w).sum().backward()

    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: ring.ring_flash_attention(mesh, q, k, v, causal=True), RING_TIMED)
        whole_fwd_ms = cuda_ms(lambda: fa.flash_block_fwd(q, k, v, True, scale), RING_TIMED)
    fb_ms = cuda_ms(ring_fb, RING_TIMED)
    whole_fb_ms = cuda_ms(whole_fb, RING_TIMED)
    dev = device_us(ring_fb, 5)
    out["ring"] = step("ring-flash", shape=list(RING_SHAPE), ways=RING_WAYS, launches=launches,
                       errors=errs, fwd_ms=fwd_ms, whole_fwd_ms=whole_fwd_ms, fwd_bwd_ms=fb_ms,
                       whole_fwd_bwd_ms=whole_fb_ms, device_us=dev)

    # 2. Ulysses: H 8 over 4 placements, the flash local attention
    qh, kh, vh, wh = (x.reshape(RING_SHAPE) for x in (q, k, v, w))  # (H, T, D)
    a, b, c = (x.clone().requires_grad_(True) for x in (qh, kh, vh))
    before = flash_counts()
    o_u = ulysses.ulysses_attention(mesh, a, b, c, causal=True, use_flash=True)
    (o_u * wh).sum().backward()
    torch.cuda.synchronize(device)
    after = flash_counts()
    u_launches = {key: after[key] - before[key] for key in after}
    require(u_launches == {"fwd": RING_WAYS, "bwd_dq": RING_WAYS, "bwd_dkv": RING_WAYS},
            f"ulysses launches {u_launches}")
    torch.testing.assert_close(o_u.detach(), o_whole, rtol=RING_O_TOL, atol=RING_O_TOL)
    torch.testing.assert_close(o_u.detach(), o_plain, rtol=RING_O_TOL, atol=RING_O_TOL)
    for got, ref_k, ref_p in zip((a.grad, b.grad, c.grad), (qw.grad, kw_.grad, vw.grad), plain_grads):
        torch.testing.assert_close(got, ref_k, rtol=RING_GRAD_RTOL, atol=RING_GRAD_ATOL)
        torch.testing.assert_close(got, ref_p, rtol=RING_GRAD_RTOL, atol=RING_GRAD_ATOL)
    with torch.no_grad():
        u_ms = cuda_ms(lambda: ulysses.ulysses_attention(mesh, qh, kh, vh, causal=True,
                                                         use_flash=True), RING_TIMED)
    out["ulysses"] = step("ulysses", launches=u_launches, fwd_ms=u_ms,
                          o_vs_kernel=gap(o_u.detach(), o_whole))

    # 3. SASRec seq_parallel training at ML-1M widths on {data 1, model 2}
    # of the card: SP_STEPS steps from the params data-parallel training
    # starts from, each step's loss held against the data-parallel loss of
    # the same params and batch; then both free-running, timed
    inter, _ = ml1m_interactions(seed)
    cfg = seq.SASRecConfig(d_model=SAS_D, n_layers=SAS_LAYERS, n_heads=SAS_HEADS,
                           max_len=SAS_MAX_LEN, epochs=SP_STEPS, batch_size=SAS_BATCH, lr=SAS_LR,
                           seed=seed)
    sp_cfg = seq.SASRecConfig(**{**cfg.__dict__, "seq_parallel": True})
    sp_mesh = DeviceContext.create(axes={"data": 1, "model": 2}, devices=[device] * 2)
    start = seq.init_params(seed, cfg, inter.n_items)
    seqs = seq.training_sequences(inter, cfg)
    rows = torch.from_numpy(seqs.astype(np.int64)).to(device)
    net = seq.SASRecNet(start, cfg, device, trainable=True)
    opt = seq.adam(net, cfg)
    sp_loss = seq._build_sp_loss(sp_mesh, 2, cfg)
    rng = np.random.default_rng(cfg.seed)
    batch = min(cfg.batch_size, len(seqs))
    step_gaps = []
    for _ in range(SP_STEPS):
        s = rows[torch.from_numpy(rng.integers(0, len(seqs), batch)).to(device)]
        with torch.no_grad():
            dp = float(seq._loss_fn(net.tree(), s, cfg))
        sp = float(seq.train_step(net, opt, s, cfg, sp_loss))
        step_gaps.append(abs(sp - dp) / abs(dp))
    require(max(step_gaps) <= 1e-5, f"SP loss vs DP loss step by step: {max(step_gaps)}")
    runs = {}
    for name, c, ctx in (("sp", sp_cfg, sp_mesh), ("dp", cfg, DeviceContext.create(device=device))):
        reset_flash_counts()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        m = seq.train_sasrec(ctx, inter, c, init_params=start)
        torch.cuda.synchronize(device)
        runs[name] = {"s_per_step": (time.perf_counter() - t0) / SP_STEPS, "losses": m.losses,
                      "flash_launches": flash_counts()}
    free = float(np.max(np.abs(runs["sp"]["losses"] - runs["dp"]["losses"])
                        / np.abs(runs["dp"]["losses"])))
    require(np.isfinite(runs["sp"]["losses"]).all() and runs["sp"]["losses"][-1] < runs["sp"]["losses"][0],
            f"SP training did not learn: {runs['sp']['losses']}")
    out["sasrec_sp"] = step(
        "sasrec-sp", steps=SP_STEPS, step_by_step_max_rel=max(step_gaps), free_run_max_rel=free,
        sp_s_per_step=runs["sp"]["s_per_step"], dp_s_per_step=runs["dp"]["s_per_step"],
        sp_losses=[float(x) for x in runs["sp"]["losses"]],
        dp_flash_launches=runs["dp"]["flash_launches"],
        sp_flash_launches=runs["sp"]["flash_launches"])
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "ring", "seconds": out["seconds"], "launches": launches, "ok": True})
    return out


# -- many processes: gloo ranks time-slicing the one card (phases 21-24) --------

DIST_N = 2  # processes of every launch
DIST_LOCAL = 2  # placements of the card each process holds: 2 × 2 = 4 shards
DIST_BLOCK = (4096, 64)  # float32 rows × columns of each collective's block
DIST_CALLS = 20  # timed calls of each collective
DIST_ITERS = 5  # ALS iterations of the ML-25M draw over the 2 × 2 placements
DIST_TRAIN_TOL = 1e-3  # the 1-placement run against the 2 × 2 run, rtol = atol
DIST_CLI_QUERIES = 64  # /queries.json to the deployed launch-trained instance
# the launch's factors against one process's training of the same events
# from the same start, rtol = atol: the float32 trainings of these events
# sit ~1e-2 from a float64 one (43% of the users have fewer ratings than
# the rank), so the witness below also holds the gap to that floor
DIST_CLI_TOL = 1e-2  # and the launch no more than twice that run's distance from float64
SAS_DP_RTOL = 1e-5  # the launch's SASRec losses against one process's steps


def dist_blocks(device, seed, shape):
    """The collectives' four global blocks, the same in every process."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 181)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
            for _ in range(DIST_N * DIST_LOCAL)]


def dist_collectives(ctx, blocks):
    """The four collectives of ``parallel/mesh.py`` on this process's blocks
    (all of them on a one-process mesh), as stacked tensors."""
    import torch

    from predictionio_tpu_torch.parallel import mesh

    lo, hi = ctx.local_range
    local, devs = blocks[lo:hi], ctx.local_devices
    return {
        "all_gather": lambda: mesh.all_gather(local, ctx.device, ctx=ctx),
        "ppermute": lambda: torch.stack(mesh.ppermute(local, devs, 1, ctx=ctx)),
        "all_to_all": lambda: torch.stack(mesh.all_to_all(local, 0, 1, devs, ctx=ctx)),
        "psum": lambda: torch.stack(mesh.psum(local, devs, ctx=ctx)),
    }


def sharded_from_draw(inter, pid, n, storage, key):
    """This process's 1/n of an in-memory draw as the sharded read gives
    it (``parallel/ingest.py``): its users' rows and its items' rows, the
    (entity → count) tables exchanged through the model-data repository
    and the rows translated into the global ids. The draw stands in for the
    store: 25,000,095 sqlite rows would take tens of minutes to read."""
    import numpy as np

    from predictionio_tpu_torch.data.batch import Interactions
    from predictionio_tpu_torch.data.bimap import BiMap
    from predictionio_tpu_torch.data.storage.base import PEvents
    from predictionio_tpu_torch.parallel import ingest

    uids = np.array(list(inter.user_map.keys()), dtype=object)
    iids = np.array(list(inter.item_map.keys()), dtype=object)
    u_own = np.fromiter((PEvents.shard_hash(s) % n for s in uids), np.int64, len(uids))
    i_own = np.fromiter((PEvents.shard_hash(s) % n for s in iids), np.int64, len(iids))

    def local(rows):
        uu, u_code = np.unique(inter.user[rows], return_inverse=True)
        ii, i_code = np.unique(inter.item[rows], return_inverse=True)
        return Interactions(
            user=u_code.astype(np.int32), item=i_code.astype(np.int32),
            rating=inter.rating[rows], t=inter.t[rows],
            user_map=BiMap(dict(zip(uids[uu].tolist(), range(len(uu))))),
            item_map=BiMap(dict(zip(iids[ii].tolist(), range(len(ii))))))

    upass = local(np.flatnonzero(u_own[inter.user] == pid))
    ipass = local(np.flatnonzero(i_own[inter.item] == pid))
    user_map, user_counts, _ = ingest.exchange_entity_tables(
        storage, key + "_user", ingest._count_table(upass.user, upass.user_map), pid, n)
    item_map, item_counts, _ = ingest.exchange_entity_tables(
        storage, key + "_item", ingest._count_table(ipass.item, ipass.item_map), pid, n)
    return ingest.ShardedInteractions(
        user_rows=ingest._translate(upass, user_map, item_map),
        item_rows=ingest._translate(ipass, user_map, item_map),
        user_map=user_map, item_map=item_map, user_counts=user_counts,
        item_counts=item_counts, process_index=pid, num_processes=n,
        cleanup=lambda: ingest.cleanup_exchange_keys(storage, key, n))


def dist_storage_env(tmp, name):
    src = "D" + name.upper()
    env = {f"PIO_STORAGE_SOURCES_{src}_TYPE": "sqlite",
           f"PIO_STORAGE_SOURCES_{src}_PATH": os.path.join(tmp, f"{name}.sqlite")}
    for r in ("METADATA", "EVENTDATA", "MODELDATA"):
        env[f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE"] = src
    return env


def dist_worker(tmp) -> int:
    """One rank of the in-process launch of phases 21, 22 and 24 (spawned
    by :func:`phase_dist` as ``chip_smoke.py --dist-worker DIR``): the
    collectives, the ML-25M training and the pod serve, each in lockstep with
    the other rank, on ``DIST_LOCAL`` placements of ``cuda:0``."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.core import checkpoint
    from predictionio_tpu_torch.data.batch import interactions_from_arrays
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.ops import _build, score_kernel, train_kernel
    from predictionio_tpu_torch.ops.quantize import quantize_factors
    from predictionio_tpu_torch.parallel import distributed, ingest
    from predictionio_tpu_torch.serving import sharding
    from predictionio_tpu_torch.serving.fastpath import BucketedScorer
    from predictionio_tpu_torch.serving.query_server import QueryServer
    from predictionio_tpu_torch.templates.recommendation import RecommendationEngine

    with open(os.path.join(tmp, "dist_args.json")) as f:
        args = json.load(f)
    t0 = time.perf_counter()
    require(distributed.initialize(), "joined the rendezvous")
    pid = distributed.process_index()
    out = {"pid": pid, "join_s": time.perf_counter() - t0}
    device = torch.device(args["device"])
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    torch.zeros(1, device=device)  # the card, after the rendezvous
    t0 = time.perf_counter()
    if on_card:
        _build.build_all()
    out["build_s"] = time.perf_counter() - t0
    ctx = DeviceContext.create(devices=[device] * DIST_LOCAL)
    require(ctx.spans_processes and ctx.n_devices == DIST_N * DIST_LOCAL, f"mesh {ctx.devices}")

    # 21. the collectives, bit for bit against the one-process mesh (main)
    fns = dist_collectives(ctx, dist_blocks(device, args["seed"], args["block"]))
    np.savez(os.path.join(tmp, f"coll{pid}.npz"), **{k: fn().cpu().numpy() for k, fn in fns.items()})
    coll = {}
    for name, fn in fns.items():
        distributed.reset_stats()
        sync()
        t0 = time.perf_counter()
        for _ in range(DIST_CALLS):
            fn()
        sync()
        coll[name] = {"ms": (time.perf_counter() - t0) * 1e3 / DIST_CALLS,
                      "staged_bytes": distributed.STATS["staged_bytes"] / DIST_CALLS,
                      "gloo_ms": distributed.STATS["seconds"] * 1e3 / DIST_CALLS}
    out["collectives"] = coll

    # 22. the ML-25M draw's training over 2 × 2 placements (the draw as the
    # main process made it, loaded rather than drawn again)
    t0 = time.perf_counter()
    z = np.load(os.path.join(tmp, "draw.npz"))
    n_users, n_items = args["draw"][:2]
    inter = interactions_from_arrays(z["user"], z["item"], z["rating"], np.zeros(len(z["user"])),
                                     (f"u{i}" for i in range(n_users)),
                                     (f"i{j}" for j in range(n_items)))
    del z
    draw_s = time.perf_counter() - t0
    storage = Storage(env=dist_storage_env(tmp, "rendezvous"))
    t0 = time.perf_counter()
    sh = sharded_from_draw(inter, pid, DIST_N, storage, args["run_key"])
    exchange_s = time.perf_counter() - t0
    del inter
    # through the trainer's entry point; its blocks, its start and its
    # iterations are timed and kept by wrappers around the functions it
    # calls, which run unchanged
    seen = {}

    def timed(name, fn, align=False):
        def call(*a, **kw):
            if align:  # both ranks start the clock together, past their host stages
                distributed.barrier()
            sync()
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            sync()
            seen[name] = (time.perf_counter() - t0, a, r)
            return r
        return call

    ckpt_dir = os.path.join(tmp, "ckpt")
    cfg = als.ALSConfig(rank=RANK, iterations=DIST_ITERS, compute_dtype="f32", solver="dense",
                        checkpoint_dir=ckpt_dir, checkpoint_interval=DIST_ITERS)
    blob = f"{ingest._BLOB_PREFIX}{args['run_key']}_user_m{pid}"
    require(storage.get_model_data_models().get(blob) is not None, f"p{pid}: rendezvous blob {blob}")
    writes = []
    mgr = checkpoint.CheckpointManager
    orig = (als._sharded_blocks_for_host, als._run_shards, mgr.save, mgr._write)
    als._sharded_blocks_for_host = timed("bucketing", orig[0])
    als._run_shards = timed("iterations", orig[1], align=True)
    mgr.save = timed("checkpoint", orig[2])
    mgr._write = lambda self, step, tree: (writes.append(step), orig[3](self, step, tree))
    distributed.barrier()
    train_kernel.launches.reset()
    distributed.reset_stats()
    try:
        t0 = time.perf_counter()
        m = als.train_als(ctx, sh, cfg)
        train_als_s = time.perf_counter() - t0
    finally:
        als._sharded_blocks_for_host, als._run_shards, mgr.save, mgr._write = orig
    launches = train_kernel.launches.count
    gathers = dict(distributed.STATS)
    bucketing_s, _, (ub, ib, ug, ig, my) = seen["bucketing"]
    # the iterations' seconds without the one checkpoint save (the
    # coordinator's write and the barrier after it)
    checkpoint_s = seen["checkpoint"][0]
    train_s, run_args, (U_all, V_all) = seen["iterations"]
    train_s -= checkpoint_s
    U0, V0 = run_args[3], run_args[4]
    require(tuple(my) == ctx.local_range, f"shards {my} vs placements {ctx.local_range}")
    want = (len(ub.widths) + len(ib.widths)) * DIST_LOCAL * DIST_ITERS
    # (the CPU's plain versions count no launch)
    require(launches == want or not on_card, f"p{pid}: kernel 2 launched {launches} times, want buckets "
            f"({len(ub.widths)} + {len(ib.widths)}) × {DIST_LOCAL} local shards × {DIST_ITERS}")
    require(m.user_factors.tobytes() == U_all[ug[2][:sh.n_users]].tobytes(), "the entry's factors")
    # the coordinator alone wrote the last step's checkpoint and, after the
    # last collective, removed the rendezvous blobs
    require(writes == ([DIST_ITERS] if pid == 0 else []), f"p{pid} checkpoint writes {writes}")
    require(pid != 0 or storage.get_model_data_models().get(blob) is None,
            "the coordinator removed the rendezvous blobs")
    np.savez(os.path.join(tmp, f"blocks{pid}.npz"), **{
        f"{side}_{f}_{b}": a for side, blk in (("u", ub), ("i", ib))
        for f in ("idx", "rat", "msk") for b, a in enumerate(getattr(blk, f))})
    if pid == 0:
        np.savez(os.path.join(tmp, "factors.npz"), U=U_all, V=V_all, U0=U0, V0=V0,
                 u_perm=ug[2], i_perm=ig[2], users=np.array(list(sh.user_map.keys())),
                 items=np.array(list(sh.item_map.keys())),
                 u_widths=np.array(ub.widths), i_widths=np.array(ib.widths),
                 fingerprint=als._sharded_fingerprint(sh, cfg, len(ug[2]), len(ig[2]),
                                                      DIST_N * DIST_LOCAL))
    out["train"] = {
        "draw_s": draw_s, "exchange_s": exchange_s, "bucketing_s": bucketing_s,
        "train_als_s": train_als_s, "checkpoint_s": checkpoint_s, "train_s": train_s,
        "s_per_iteration": train_s / DIST_ITERS,
        "allgather_ms_per_iteration": gathers["seconds"] * 1e3 / DIST_ITERS,
        "staged_bytes_per_iteration": gathers["staged_bytes"] / DIST_ITERS,
        "launches": launches, "buckets": [len(ub.widths), len(ib.widths)],
        "local_ratings": [len(sh.user_rows.rating), len(sh.item_rows.rating)],
        "padded_slots": ub.padded_ratings + ib.padded_ratings}
    del ub, ib, sh, m, seen

    # 24. the pod plan of 2 host groups × 2 shards, served in lockstep
    z = np.load(os.path.join(tmp, "pod_model.npz"))
    with open(os.path.join(tmp, "pod_plan.bin"), "rb") as f:
        plan = sharding.ShardingPlan.from_payload(f.read())
    pod, answers = {}, {}
    for dtype in DTYPES:
        if dtype == "f32":
            fargs, kw = (z["U"], z["V"]), {}
        else:
            (Uq, us), (Vq, vs) = quantize_factors(z["U"], dtype), quantize_factors(z["V"], dtype)
            fargs, kw = (Uq, Vq), {"factor_dtype": dtype, "user_scale": us, "item_scale": vs}
        fp = BucketedScorer(ctx, *fargs, max_k=K, plan=plan, **kw)
        require(fp._pod and fp._shard_ctx.spans_processes, f"{dtype}: pod {fp._pod}")
        rng = np.random.default_rng(args["seed"] + 191)
        score_kernel.launches.reset()
        distributed.reset_stats()
        ms = {}
        for b in RUNGS:
            users = rng.integers(0, len(z["U"]), b).astype(np.int32)
            sync()
            t0 = time.perf_counter()
            idx, val = fp.score_topk(users, K)
            ms[b] = (time.perf_counter() - t0) * 1e3
            answers[f"{dtype}_{b}_i"], answers[f"{dtype}_{b}_v"] = idx, val
        launches = score_kernel.launches.count
        require(launches == DIST_LOCAL * len(RUNGS) or not on_card,
                f"p{pid} {dtype}: kernel 1 launched {launches} times for {len(RUNGS)} "
                f"dispatches of {DIST_LOCAL} local shards")
        pod[dtype] = {"dispatch_ms": ms, "launches": launches, "dispatches": len(RUNGS),
                      "merge_staged_bytes": distributed.STATS["staged_bytes"],
                      "merge_ms": distributed.STATS["seconds"] * 1e3}
    np.savez(os.path.join(tmp, f"pod{pid}.npz"), **answers)
    # the published pod instance deployed on the mesh: lockstep only
    qs = QueryServer(RecommendationEngine.apply(), storage=Storage(env=dist_storage_env(tmp, "pod")),
                     ctx=ctx, batching=True, telemetry=False)
    base = f"http://127.0.0.1:{qs.start('127.0.0.1', 0)}"
    try:
        pod["readyz"] = http_json(f"{base}/readyz")
        pod["queries"] = http_json(f"{base}/queries.json", {"user": "u1", "num": 5})
    finally:
        qs.stop()
    out["pod"] = pod
    with open(os.path.join(tmp, f"worker{pid}.json"), "w") as f:
        json.dump(out, f)
    distributed.barrier()
    distributed.shutdown()
    return 0


def phase_dist(model, seed, device, inter, item_counts):
    """Phases 21, 22 and 24: see the module docstring."""
    import shutil
    import tempfile
    import uuid

    import numpy as np
    import torch

    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.ops import train_kernel
    from predictionio_tpu_torch.ops.quantize import quantize_factors
    from predictionio_tpu_torch.serving import sharding
    from predictionio_tpu_torch.serving.fastpath import BucketedScorer
    from predictionio_tpu_torch.templates.recommendation import RecommendationEngine

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="pio-dist-")
    saved = os.environ.get("PIO_FS_BASEDIR")
    try:
        # the pod serve's model, plan and published instance (checkpoint mode)
        U, V = model.user_factors, model.item_factors
        np.savez(os.path.join(tmp, "pod_model.npz"), U=U, V=V)
        plan = sharding.build_plan(len(V), DIST_N * DIST_LOCAL, weights=item_counts,
                                   host_groups=DIST_N)
        with open(os.path.join(tmp, "pod_plan.bin"), "wb") as f:
            f.write(plan.to_payload())
        os.environ["PIO_FS_BASEDIR"] = os.path.join(tmp, "base")
        pod_model = als.CheckpointedALSModel(U, V, model.user_map, model.item_map, model.config,
                                             sharding_plan=plan)
        publish(Storage(env=dist_storage_env(tmp, "pod")), RecommendationEngine.apply(), pod_model,
                variant={"algorithms": [{"name": "als", "params": {
                    "rank": RANK, "persistMode": "checkpoint"}}]})
        np.savez(os.path.join(tmp, "draw.npz"), user=inter.user, item=inter.item,
                 rating=inter.rating)
        with open(os.path.join(tmp, "dist_args.json"), "w") as f:
            json.dump({"seed": seed, "run_key": uuid.uuid4().hex[:12], "device": str(device),
                       "draw": [N_USERS, N_ITEMS, N_RATINGS], "block": list(DIST_BLOCK)}, f)
        port = free_port()
        env = dict(os.environ, PYTHONPATH=ROOT, PIO_COORDINATOR=f"127.0.0.1:{port}",
                   PIO_NUM_PROCESSES=str(DIST_N))
        t0 = time.perf_counter()
        procs, logs = [], []
        for i in range(DIST_N):
            logs.append(os.path.join(tmp, f"worker{i}.log"))
            with open(logs[-1], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--dist-worker", tmp],
                    cwd=ROOT, env=dict(env, PIO_PROCESS_ID=str(i)), stdout=log,
                    stderr=subprocess.STDOUT))
        try:
            rcs = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        workers_s = time.perf_counter() - t0
        for i, rc in enumerate(rcs):
            with open(logs[i]) as f:
                require(rc == 0, f"dist worker {i} exited {rc}: {f.read()[-3000:]}")
        w = []
        for i in range(DIST_N):
            with open(os.path.join(tmp, f"worker{i}.json")) as f:
                w.append(json.load(f))
        out = {"phase": "dist", "workers_s": workers_s,
               "join_s": [x["join_s"] for x in w], "build_s": [x["build_s"] for x in w]}

        # 21. every collective's result equals the one-process mesh's
        mesh4 = DeviceContext.create(devices=[device] * (DIST_N * DIST_LOCAL))
        one = {k: fn().cpu().numpy() for k, fn in dist_collectives(
            mesh4, dist_blocks(device, seed, DIST_BLOCK)).items()}
        for pid in range(DIST_N):
            z = np.load(os.path.join(tmp, f"coll{pid}.npz"))
            for name, want in one.items():
                got = z[name]
                if name != "all_gather":
                    want = want[pid * DIST_LOCAL:(pid + 1) * DIST_LOCAL]
                require(got.shape == want.shape and got.tobytes() == want.tobytes(),
                        f"p{pid} {name}: differs from the one-process mesh")
        out["collectives"] = {name: [x["collectives"][name] for x in w] for name in one}
        emit({"phase": "dist-collectives", "bit_equal": True, "block": list(DIST_BLOCK),
              "placements": [DIST_N, DIST_LOCAL], **out["collectives"]})

        # 22. the 2 × 2 run equals the same hosts' blocks on 4 placements of
        # one process bit for bit, and the 1-placement run within the tolerance
        f = np.load(os.path.join(tmp, "factors.npz"))
        zs = [np.load(os.path.join(tmp, f"blocks{p}.npz")) for p in range(DIST_N)]

        def both_hosts(side):
            nb = len(f[f"{side}_widths"])
            cat = [[np.concatenate([z[f"{side}_{name}_{b}"] for z in zs]) for b in range(nb)]
                   for name in ("idx", "rat", "msk")]
            return als._ShardDenseBlocks(idx=cat[0], rat=cat[1], msk=cat[2],
                                         widths=list(f[f"{side}_widths"]), per_shard=0,
                                         padded_ratings=0)

        cfg = als.ALSConfig(rank=RANK, iterations=DIST_ITERS, compute_dtype="f32", solver="dense")
        n_sh = DIST_N * DIST_LOCAL
        t0 = time.perf_counter()
        U_ref, V_ref = als._run_shards(
            mesh4, als._shard_inputs(both_hosts("u"), range(n_sh), [device] * n_sh, True),
            als._shard_inputs(both_hosts("i"), range(n_sh), [device] * n_sh, True),
            f["U0"], f["V0"], cfg)
        one_process_s = time.perf_counter() - t0
        require(U_ref.tobytes() == f["U"].tobytes() and V_ref.tobytes() == f["V"].tobytes(),
                "the 2 × 2 run differs from the same blocks on 4 placements of one process")
        fp = np.load(os.path.join(tmp, "ckpt", f"step_{DIST_ITERS}.fp.npy"))
        require(fp.tobytes() == f["fingerprint"].tobytes(),
                f"the coordinator's checkpoint sidecar {fp} vs the layout's fingerprint")
        del zs
        users, items = f["users"], f["items"]
        u_perm, i_perm = f["u_perm"], f["i_perm"]
        u_orig = np.array([int(s[1:]) for s in users])
        i_orig = np.array([int(s[1:]) for s in items])

        def to_original(blocked, perm, orig, n):
            out_ = np.zeros((n, RANK), np.float32)
            out_[orig] = blocked[perm[:len(orig)]]
            return out_

        init = (to_original(f["U0"], u_perm, u_orig, len(inter.user_map)),
                to_original(f["V0"], i_perm, i_orig, len(inter.item_map)))
        t0 = time.perf_counter()
        m1 = als.train_als(DeviceContext.create(device=device), inter, cfg, init_factors=init)
        one_placement_s = time.perf_counter() - t0
        gap_u = np.abs(m1.user_factors[u_orig] - f["U"][u_perm[:len(u_orig)]])
        gap_v = np.abs(m1.item_factors[i_orig] - f["V"][i_perm[:len(i_orig)]])
        tol_u = DIST_TRAIN_TOL * (1 + np.abs(m1.user_factors[u_orig]))
        tol_v = DIST_TRAIN_TOL * (1 + np.abs(m1.item_factors[i_orig]))
        gaps = {"max_abs_u": float(gap_u.max()), "max_abs_v": float(gap_v.max()),
                "beyond_tol": int((gap_u > tol_u).sum() + (gap_v > tol_v).sum())}
        require(gaps["beyond_tol"] == 0,
                f"2 × 2 vs 1-placement factors beyond rtol = atol = {DIST_TRAIN_TOL}: {gaps}")
        t = w[0]["train"]
        out["train"] = {**{k: [x["train"][k] for x in w] for k in t},
                        "one_process_4_placements_s": one_process_s,
                        "one_placement_s": one_placement_s, "vs_one_placement": gaps}
        emit({"phase": "dist-train-ml25m", "bit_equal_to_one_process": True,
              "iterations": DIST_ITERS, "ratings": N_RATINGS, **out["train"]})

        # 3′ over the same 4 placements of one process: the segment solver
        # launches its kernel once a shard a half-step
        seg = zipf_interactions(seed + 3, *SEG_DRAW)
        scfg = als.ALSConfig(rank=RANK, iterations=2, compute_dtype="f32", solver="segment")
        train_kernel.segment_launches.reset()
        t0 = time.perf_counter()
        als.train_als(mesh4, seg, scfg)
        seg_launches = train_kernel.segment_launches.count
        require(seg_launches == n_sh * 2 * scfg.iterations,
                f"segment kernel launched {seg_launches} times over {n_sh} shards × 2 × 2")
        out["segment_4_placements"] = {"launches": seg_launches, "s": time.perf_counter() - t0,
                                       "ratings": SEG_DRAW[2]}
        emit({"phase": "dist-train-segment", **out["segment_4_placements"]})
        del seg

        # 24. the pod answers equal the one-process pod serve bit for bit
        pod_rows = {}
        for dtype in DTYPES:
            if dtype == "f32":
                fargs, kw = (U, V), {}
            else:
                (Uq, us), (Vq, vs) = quantize_factors(U, dtype), quantize_factors(V, dtype)
                fargs, kw = (Uq, Vq), {"factor_dtype": dtype, "user_scale": us, "item_scale": vs}
            fp = BucketedScorer(mesh4, *fargs, max_k=K, plan=plan, **kw)
            require(fp._pod and not fp._shard_ctx.spans_processes, "one-process pod serve")
            rng = np.random.default_rng(seed + 191)
            for b in RUNGS:
                users_b = rng.integers(0, len(U), b).astype(np.int32)
                wi, wv = fp.score_topk(users_b, K)
                for pid in range(DIST_N):
                    z = np.load(os.path.join(tmp, f"pod{pid}.npz"))
                    require(np.array_equal(z[f"{dtype}_{b}_i"], wi)
                            and z[f"{dtype}_{b}_v"].tobytes() == wv.tobytes(),
                            f"p{pid} {dtype} B = {b}: the lockstep answer differs")
            pod_rows[dtype] = [x["pod"][dtype] for x in w]
        jax_body = {"message": "pod mesh spans processes: queries must be dispatched in SPMD "
                    "lockstep on every process, not routed to one — serve through "
                    "self-contained host-local replicas instead"}
        for pid, x in enumerate(w):
            rs, rb = x["pod"]["readyz"]
            require(rs == 503 and rb["status"] == "pod mesh spans processes (lockstep only)"
                    and rb["pod"]["group"] is None and rb["pod"]["spansProcesses"],
                    f"p{pid} /readyz {rs} {rb}")
            qs_, qb = x["pod"]["queries"]
            require(qs_ == 503 and qb == jax_body, f"p{pid} /queries.json {qs_} {qb}")
        out["pod"] = pod_rows
        emit({"phase": "dist-pod", "bit_equal_to_one_process": True, "groups": DIST_N,
              "shards": DIST_N * DIST_LOCAL, "rows": pod_rows, "readyz": 503, "queries": 503})
        out["seconds"] = time.perf_counter() - t_phase
        return out
    finally:
        if saved is None:
            os.environ.pop("PIO_FS_BASEDIR", None)
        else:
            os.environ["PIO_FS_BASEDIR"] = saved
        shutil.rmtree(tmp, ignore_errors=True)


def als_f64(inter, U0, V0, cfg, device):
    """ALS-WR (explicit) of ``inter`` in float64 from (U0, V0) in its id
    order: the plain normal equations (``Σ v vᵀ + (λ·n + 1e-6) I``, ``Σ r v``)
    and a float64 solve, ``cfg.iterations`` times. The witness the float32
    trainings are measured against."""
    import torch

    f64 = torch.float64
    u = torch.from_numpy(inter.user.astype("int64")).to(device)
    i = torch.from_numpy(inter.item.astype("int64")).to(device)
    r = torch.from_numpy(inter.rating.astype("float64")).to(device)
    eye = torch.eye(cfg.rank, dtype=f64, device=device)

    def side(e, o, F, n):
        g = F[o]
        A = torch.zeros(n, cfg.rank, cfg.rank, dtype=f64, device=device).index_add_(
            0, e, g[:, :, None] * g[:, None, :])
        b = torch.zeros(n, cfg.rank, dtype=f64, device=device).index_add_(0, e, r[:, None] * g)
        cnt = torch.zeros(n, dtype=f64, device=device).index_add_(0, e, torch.ones_like(r))
        return torch.linalg.solve(A + (cfg.reg * cnt + 1e-6)[:, None, None] * eye, b)

    U = torch.from_numpy(U0).to(device, f64)
    V = torch.from_numpy(V0).to(device, f64)
    for _ in range(cfg.iterations):
        U = side(u, i, V, len(U))
        V = side(i, u, U, len(V))
    return U.cpu().numpy(), V.cpu().numpy()


def pio_launch(tmp, name, *argv, env=None, timeout=600):
    """``pio launch -n DIST_N -- <argv>`` as a subprocess; (rc, its output,
    each process's kernel launches from its last report)."""
    import re

    log = os.path.join(tmp, f"{name}.log")
    cmd = CLI + ["launch", "-n", str(DIST_N), "--coordinator-port", str(free_port()), "--", *argv]
    t0 = time.perf_counter()
    with open(log, "w") as f:
        rc = subprocess.run(cmd, cwd=ROOT, env=dict(env or os.environ, PYTHONPATH=ROOT),
                            stdout=f, stderr=subprocess.STDOUT, timeout=timeout).returncode
    with open(log) as f:
        text = f.read()
    launches = {}
    for m in re.finditer(r"\[p(\d+)\] \[INFO\] process \d+/\d+ kernel launches: (\{.*\})", text):
        launches[int(m.group(1))] = json.loads(m.group(2))
    return rc, text, launches, time.perf_counter() - t0


def phase_dist_cli(seed, device):
    """Phase 23: ``pio launch`` on the card. See the module docstring."""
    import re
    import shutil
    import signal
    import tempfile
    import uuid

    import numpy as np
    import torch

    from predictionio_tpu_torch.core import workflow
    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import sqlite
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.device import DeviceContext
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.models import sequential as seq
    from predictionio_tpu_torch.parallel import ingest
    from predictionio_tpu_torch.templates.recommendation import (
        DataSourceParams,
        RecommendationDataSource,
        RecommendationEngine,
    )
    from predictionio_tpu_torch.templates.sequentialrecommendation import (
        SequentialRecommendationEngine,
    )
    from predictionio_tpu_torch.testing import topk_mismatches
    from predictionio_tpu_torch.tools import launcher as launch_mod

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="pio-dist-cli-")
    saved = {k: v for k, v in os.environ.items()
             if k.startswith("PIO_STORAGE_") or k in ("PIO_FS_BASEDIR", "PIO_ALS_SOLVER")}
    for k in saved:
        del os.environ[k]
    os.environ["PIO_FS_BASEDIR"] = os.path.join(tmp, "base")
    Storage.reset_instance()
    store.set_storage(None)
    servers = []
    out = {"phase": "dist-cli"}
    key_of = re.compile(r"Access Key: (\S+)")
    try:
        # 1. 100,000 events of the ML-1M draw in the zero-config sqlite store
        key_of.search(cli_run("app", "new", "DistApp"))
        storage = Storage.instance()
        app_id = storage.get_meta_data_apps().get_by_name("DistApp").id
        inter, _ = ml1m_interactions(seed)
        rng = np.random.default_rng(seed + 23)
        pick = np.sort(rng.choice(len(inter.user), QS_BULK, replace=False))
        b_user, b_item, b_t = inter.user[pick], inter.item[pick], inter.t[pick]
        del inter
        buy = rng.integers(0, QS_BUY_EVERY, QS_BULK) == 0
        stars = rng.integers(1, 6, QS_BULK)
        le = storage.get_l_events()
        for c in range(0, QS_BULK, QS_BULK_CHUNK):
            le.insert_batch([
                Event(event="buy" if buy[k] else "rate", entity_type="user",
                      entity_id=f"u{b_user[k]}", target_entity_type="item",
                      target_entity_id=f"si{b_item[k]}",
                      properties=None if buy[k] else {"rating": int(stars[k])},
                      event_time=float(b_t[k]), creation_time=float(b_t[k]))
                for k in range(c, min(c + QS_BULK_CHUNK, QS_BULK))], app_id)

        # 2. pio launch -n 2 -- train: one COMPLETED instance, kernel 2 in
        # every process
        eng = os.path.join(tmp, "recommendation")
        cli_run("template", "get", "recommendation", "--directory", eng)
        variant = fill_engine_json(os.path.join(eng, "engine.json"), "DistApp", [
            {"name": "als", "params": {"rank": RANK, "numIterations": TRAIN_ITERS, "seed": seed}}])
        rc, text, launches, train_s = pio_launch(tmp, "train", "train", "--engine-dir", eng,
                                                 "--device", device.type)
        require(rc == 0, f"pio launch train exited {rc}: {text[-3000:]}")
        ids = set(re.findall(r"Engine instance ID: (\S+)", text))
        insts = storage.get_meta_data_engine_instances().get_all()
        done = [i for i in insts if i.status == "COMPLETED"]
        require(len(ids) == 1 and len(done) == 1 and len(insts) == 1 and done[0].id in ids,
                f"instances {[(i.id, i.status) for i in insts]}, reported {ids}")
        iid = done[0].id
        k2 = [launches.get(p, {}).get("train_normal_eq", 0) for p in range(DIST_N)]
        require(len(set(k2)) == 1 and k2[0] > 0 and k2[0] % TRAIN_ITERS == 0,
                f"kernel 2 launches per process {k2} over {TRAIN_ITERS} iterations")
        out["train"] = {"wall_s": train_s, "kernel2_launches": k2, "instance": iid}
        emit({"phase": "dist-cli", "step": "train", **out["train"]})

        # 3. the same two ranks' blocks in this process on 2 placements of the
        # card: the factors equal the launch's bit for bit
        engine = RecommendationEngine.apply()
        _, _, _, models = workflow.prepare_deploy(engine, done[0], storage=storage,
                                                  ctx=DeviceContext.create(device=device))
        m2 = models[0]
        src = engine.make_algorithms(engine.params_from_variant(variant))[0]._config()
        parts = RecommendationDataSource(DataSourceParams(appName="DistApp"))._part_filters()
        run_key = uuid.uuid4().hex[:12]
        with ThreadPoolExecutor(DIST_N) as pool:
            sh = list(pool.map(lambda p: ingest.read_sharded_interactions(
                storage, app_id, run_key=run_key, process_index=p, num_processes=DIST_N,
                parts=parts), range(DIST_N)))
        hosts = [als._sharded_blocks_for_host(sh[p], DIST_N, p, DIST_N) for p in range(DIST_N)]
        u_perm, i_perm = hosts[0][2][2], hosts[0][3][2]
        U0, V0 = als.sharded_initial_factors(sh[0], src, u_perm, i_perm)
        U_ref, V_ref = als._run_shards(
            DeviceContext.create(devices=[device] * DIST_N),
            [x for h in hosts for x in als._shard_inputs(h[0], range(1), [device], True)],
            [x for h in hosts for x in als._shard_inputs(h[1], range(1), [device], True)],
            U0, V0, src)
        require(list(sh[0].user_map.keys()) == list(m2.user_map.keys())
                and U_ref[u_perm[:sh[0].n_users]].tobytes() == m2.user_factors.tobytes()
                and V_ref[i_perm[:sh[0].n_items]].tobytes() == m2.item_factors.tobytes(),
                "the launch's factors differ from its two ranks' blocks on 2 placements")
        # rule 4's factor clause: the read `pio train` makes in one process,
        # trained on one placement from the launch's own start (its draw in
        # global-id order, handed over by entity name; `pio train` would draw
        # in its own id order and start elsewhere). Witness: a float64
        # training from that start, which the launch is no farther from
        # than the one-process float32 training is
        one = RecommendationDataSource(DataSourceParams(appName="DistApp"))._read_interactions(
            sharded_ok=False)
        gen = torch.Generator(device="cpu").manual_seed(int(src.seed))
        gU = als._initial_factors(src, sh[0].n_users, gen)
        gV = als._initial_factors(src, sh[0].n_items, gen)
        ou = np.array([m2.user_map[n] for n in one.user_map.keys()])
        oi = np.array([m2.item_map[n] for n in one.item_map.keys()])
        m1 = als.train_als(DeviceContext.create(device=device), one, src,
                           init_factors=(gU[ou], gV[oi]))
        U64, V64 = als_f64(one, gU[ou], gV[oi], src, device)
        launch_f = (m2.user_factors[ou], m2.item_factors[oi])
        one_f = (m1.user_factors, m1.item_factors)

        def gap(a, b):
            return max(float(np.abs(x - y).max()) for x, y in zip(a, b))

        deg = np.bincount(one.user, minlength=one.n_users)
        at_rank = deg >= src.rank
        vs = {"max_abs": gap(launch_f, one_f),
              "max_rel": max(float((np.abs(x - y) / (1 + np.abs(y))).max())
                             for x, y in zip(launch_f, one_f)),
              "max_abs_users_at_rank": gap([launch_f[0][at_rank]], [one_f[0][at_rank]]),
              "users_below_rank": float(1 - at_rank.mean()),
              "launch_vs_f64": gap(launch_f, (U64, V64)), "one_vs_f64": gap(one_f, (U64, V64))}
        require(vs["max_rel"] <= DIST_CLI_TOL,
                f"the launch's factors vs one process's from the same start: {vs}")
        require(vs["max_abs"] <= vs["one_vs_f64"] and vs["launch_vs_f64"] <= 2 * vs["one_vs_f64"],
                f"the launch's gap to one process is beyond the float32 floor: {vs}")
        out["vs_one_process"] = {"bit_equal": True, "placements": DIST_N, "same_start": vs}
        emit({"phase": "dist-cli", "step": "vs-one-process", **out["vs_one_process"]})

        # 4. pio deploy --batching of the launch's instance: kernel 1 a dispatch
        qs = CliServer(tmp, "deploy", "deploy", "--engine-dir", eng, "--batching",
                       "--device", device.type)
        servers.append(qs)
        ready_s = qs.wait_ready()
        require(http_json(f"{qs.base}/readyz")[1]["engineInstanceId"] == iid, "deployed instance")
        at_ready = http_json(f"{qs.base}/")[1]["scoreKernelLaunches"]
        q_rng = np.random.default_rng(seed + 24)
        inv = m2.user_map.inverse
        queries = [{"user": inv[int(q_rng.integers(len(m2.user_map)))], "num": 10}
                   for _ in range(DIST_CLI_QUERIES)]
        answers = [http_json(f"{qs.base}/queries.json", q) for q in queries]
        require(all(s == 200 for s, _ in answers), "every /queries.json answered 200")
        info = http_json(f"{qs.base}/")[1]
        served = info["scoreKernelLaunches"] - at_ready
        require(served == info["fastpath"][0]["calls"] > 0,
                f"kernel 1 launched {served} times vs {info['fastpath'][0]['calls']} dispatches")
        U, V = (torch.from_numpy(np.ascontiguousarray(F)) for F in (m2.user_factors, m2.item_factors))
        users = torch.tensor([m2.user_map[q["user"]] for q in queries])
        rv, ri = (t.numpy() for t in torch.topk(U[users] @ V.T, 10, dim=1))
        bad = []
        for j, (_, a) in enumerate(answers):
            gi = np.array([[m2.item_map[x["item"]] for x in a["itemScores"]]])
            gv = np.array([[x["score"] for x in a["itemScores"]]])
            bad += topk_mismatches(gv, gi, rv[j:j + 1], ri[j:j + 1], TOL)
        require(not bad, f"served answers vs the plain version: {bad[:3]}")
        cli_run("undeploy", "--port", str(qs.port))
        qs.wait_exit()
        out["serve"] = {"deploy_to_ready_s": ready_s, "queries": len(answers), "launches": served}
        emit({"phase": "dist-cli", "step": "serve", **out["serve"]})

        # 5. pio launch -n 2 -- batchpredict: part files equal one process's
        qfile = os.path.join(tmp, "queries.jsonl")
        with open(qfile, "w") as fq:
            for q in queries:
                fq.write(json.dumps(q) + "\n")
        rc, text, launches, bp_s = pio_launch(
            tmp, "batchpredict", "batchpredict", "--engine-dir", eng, "--input", qfile,
            "--output", os.path.join(tmp, "bp.jsonl"), "--device", device.type)
        require(rc == 0, f"pio launch batchpredict exited {rc}: {text[-3000:]}")
        cli_run("batchpredict", "--engine-dir", eng, "--input", qfile,
                "--output", os.path.join(tmp, "one.jsonl"), "--device", device.type)
        parts = [json.loads(x) for p in range(DIST_N)
                 for x in open(os.path.join(tmp, f"bp.jsonl.part-{p}"))]
        one = [json.loads(x) for x in open(os.path.join(tmp, "one.jsonl"))]
        key = lambda r: json.dumps(r["query"], sort_keys=True)  # noqa: E731
        got = {key(r): r for r in parts}
        require(len(parts) == len(one) == len(queries), f"{len(parts)} part lines, {len(one)}")
        for r in one:
            a, b = got[key(r)]["prediction"]["itemScores"], r["prediction"]["itemScores"]
            require([x["item"] for x in a] == [x["item"] for x in b]
                    and np.allclose([x["score"] for x in a], [x["score"] for x in b],
                                    rtol=TOL, atol=TOL), f"batchpredict part line {key(r)}")
        k1 = [launches.get(p, {}).get("score_topk", 0) for p in range(DIST_N)]
        require(all(n > 0 for n in k1), f"kernel 1 launches per process {k1}")
        out["batchpredict"] = {"wall_s": bp_s, "kernel1_launches": k1, "lines": len(parts)}
        emit({"phase": "dist-cli", "step": "batchpredict", **out["batchpredict"]})

        # 6. e-commerce: implicit ALS under the launch
        ecom = os.path.join(tmp, "ecommerce")
        cli_run("template", "get", "ecommercerecommendation", "--directory", ecom)
        fill_engine_json(os.path.join(ecom, "engine.json"), "DistApp", [
            {"name": "ecomm", "params": {"appName": "DistApp", "rank": RANK,
                                         "numIterations": TPL_ITERS}}],
            eventNames=["rate", "buy"])
        rc, text, launches, ec_s = pio_launch(tmp, "ecomm", "train", "--engine-dir", ecom,
                                              "--device", device.type)
        require(rc == 0, f"pio launch train (e-commerce) exited {rc}: {text[-3000:]}")
        k2 = [launches.get(p, {}).get("train_normal_eq", 0) for p in range(DIST_N)]
        require(len(set(k2)) == 1 and k2[0] > 0 and k2[0] % TPL_ITERS == 0,
                f"e-commerce kernel 2 (implicit) launches per process {k2}")
        out["ecommerce"] = {"wall_s": ec_s, "kernel2_launches": k2}
        emit({"phase": "dist-cli", "step": "ecommerce", **out["ecommerce"]})

        # 7. SASRec data parallel: kernels 4-6 a layer a step in each process
        seq_app_id = storage.get_meta_data_apps().get_by_name("DistApp").id
        srng = np.random.default_rng(seed + 15)
        w = zipf_mandelbrot_weights(1000, 1.1)
        le.insert_batch([
            Event(event="view", entity_type="user", entity_id=f"wu{u}", target_entity_type="item",
                  target_entity_id=f"wi{int(i)}", event_time=1_767_225_600.0 + t)
            for u in range(300)
            for t, i in enumerate(srng.choice(1000, int(srng.integers(20, 301)), p=w))], seq_app_id)
        seng = os.path.join(tmp, "sequentialrecommendation")
        cli_run("template", "get", "sequentialrecommendation", "--directory", seng)
        fill_engine_json(os.path.join(seng, "engine.json"), "DistApp", [
            {"name": "sasrec", "params": {
                "appName": "DistApp", "eventNames": ["view"], "dModel": SAS_D,
                "numLayers": SAS_LAYERS, "numHeads": SAS_HEADS, "maxLen": SAS_MAX_LEN,
                "epochs": QS_SAS_STEPS, "batchSize": SAS_BATCH, "lr": SAS_LR, "seed": seed}}],
            eventNames=["view"])
        rc, text, launches, sas_s = pio_launch(tmp, "sasrec", "train", "--engine-dir", seng,
                                               "--device", device.type)
        require(rc == 0, f"pio launch train (SASRec) exited {rc}: {text[-3000:]}")
        want = SAS_LAYERS * QS_SAS_STEPS
        for p in range(DIST_N):
            got_l = {k: launches.get(p, {}).get(k) for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
            require(set(got_l.values()) == {want},
                    f"p{p} SASRec flash launches {got_l} vs {SAS_LAYERS} layers × {QS_SAS_STEPS} steps")
        sas_iid = re.search(r"Engine instance ID: (\S+)", text).group(1)
        sas_inst = storage.get_meta_data_engine_instances().get(sas_iid)
        _, _, _, smodels = workflow.prepare_deploy(
            SequentialRecommendationEngine.apply(), sas_inst, storage=storage,
            ctx=DeviceContext.create(device=device))
        losses = np.asarray(smodels[0].losses)
        require(len(losses) == QS_SAS_STEPS and np.isfinite(losses).all()
                and losses[-5:].mean() < losses[:5].mean(),
                f"SASRec launch losses {losses[:3]} … {losses[-3:]}")
        # the same steps in one process: each rank's rows and its draws
        # (its own stream), concatenated into the global batch, through
        # train_step on one placement from the same start
        scfg = seq.SASRecConfig(d_model=SAS_D, n_layers=SAS_LAYERS, n_heads=SAS_HEADS,
                                max_len=SAS_MAX_LEN, epochs=QS_SAS_STEPS, batch_size=SAS_BATCH,
                                lr=SAS_LR, seed=seed)
        run_key = uuid.uuid4().hex[:12]
        with ThreadPoolExecutor(DIST_N) as pool:
            ssh = list(pool.map(lambda p: ingest.read_sharded_interactions(
                storage, seq_app_id, run_key=run_key, process_index=p, num_processes=DIST_N,
                entity_type="user", event_names=["view"], target_entity_type="item",
                item_pass=False), range(DIST_N)))
        rows = [seq._sharded_sequences(x, scfg) for x in ssh]
        n_global = rows[0][1]
        batch = seq.pad_to_multiple(min(scfg.batch_size, seq.pad_to_multiple(n_global, DIST_N)), DIST_N)
        net = seq.SASRecNet(seq.init_params(scfg.seed, scfg, ssh[0].n_items), scfg, device,
                            trainable=True)
        opt = seq.adam(net, scfg)
        rngs = [np.random.default_rng(scfg.seed + 1_000_003 * p) for p in range(DIST_N)]
        on_dev = [torch.from_numpy(r.astype(np.int64)).to(device) for r, _ in rows]
        one_losses = np.array([float(seq.train_step(net, opt, torch.cat([
            on_dev[p][torch.from_numpy(rngs[p].integers(0, len(on_dev[p]), batch // DIST_N)).to(device)]
            for p in range(DIST_N)]), scfg)) for _ in range(QS_SAS_STEPS)])
        sas_rel = float((np.abs(losses - one_losses) / np.abs(one_losses)).max())
        require(sas_rel <= SAS_DP_RTOL,
                f"SASRec launch losses vs one process's steps: max rel {sas_rel} "
                f"({losses[:3]} vs {one_losses[:3]})")
        flash_per_process = [{k: launches.get(p, {}).get(k) for k in (
            "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")} for p in range(DIST_N)]
        out["sasrec"] = {"wall_s": sas_s, "flash_launches_per_process": flash_per_process,
                         "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
                         "vs_one_process_max_rel": sas_rel, "global_batch": batch}
        emit({"phase": "dist-cli", "step": "sasrec", **out["sasrec"]})

        # 8. kill -9 of one worker mid-training (the SASRec launch, the
        # longest): the launch fails with its code and does not hang
        env = dict(os.environ, PYTHONPATH=ROOT)
        log = os.path.join(tmp, "killed.log")
        t0 = time.perf_counter()
        with open(log, "w") as f:
            launcher = subprocess.Popen(
                CLI + ["launch", "-n", str(DIST_N), "--coordinator-port", str(free_port()), "--",
                       "train", "--engine-dir", seng, "--device", device.type],
                cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)
        killed = None
        while killed is None and launcher.poll() is None and time.perf_counter() - t0 < 120:
            with open(log) as f:
                pid_of = re.search(rf"process {DIST_N - 1}: pid (\d+)", f.read())
            if pid_of and time.perf_counter() - t0 > 0.4 * sas_s:
                os.kill(int(pid_of.group(1)), signal.SIGKILL)
                killed = (int(pid_of.group(1)), time.perf_counter() - t0)
            time.sleep(0.1)
        rc = launcher.wait(timeout=launch_mod.FAIL_GRACE_S + 120)
        kill_s = time.perf_counter() - t0
        with open(log) as f:
            text = f.read()
        require(killed is not None, f"no worker to kill (launch exited {rc}): {text[-2000:]}")
        require(rc != 0 and "exited with code -9" in text,
                f"the launch with a killed worker exited {rc}: {text[-2000:]}")
        out["kill"] = {"rc": rc, "seconds": kill_s, "killed_at_s": killed[1],
                       "grace_s": launch_mod.FAIL_GRACE_S}
        emit({"phase": "dist-cli", "step": "kill-9", **out["kill"]})
        out["seconds"] = time.perf_counter() - t_phase
        emit({"phase": "dist-cli", "seconds": out["seconds"], "ok": True})
        return out
    finally:
        for s in servers:
            s.kill()
        store.set_storage(None)
        sqlite.close_all_dbs()
        Storage.reset_instance()
        os.environ.pop("PIO_FS_BASEDIR", None)
        os.environ.update(saved)
        shutil.rmtree(tmp, ignore_errors=True)



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
    ap.add_argument("--dist-worker", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if args.dist_worker:  # a rank of phase_dist's launch, on the device it names
        sys.path.insert(0, ROOT)
        return dist_worker(args.dist_worker)
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
    from predictionio_tpu_torch.testing import warm_cpu_math

    # the CPU-side references (the parity phases' CPU trainings, plain
    # versions run on the host) start after the first exp/log of the process
    warm_cpu_math()
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
    pub = phase_publish_eval(model, args.seed, device, rows, ops)
    stream = phase_streaming(model, args.seed, device)
    ivf_out = phase_ivf(model, args.seed, device)
    import numpy as np

    sharded = phase_sharded(model, args.seed, device, np.bincount(inter.item, minlength=N_ITEMS))
    ring_out = phase_ring(args.seed, device)
    dist = phase_dist(model, args.seed, device, inter, np.bincount(inter.item, minlength=N_ITEMS))
    dist_cli = phase_dist_cli(args.seed, device)
    t0 = time.perf_counter()
    tpl_ur = phase_ur_ml25m(args.seed, device, inter)
    del inter
    tpl_cli = phase_templates_cli(args.seed, device)
    templates = {"ur_ml25m": tpl_ur, "cli": tpl_cli, "seconds": time.perf_counter() - t0}
    emit({"phase": "templates", "seconds": templates["seconds"], "ok": True})
    fleet = phase_fleet(model, args.seed, device)
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
    # publish-eval: kernel 1 served by dtype, kernel 2 resumed and evaluated,
    # the flash kernels after a SASRec resume; kernel 1's B = 64 times by dtype
    kernels["kernels"][0]["publish_eval_launches"] = {
        "deploy_int8": pub["deploy"]["int8"]["launches"],
        "deploy_bf16": pub["deploy"]["bf16"]["launches"],
        "batchpredict_int8": pub["batchpredict"]["launches"],
        "eval_f32": pub["eval"]["kernel1_launches"]}
    # streaming: kernel 1 on the f32 and int8 replicas while deltas land, and
    # on the restarted replica (launches = each server's dispatches)
    kernels["kernels"][0]["streaming_launches"] = {
        d: row["launches"] for d, row in stream["kernel1"].items()}
    # IVF: kernel 1's probe mode on both deployed IVF servers (launches =
    # each server's dispatches) and its times at the ML-25M index by rung
    kernels["kernels"][0]["ivf_launches"] = {
        m: ivf_out["served"][m]["launches"] for m in ("checkpoint", "auto")}
    kernels["kernels"][0]["ivf_by_rung"] = {
        r["batch"]: {key: r[key] for key in ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms", "exact_ms", "scanned_fraction",
                                             "real_rows", "padding_share")}
        for r in ivf_out["times"] if r["catalog"] == "ml25m"}
    # the fleet: kernel 1 on each replica behind the router (launches =
    # dispatches, asserted) at concurrency 1 and 16, and on the pipeline's
    # ranking stage (one filtered launch a ranking call, asserted)
    kernels["kernels"][0]["fleet_launches"] = {
        f"c{row['concurrency']}": sum(r["launches"] for r in row["per_replica"].values())
        for row in fleet["route"]}
    kernels["kernels"][0]["fleet_launches"]["pipeline_ranking"] = fleet["pipeline"]["kernel1_launches"]
    # the sharded placement on four placements of the card: kernel 1 once a
    # shard a dispatch (asserted), the B = 64 dispatch beside the exact kernel
    kernels["kernels"][0]["sharded_launches"] = {
        "launches": sharded["launches"], "dispatches": sharded["dispatches"], "shards": SH_SHARDS}
    kernels["kernels"][0]["sharded_b64"] = {
        key: sharded["times"][key] for key in ("dispatch_ms", "pod_dispatch_ms", "exact_ms",
                                               "kernel_us_per_shard", "exact_kernel_us")}
    kernels["kernels"][0]["by_dtype_b64"] = {
        r["dtype"]: {key: r[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in rows if r.get("case", "ml25m") == "ml25m" and r["batch"] == RUNGS[-1]}
    # templates: kernel 2 in implicit mode on each implicit-ALS template's
    # `pio train` (launches = buckets × iterations, asserted), and its times
    # on the e-commerce template's data
    kernels["kernels"][1]["templates_launches"] = {
        name: row["kernel2_launches"] for name, row in tpl_cli["templates"].items()
        if "buckets" in row}
    kernels["kernels"][1]["implicit_on_templates"] = {
        key: tpl_cli["templates"]["ecommercerecommendation"]["kernel2_implicit"][key]
        for key in ("buckets", "ms", "device_us", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "iteration_ms")}
    # the largest errors of kernel 2 against its plain version over every
    # bucket of the three implicit-ALS templates, and their factors against
    # CPU trainings
    held = [row["kernel2_implicit_held"] for row in tpl_cli["templates"].values()
            if "kernel2_implicit_held" in row]
    require(len(held) == 3, f"kernel 2 held on {len(held)} implicit-ALS templates")
    kernels["kernels"][1]["implicit_on_templates"].update(
        buckets_held=sum(h["buckets_held"] for h in held),
        **{key: max(h[key] for h in held) for key in (
            "max_abs_err", "max_rel_err", "kernel_vs_f64_rel", "plain_vs_f64_rel",
            "factors_vs_cpu_max_abs")})
    for key in ("max_abs_err", "max_rel_err", "kernel_vs_f64_rel", "plain_vs_f64_rel"):
        kernels["kernels"][1][key] = max(kernels["kernels"][1][key],
                                         kernels["kernels"][1]["implicit_on_templates"][key])
    kernels["kernels"][1]["publish_eval_launches"] = {
        "resume": pub["resume_als"]["launches_resumed"], "eval": pub["eval"]["kernel2_launches"]}
    for k, part in zip(kernels["kernels"][2:5], ("fwd", "bwd_dq", "bwd_dkv")):
        k["publish_eval_launches"] = {"resume": pub["resume_sasrec"]["launches"][part]}
        # one forward and backward of ring_flash_attention over four blocks
        # (n(n+1)/2 live pairs, asserted)
        k["ring_launches"] = ring_out["launches"][part]
    # many processes (2 ranks of 2 placements of the card each): kernel 1 on
    # the pod serve (local shards × dispatches a process, asserted), the
    # launch-trained deployment and the batchpredict part files; kernel 2 on
    # the ML-25M training (buckets × local shards × iterations a process,
    # asserted) and the CLI trainings; 3′ on 4 placements of one process;
    # kernels 4-6 on the SASRec launch (a layer a step in each process)
    kernels["kernels"][0]["dist_launches"] = {
        "pod_per_process": {d: [r["launches"] for r in rows_]
                            for d, rows_ in dist["pod"].items()},
        "cli_serve": dist_cli["serve"]["launches"],
        "batchpredict_per_process": dist_cli["batchpredict"]["kernel1_launches"]}
    kernels["kernels"][1]["dist_launches"] = {
        "ml25m_per_process": dist["train"]["launches"],
        "cli_train_per_process": dist_cli["train"]["kernel2_launches"],
        "ecommerce_per_process": dist_cli["ecommerce"]["kernel2_launches"]}
    kernels["kernels"][6]["dist_launches"] = {
        "four_placements": dist["segment_4_placements"]["launches"]}
    for k, name in zip(kernels["kernels"][2:5], ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")):
        k["dist_launches"] = {"sasrec_per_process": [
            row[name] for row in dist_cli["sasrec"]["flash_launches_per_process"]]}
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
                   "serving_ops": ops, "publish_eval": pub, "streaming": stream, "ivf": ivf_out,
                   "templates": templates, "fleet": fleet, "sharded": sharded,
                   "ring": ring_out, "dist": dist, "dist_cli": dist_cli, **kernels}, f, indent=1)
    require(score_kernel.launches.count > 0, "kernel launched")
    print(smi, flush=True)
    emit(kernels)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
