"""The ALS family's adapter: the one place that names the program's ALS
functions. Two modes, chosen by the mix:

* ``iterate``: set-up draws the ratings and the initial factors from the
  seed, lays the ratings out with the program's own bucketing
  (``_dense_shards_for``, ``_shard_inputs``) and warms the loop with one
  call; a unit of the window is one call of ``_run_shards``, one retrain's
  device loop of ``iterations`` from the same initial factors, ending in
  the host factors ``train_als`` returns;
* ``bulk``: set-up draws the factors from the seed and builds the
  program's ``ALSScorer``; a unit is one ``recommend_batch`` of the next
  ``chunk`` user ids in order, top ``num``, as ``pio batchpredict`` calls
  it, wrapping around at the last user.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from portbench import harness
from portbench.generators import zipf
from portbench.reference import als as ref_als
from portbench.reference import compare
from portbench.reference import topk as ref_topk


def draw_ratings(config: dict, seed: int, device) -> tuple:
    """The configuration's ratings from the seed, drawn on ``device``:
    host ``(user int32, item int32, rating float32)``."""
    gen = torch.Generator(device=device).manual_seed(harness.seeds(seed, 3)[0])
    user, item, rating = zipf.zipf_ratings_torch(
        gen, config["n_users"], config["n_items"], config["n_ratings"],
        config["user_zipf_s"], config["item_zipf_s"], config["zipf_q"],
        config["rating_low"], config["rating_high"])
    return (user.to(torch.int32).cpu().numpy(), item.to(torch.int32).cpu().numpy(),
            rating.cpu().numpy())


def draw_factors(config: dict, seed: int, device) -> tuple:
    """Initial (or served) factors from the seed, drawn on ``device`` in one
    call: standard normal scaled by 1/sqrt(rank), as ``train_als``
    initialises them; host ``(U, V)`` in original id order."""
    gen = torch.Generator(device=device).manual_seed(harness.seeds(seed, 3)[1])
    n_users, rank = config["n_users"], config["rank"]
    F = torch.randn((n_users + config["n_items"], rank), generator=gen, device=device)
    F = (F * np.float32(1.0 / np.sqrt(rank))).cpu().numpy()
    return F[:n_users], F[n_users:]


class Cell:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.mix, self.seed, self.device = config, mix, seed, torch.device(device)
        self.mode = mix["mode"]
        if self.mode not in ("iterate", "bulk"):
            raise ValueError(f"the ALS adapter runs 'iterate' or 'bulk', not {self.mode!r}")
        self.setup_spans: dict = {}
        self.failed = 0

    # -- set-up ------------------------------------------------------------------

    def setup(self) -> None:
        from predictionio_tpu_torch.device import DeviceContext

        self.ctx = DeviceContext.create(device=self.device)
        self._keep_rng = np.random.default_rng(harness.seeds(self.seed, 3)[2])
        self.kept: list = []
        if self.mode == "iterate":
            self._setup_iterate()
        else:
            self._setup_bulk()

    def _als_config(self):
        from predictionio_tpu_torch.models.als import ALSConfig

        c = self.config
        return ALSConfig(rank=c["rank"], iterations=c["iterations"], reg=c["lambda"],
                         implicit=False, compute_dtype="f32", solver="dense")

    def _setup_iterate(self) -> None:
        from predictionio_tpu_torch.data.batch import interactions_from_arrays
        from predictionio_tpu_torch.models import als

        c = self.config
        self.user, self.item, self.rating = draw_ratings(c, self.seed, self.device)
        self.U0, self.V0 = draw_factors(c, self.seed, self.device)
        inter = interactions_from_arrays(
            self.user, self.item, self.rating, np.zeros(len(self.user)),
            (f"u{i}" for i in range(c["n_users"])), (f"i{j}" for j in range(c["n_items"])))
        self.cfg = self._als_config()
        t0 = time.perf_counter()
        ub, ib, u_perm, i_perm = als._dense_shards_for(inter, self.cfg, 1)
        shards = range(1)
        self.u_shards = als._shard_inputs(ub, shards, self.ctx.local_devices, True)
        self.i_shards = als._shard_inputs(ib, shards, self.ctx.local_devices, True)
        harness.sync(self.device)
        self.setup_spans["als_bucketing_s"] = time.perf_counter() - t0
        U0 = als._initial_rows(self.cfg, self.U0, inter.n_users, inter.n_users, None)
        V0 = als._initial_rows(self.cfg, self.V0, inter.n_items, inter.n_items, None)
        # blocked row perm[e] holds original entity e, as train_als lays them out
        self.U0b, self.V0b = U0[np.argsort(u_perm)], V0[np.argsort(i_perm)]
        self.n_ratings = len(inter.user)
        self._run()  # warm-up: builds kernel 2 and runs every bucket's shape once

    def _run(self):
        from predictionio_tpu_torch.models import als

        return als._run_shards(self.ctx, self.u_shards, self.i_shards, self.U0b, self.V0b,
                               self.cfg, None, n_ratings=self.n_ratings)

    def _setup_bulk(self) -> None:
        from predictionio_tpu_torch.models.als import ALSScorer, als_model_from_arrays

        c = self.config
        self.U, self.V = draw_factors(c, self.seed, self.device)
        model = als_model_from_arrays(
            self.U, self.V, (f"u{i}" for i in range(c["n_users"])),
            (f"i{j}" for j in range(c["n_items"])), config=self._als_config())
        self.num, self.chunk = int(self.mix["num"]), int(self.mix["chunk"])
        self.scorer = ALSScorer(self.ctx, model, max_k=self.num)
        # the batch scorer recommend_batch builds on the card on first use,
        # built here on every device so a CPU run takes the same path
        self.scorer._batch_fastpath(self.num)
        self.users = np.arange(c["n_users"], dtype=np.int64)
        self.scorer.recommend_batch(self.users[:self.chunk], self.num)  # warm-up

    # -- the window --------------------------------------------------------------

    def begin_window(self) -> None:
        self.calls = self.chunks = self.scored = 0
        self.chunk_users: dict = {}
        self.pos = 0

    def _keep(self, i: int, item, size: int) -> None:
        """Keep a seeded uniform sample of ``size`` of the window's outputs
        (reservoir sampling), ``item`` being the ``i``-th."""
        if i < size:
            self.kept.append(item)
            return
        j = int(self._keep_rng.integers(0, i + 1))
        if j < size:
            self.kept[j] = item

    def unit(self) -> None:
        if self.mode == "iterate":
            out = self._run()
            if self.calls == 0:
                self.first = out
            self.last = out
            self._keep(self.calls, out, 1)
            self.calls += 1
            return
        users = self.users[self.pos:self.pos + self.chunk]
        self.pos = 0 if self.pos + self.chunk >= len(self.users) else self.pos + self.chunk
        idx, val = self.scorer.recommend_batch(users, self.num)
        self._keep(self.chunks, (users, idx, val), int(self.mix["check_chunks"]))
        self.chunks += 1
        self.scored += len(users)
        self.chunk_users[len(users)] = self.chunk_users.get(len(users), 0) + 1

    def counts(self) -> dict:
        if self.mode == "iterate":
            its = self.calls * self.cfg.iterations
            return {"calls": self.calls, "iterations": its,
                    "ratings_iterations": its * self.n_ratings, "attempted": self.calls}
        return {"chunks": self.chunks, "users": self.scored, "attempted": self.scored,
                "chunk_users": dict(self.chunk_users)}

    def shapes(self) -> dict:
        c = self.config
        out = {"n_users": c["n_users"], "n_items": c["n_items"], "rank": c["rank"]}
        if self.mode == "iterate":
            out.update(n_ratings=self.n_ratings, iterations_per_call=self.cfg.iterations)
        else:
            out.update(k=self.num, chunk=self.chunk)
        return out

    def kernels(self) -> dict:
        """label → (the kernel's device names, those of which it launches
        exactly one a call)."""
        if self.mode == "iterate":
            return {"kernel2": (("normal_eq_rows", "normal_eq_parts", "normal_eq_fold"),
                                ("normal_eq_rows", "normal_eq_parts"))}
        return {"kernel1": (("score_select",), ("score_select",))}

    def launch_counts(self) -> dict:
        """The program's own launch counters."""
        from predictionio_tpu_torch.ops import score_kernel, train_kernel

        if self.mode == "iterate":
            return {"kernel2": train_kernel.launches.count}
        return {"kernel1": score_kernel.launches.count}

    def probes(self):
        """A profiler range around the solve (``_solve_normal_equations``),
        which ``als_solve_ms`` reads; nothing in bulk mode."""
        from predictionio_tpu_torch.models import als

        if self.mode != "iterate":
            return contextlib.nullcontext()
        return harness.bracket_attr(als, "_solve_normal_equations",
                                    harness.profiler_range("solve"))

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        for name in ("u_shards", "i_shards", "scorer"):
            self.__dict__.pop(name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------------

    def check(self, limits: dict) -> dict:
        if self.mode == "iterate":
            return self._check_iterate(limits)
        return self._check_bulk(limits)

    def _check_iterate(self, limits: dict) -> dict:
        ref_U, ref_V = reference_factors(self.config, self.user, self.item, self.rating,
                                         self.U0, self.V0, self.device, "f64")
        u_perm = ref_als.degree_order(self.user, self.config["n_users"])
        i_perm = ref_als.degree_order(self.item, self.config["n_items"])
        worst = 0.0
        outs = [self.first, *self.kept, self.last]
        for Ub, Vb in outs:
            gaps = (compare.factor_gap(torch.from_numpy(Ub[u_perm]).to(self.device), ref_U),
                    compare.factor_gap(torch.from_numpy(Vb[i_perm]).to(self.device), ref_V))
            self.failed += int(not max(gaps) <= limits["factor_gap"])
            worst = max(worst, *gaps)
            self.details = {"factor_gap_users_items": list(gaps)}
        return {"factor_gap": worst}

    def _check_bulk(self, limits: dict) -> dict:
        U = torch.from_numpy(self.U).to(self.device)
        V = torch.from_numpy(self.V).to(self.device)
        rank_gap = value_gap = 0.0
        for users, idx, val in self.kept:
            ref = ref_topk.scores(U, V, torch.from_numpy(users).to(self.device), "f64")
            if len(idx) != len(users):
                r = v = compare.INF
            else:
                r, v = compare.topk_gaps(torch.from_numpy(np.asarray(idx)).to(self.device),
                                         torch.from_numpy(np.asarray(val)).to(self.device), ref)
            self.failed += int(not (r <= limits["rank_gap"] and v <= limits["value_gap"]))
            rank_gap, value_gap = max(rank_gap, r), max(value_gap, v)
        return {"rank_gap": rank_gap, "value_gap": value_gap}


def reference_factors(config, user, item, rating, U0, V0, device, precision):
    def dev(a, dt=None):
        t = torch.from_numpy(np.asarray(a)).to(device)
        return t if dt is None else t.to(dt)

    return ref_als.train(dev(user, torch.int64), dev(item, torch.int64), dev(rating), dev(U0),
                         dev(V0), config["lambda"], config["iterations"], precision)


def control(config: dict, mix: dict, seed: int, device, details: dict = None) -> dict:
    """The control: the reference in TF32 put in the program's place, its
    numbers against the float64 reference, over the cell's own inputs."""
    device = torch.device(device)
    if mix["mode"] == "iterate":
        user, item, rating = draw_ratings(config, seed, device)
        U0, V0 = draw_factors(config, seed, device)
        ref = reference_factors(config, user, item, rating, U0, V0, device, "f64")
        ctl = reference_factors(config, user, item, rating, U0, V0, device, "tf32")
        return {"factor_gap": max(compare.factor_gap(c, r) for c, r in zip(ctl, ref))}
    U, V = (torch.from_numpy(a).to(device) for a in draw_factors(config, seed, device))
    n_users, chunk, num = config["n_users"], int(mix["chunk"]), int(mix["num"])
    starts = np.random.default_rng(harness.seeds(seed, 3)[2]).choice(
        np.arange(0, n_users, chunk), size=min(int(mix["check_chunks"]), -(-n_users // chunk)),
        replace=False)
    rank_gap = value_gap = 0.0
    for s in np.sort(starts):
        users = torch.arange(s, min(s + chunk, n_users), device=device)
        idx, val = ref_topk.top_k(ref_topk.scores(U, V, users, "tf32"), num)
        r, v = compare.topk_gaps(idx, val, ref_topk.scores(U, V, users, "f64"))
        rank_gap, value_gap = max(rank_gap, r), max(value_gap, v)
    return {"rank_gap": rank_gap, "value_gap": value_gap}


# -- faults planted underneath the timed path, for the check's own test ---------


def faults(mode: str) -> dict:
    """name → a context manager that breaks the program underneath the
    window's call in one way a cell of ``mode`` can break."""
    from predictionio_tpu_torch.models import als
    from predictionio_tpu_torch.ops import train_kernel
    from predictionio_tpu_torch.serving import fastpath

    if mode == "iterate":
        def unchanged(run):
            return lambda ctx, u, i, U0, V0, *a, **k: (np.array(U0), np.array(V0))

        def half_ratings(kernel):
            def call(idx, rat, msk, *a, **k):
                msk = msk.clone()
                msk[:, msk.shape[1] // 2:] = 0  # half of each bucket's ratings left out
                return kernel(idx, rat, msk, *a, **k)
            return call

        def altered(run):
            def call(*a, **k):
                U, V = run(*a, **k)
                U = U.copy()
                U[0] += 1.0  # one entity's answer altered where it is produced
                return U, V
            return call

        return {"state_unchanged": lambda: harness.bracket_attr(als, "_run_shards", unchanged),
                "half_batch": lambda: harness.bracket_attr(train_kernel, "fused_train_normal_eq",
                                               half_ratings),
                "answer_altered": lambda: harness.bracket_attr(als, "_run_shards", altered)}

    def stale(score):
        first = {}

        def call(U, V, u_idx, *a, **k):
            if "out" not in first:  # every dispatch returns the first one's answer
                first["out"] = score(U, V, u_idx, *a, **k)
            return first["out"]
        return call

    def half_rows(score):
        def call(U, V, u_idx, *a, **k):
            half = u_idx.clone()
            half[len(half) // 2:] = half[:len(half) - len(half) // 2]
            return score(U, V, half, *a, **k)
        return call

    def altered_answer(score):
        def call(*a, **k):
            vals, idx = score(*a, **k)
            idx = idx.clone()
            idx[0, 0] = (idx[0, 0] + 1) % a[1].shape[0]
            return vals, idx
        return call

    def score(wrap):
        return lambda: harness.bracket_attr(fastpath, "gather_score_topk", wrap)

    return {"state_unchanged": score(stale), "half_batch": score(half_rows),
            "answer_altered": score(altered_answer)}
