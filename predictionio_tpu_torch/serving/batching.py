"""Request micro-batching: coalesce concurrent queries into one device pass.

Copy of ``predictionio_tpu/serving/batching.py`` ``MicroBatcher``, without
its tracing hooks and without single-flight coalescing (``submit(key=)``),
which returns with the result-cache slice.

Handlers enqueue a query and block; a worker drains the queue, coalesces a
batch, routes it through ``Algorithm.batch_predict`` (which ALS vectorizes
into one kernel launch) and wakes each handler with its result. Errors are
delivered per request. The accumulation window is ADAPTIVE:

* TRICKLE BYPASS: a request arriving to an empty queue with no run in
  flight executes inline on its own handler thread — zero added latency.
  Batches form exactly when they can help: while a run is in flight,
  arrivals queue up and dispatch together.
* The wait budget is ``min(window_ms, EWMA(batch run time))``: a request
  is only worth delaying by about the cost of one extra device pass.
* Within the budget the worker stops as soon as the arrival stream goes
  quiet (``EWMA(inter-arrival gap) × GAP_MULT`` past the last arrival).
* Dispatch drains to a BUCKET BOUNDARY of the fast path's rung ladder
  (``serving/fastpath.py``): a 9-deep queue dispatches 8 + carries 1
  instead of padding 9→16, and the carried tail leads the next batch.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from predictionio_tpu_torch.common.resilience import Deadline, DeadlineExceeded

logger = logging.getLogger(__name__)

# default ladder mirrors serving/fastpath.BUCKETS
_DEFAULT_BUCKETS = (1, 8, 16, 32, 64)


@dataclass
class _Pending:
    query: Any
    deadline: Optional[Deadline] = None
    event: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None


class MicroBatcher:
    # dispatch when the stream has been quiet for GAP_MULT × the EWMA
    # inter-arrival gap (the burst is over; waiting longer is pure latency)
    GAP_MULT = 2.0
    # EWMA smoothing for both the gap and run-time estimators
    ALPHA = 0.2

    def __init__(
        self,
        run_batch: Callable[[list], list],
        max_batch: int = 64,
        window_ms: float = 2.0,
        buckets=_DEFAULT_BUCKETS,
    ):
        self._run_batch = run_batch
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        self.buckets = tuple(
            sorted({b for b in buckets if b <= max_batch} | {max_batch})
        )
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._carry: collections.deque[_Pending] = collections.deque()
        self._stop = threading.Event()
        # arrival-side estimator state
        self._arr_lock = threading.Lock()
        self._last_arrival: Optional[float] = None
        self._ewma_gap = self.window_s  # pessimistic until traffic teaches it
        # worth-waiting budget: ~one batch run; 0 until the first run returns
        self._ewma_run = 0.0
        # held for the duration of every batch run (worker or inline)
        self._busy = threading.Lock()
        # counters (read by stats())
        self._stats_lock = threading.Lock()
        self._n_batches = 0
        self._n_queries = 0
        self._n_inline = 0
        self._n_expired = 0  # pendings dropped un-executed (deadline lapsed)
        self._size_hist: collections.Counter = collections.Counter()
        self._wait_s_total = 0.0
        self._worker = threading.Thread(
            target=self._loop, name="query-microbatcher", daemon=True
        )
        self._worker.start()

    def submit(
        self,
        query: Any,
        timeout: float = 30.0,
        deadline: Optional[Deadline] = None,
    ) -> Any:
        """Enqueue one query; block until its batch runs or the deadline
        passes.

        The effective deadline is ``min(request deadline, now + timeout)``
        and travels WITH the pending: a request whose deadline lapses while
        queued is dropped at dispatch (never executed on the device) and
        its waiter gets :class:`DeadlineExceeded`.
        """
        now = time.perf_counter()
        with self._arr_lock:
            if self._last_arrival is not None:
                # clamp: one window of silence already means "quiet"
                gap = min(now - self._last_arrival, self.window_s)
                self._ewma_gap += self.ALPHA * (gap - self._ewma_gap)
            self._last_arrival = now
        eff = Deadline.min(deadline, Deadline.after_ms(timeout * 1e3))
        p = _Pending(query, deadline=eff)
        if eff.expired():
            with self._stats_lock:
                self._n_expired += 1
            raise DeadlineExceeded("query deadline expired before dispatch")
        # TRICKLE BYPASS: nothing queued and no run in flight — execute the
        # singleton inline on this handler thread
        if (
            self._queue.empty()
            and not self._carry
            and self._busy.acquire(blocking=False)
        ):
            try:
                self._execute([p], waited=0.0, inline=True)
            finally:
                self._busy.release()
            if p.error is not None:
                raise p.error
            return p.result
        self._queue.put(p)
        if not p.event.wait(eff.remaining_s()):
            # the pending stays queued, but its deadline has passed — the
            # worker is GUARANTEED to drop it at dispatch (same clock)
            raise DeadlineExceeded("batched query timed out")
        if p.error is not None:
            raise p.error
        return p.result

    @contextlib.contextmanager
    def held(self):
        """Hold dispatch while the block runs: arriving queries queue up
        (none runs inline) and leave as rung-sized batches when the hold
        ends — how a load generator forms a burst into full batches."""
        with self._busy:
            yield

    def stop(self) -> None:
        self._stop.set()
        self._worker.join(timeout=5)
        # wake anything still queued so handlers fail fast, not on timeout
        pending = list(self._carry)
        self._carry.clear()
        while True:
            try:
                pending.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for p in pending:
            p.error = RuntimeError("server shutting down")
            p.event.set()

    def depth(self) -> int:
        """Queued + carried pendings (admission-control signal)."""
        return self._queue.qsize() + len(self._carry)

    def stats(self) -> dict:
        """Per-batch latency/size/occupancy counters (``GET /`` stats)."""
        with self._stats_lock:
            n_b, n_q = self._n_batches, self._n_queries
            return {
                "batches": n_b,
                "queries": n_q,
                "inline_batches": self._n_inline,
                "expired_dropped": self._n_expired,
                "depth": self.depth(),
                "avg_batch": round(n_q / n_b, 3) if n_b else None,
                "batch_sizes": {str(k): v for k, v in sorted(self._size_hist.items())},
                "avg_window_wait_ms": round(self._wait_s_total / n_b * 1e3, 4)
                if n_b
                else None,
                "ewma_gap_ms": round(self._ewma_gap * 1e3, 4),
                "ewma_run_ms": round(self._ewma_run * 1e3, 4),
            }

    # -- worker -------------------------------------------------------------
    def _next(self, timeout: Optional[float]) -> Optional[_Pending]:
        """Carried tail first (FIFO), then the live queue."""
        if self._carry:
            return self._carry.popleft()
        try:
            if timeout is None or timeout <= 0:
                return self._queue.get_nowait()
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def _boundary(self, n: int) -> int:
        """Largest ladder rung ≤ n (ladder always contains 1)."""
        best = self.buckets[0]
        for b in self.buckets:
            if b <= n:
                best = b
        return best

    def _loop(self) -> None:
        while not self._stop.is_set():
            first = self._next(timeout=0.1)
            if first is None:
                continue
            t_first = time.perf_counter()
            last_arrival = t_first
            batch = [first]
            # budget: delaying a request more than one device pass costs
            # more latency than the coalescing saves
            budget = min(self.window_s, self._ewma_run)
            deadline = t_first + budget
            while len(batch) < self.max_batch:
                now = time.perf_counter()
                # stop early once the arrival stream has gone quiet
                quiet_cut = last_arrival + self._ewma_gap * self.GAP_MULT
                wait = min(deadline, quiet_cut) - now
                if wait <= 0:
                    break
                nxt = self._next(timeout=wait)
                if nxt is None:
                    break
                batch.append(nxt)
                last_arrival = time.perf_counter()
            # serialize with any inline run, THEN drain: everything that
            # arrived while the previous run was in flight coalesces here
            with self._busy:
                while len(batch) < self.max_batch:
                    nxt = self._next(timeout=None)
                    if nxt is None:
                        break
                    batch.append(nxt)
                # cut to a rung boundary; the tail leads the next batch
                size = self._boundary(len(batch))
                self._carry.extendleft(reversed(batch[size:]))
                batch = batch[:size]
                waited = time.perf_counter() - t_first
                self._execute(batch, waited)

    def _execute(self, batch: list, waited: float, inline: bool = False) -> None:
        """Run one batch and deliver results/errors to every waiter.

        Expired pendings are dropped HERE, at dispatch: their waiters have
        already raised, so running them would spend a device pass on a
        result nobody reads.
        """
        live = []
        for p in batch:
            if p.deadline is not None and p.deadline.expired():
                p.error = DeadlineExceeded("query deadline expired in queue")
                p.event.set()
                with self._stats_lock:
                    self._n_expired += 1
            else:
                live.append(p)
        batch = live
        if not batch:
            return
        t_run = time.perf_counter()
        results: Optional[list] = None
        run_error: Optional[BaseException] = None
        try:
            results = self._run_batch([p.query for p in batch])
            if len(results) != len(batch):
                raise RuntimeError(
                    f"batch_predict returned {len(results)} results for "
                    f"{len(batch)} queries"
                )
        except Exception as e:  # propagate to EVERY waiter
            run_error = e
        run_dt = time.perf_counter() - t_run
        with self._arr_lock:
            self._ewma_run += self.ALPHA * (run_dt - self._ewma_run)
        for i, p in enumerate(batch):
            if run_error is not None:
                p.error = run_error
            else:
                p.result = results[i]
            p.event.set()
        with self._stats_lock:
            self._n_batches += 1
            self._n_queries += len(batch)
            self._size_hist[len(batch)] += 1
            self._wait_s_total += waited
            if inline:
                self._n_inline += 1
