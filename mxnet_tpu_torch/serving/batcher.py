"""Dynamic micro-batcher — requests in, shape-bucketed batches out
(counterpart of ``mxnet_tpu/serving/batcher.py``).

Concurrent callers enqueue single requests (each carrying 1..n samples);
ONE consumer — the Engine's device loop — pulls formed batches.  Batch
formation follows the standard dynamic-batching contract (Triton/TF-Serving
style):

* requests are grouped by **shape class** (their ladder-padded per-sample
  shapes) — only same-class requests share an executable;
* a batch flushes when it reaches the top bucket capacity, OR when the
  OLDEST member has waited ``max_wait_s`` (partial-batch flush — bounded
  queueing delay beats perfect fill); every shape class is scanned, so a
  ready class never idles behind another class's open flush window;
* cancelled / deadline-expired requests are dropped at formation time and
  never reach the device (an all-expired wave produces an *empty flush*:
  the consumer simply waits again — tested);
* oversize requests (more samples than the top bucket, or a sample shape no
  ladder bucket dominates) bypass grouping and dispatch alone
  (direct-dispatch path).

The batcher owns the lock + condition; admission policy is injected through
``put(..., admit=...)`` so the queue bound is exact under concurrency, and
drop accounting flows through the ``on_drop`` callback so the Engine can
count timeouts/cancellations without the batcher knowing its counters.
"""
from __future__ import annotations

import threading
import time

from .admission import EngineClosed, RequestCancelled, RequestTimeout
from .bucketing import Bucket

__all__ = ["Request", "MicroBatcher"]

_PENDING, _DONE, _CANCELLED = "pending", "done", "cancelled"

# bounded idle wait: an empty-queue consumer re-checks at least this often
# instead of blocking forever
_IDLE_WAKE_S = 0.25


class Request:
    """One in-flight inference request + its result future.

    ``inputs``: dict name -> array with a LEADING sample-count dim (n >= 1).
    The result (set by the device loop) is the list of per-output arrays
    sliced back to this request's n rows.
    """

    def __init__(self, inputs, n, bucket_shapes, deadline=None, direct=False):
        self.inputs = inputs
        self.n = int(n)
        self.bucket_shapes = bucket_shapes  # padded per-sample shapes (dict)
        # hashable shape-class key: only same-class requests share a batch
        self.class_key = tuple(sorted(
            (str(k), tuple(v)) for k, v in bucket_shapes.items()))
        self.deadline = deadline            # absolute monotonic, or None
        self.direct = bool(direct)
        self.t_enqueue = time.monotonic()
        self.t_done = None
        self._ev = threading.Event()
        self._mu = threading.Lock()
        self._state = _PENDING
        self._dispatched = False
        self._value = None
        self._error = None
        self._waker = None  # set by MicroBatcher.put; called on cancel

    # -- future surface ------------------------------------------------------
    def done(self):
        return self._ev.is_set()

    def cancel(self):
        """Cancel if not yet dispatched.  Returns True when the request will
        never run (the batcher drops it at formation); False when it is
        already (being) computed — the same RUNNING rule as
        ``concurrent.futures`` (``mark_dispatched`` and this method settle
        the race under the request lock, so True really means never-ran)."""
        with self._mu:
            if self._dispatched or self._ev.is_set():
                return False
            self._state = _CANCELLED
        # wake the batcher so the reap (RequestCancelled + queue-slot
        # release) happens NOW, not at the next flush deadline.  Called
        # outside self._mu: the batcher wake takes the condition lock, and
        # the consumer holds that lock while claiming requests (which takes
        # self._mu) — calling under both would be an ABBA deadlock.
        if self._waker is not None:
            self._waker()
        return True

    def mark_dispatched(self):
        """Batcher-side: claim the request for device execution.  False when
        a concurrent ``cancel`` won the race (the batcher then drops it)."""
        with self._mu:
            if self._state == _CANCELLED:
                return False
            self._dispatched = True
            return True

    def cancelled(self):
        with self._mu:
            return self._state == _CANCELLED

    def expired(self, now=None):
        return (self.deadline is not None
                and (now if now is not None else time.monotonic()) > self.deadline)

    def set_result(self, value):
        self._value = value
        self._state = _DONE
        self.t_done = time.monotonic()
        self._ev.set()

    def set_error(self, err):
        self._error = err
        self.t_done = time.monotonic()
        self._ev.set()

    def result(self, timeout=None):
        """Block for the outcome; raises the serving/model error on failure.

        An expired WAIT raises the builtin ``TimeoutError`` (the
        ``concurrent.futures`` convention), NOT ``RequestTimeout`` — the
        latter means the server dropped the request at its deadline, while
        an impatient wait says nothing about the request, which may still
        complete and be counted in ``Engine.stats()['completed']``."""
        if not self._ev.wait(timeout):
            raise TimeoutError("result not ready after %.3fs" % timeout)
        if self._error is not None:
            raise self._error
        return self._value

    @property
    def queue_seconds(self):
        return time.monotonic() - self.t_enqueue

    @property
    def latency_s(self):
        """Submit-to-completion latency (None while pending) — measured at
        the moment the result/error was SET, independent of when the caller
        harvests it (an open-loop load generator harvests late)."""
        return None if self.t_done is None else self.t_done - self.t_enqueue


class MicroBatcher:
    """Bounded FIFO of Requests + the batch-formation algorithm.  The idle
    wait is bounded by ``_IDLE_WAKE_S``; the wake itself is a no-op
    re-check."""

    def __init__(self, ladder, max_wait_s=0.005, on_drop=None):
        self.ladder = ladder
        self.max_wait_s = float(max_wait_s)
        self.on_drop = on_drop or (lambda req, reason: None)
        self._queue = []
        self._cond = threading.Condition()
        self._closed = False

    def depth(self):
        with self._cond:
            return len(self._queue)

    def put(self, req, admit=None):
        """Enqueue; ``admit(depth)`` runs under the lock and may raise to
        shed (exact bound — no admit/put race between submitter threads)."""
        with self._cond:
            if self._closed:
                raise EngineClosed("engine is closed")
            if not req.direct and req.n > self.ladder.max_batch:
                # formation can never service this (it only packs up to the
                # top bucket); admitting it would spin the consumer forever
                raise ValueError(
                    "request with %d samples exceeds the top bucket (%d); "
                    "mark it direct=True for the direct-dispatch path"
                    % (req.n, self.ladder.max_batch))
            if admit is not None:
                admit(len(self._queue))
            req._waker = self._notify
            self._queue.append(req)
            self._cond.notify_all()

    def _notify(self):
        with self._cond:
            self._cond.notify_all()

    def close(self):
        """Stop accepting work; wake the consumer.  Already-queued requests
        are failed with EngineClosed by the final next_batch() drain."""
        with self._cond:
            self._closed = True
            for req in self._queue:
                # account BEFORE set_error wakes the waiter: a caller that
                # unblocks from result() must see stats already updated
                self.on_drop(req, "closed")
                req.set_error(EngineClosed("engine closed with request queued"))
            self._queue.clear()
            self._cond.notify_all()

    # -- formation -----------------------------------------------------------
    def _reap(self):
        """Drop cancelled/expired requests (lock held).  The empty-flush
        case: a deadline wave can clear the whole queue here, and the
        consumer loop just goes back to waiting."""
        now = time.monotonic()
        keep = []
        for req in self._queue:
            # on_drop (stats) BEFORE set_error (waking the waiter), so a
            # caller unblocking from result() never reads a stale count
            if req.cancelled():
                self.on_drop(req, "cancelled")
                req.set_error(RequestCancelled("cancelled before dispatch"))
            elif req.expired(now):
                self.on_drop(req, "timeout")
                req.set_error(RequestTimeout(
                    "deadline expired after %.3fs in queue" % req.queue_seconds))
            else:
                keep.append(req)
        self._queue = keep

    def _next_wake(self, flush_at):
        """Earliest moment anything changes: the soonest flush deadline or
        any queued request's own deadline (so mid-queue timeouts fire on
        time even when the flush window is long)."""
        wake = flush_at
        for req in self._queue:
            if req.deadline is not None and req.deadline < wake:
                wake = req.deadline
        return wake

    def _formable(self, now):
        """Scan ALL shape classes (FIFO by each class's oldest member) for
        the first dispatchable group -> (take, bucket_shapes, direct,
        earliest_flush_at); ``take`` is None when nothing is ready before
        ``earliest_flush_at``.  Scanning every class — not just the head's —
        keeps a full or expired batch of class B from idling behind a young
        class-A head (no cross-class head-of-line blocking; lock held)."""
        groups, index = [], {}
        for req in self._queue:
            if req.direct:
                groups.append((req.class_key, [req], True))
            elif req.class_key in index:
                groups[index[req.class_key]][1].append(req)
            else:
                index[req.class_key] = len(groups)
                groups.append((req.class_key, [req], False))
        earliest = None
        for _, reqs, direct in groups:
            if direct:
                # oversize one-offs never benefit from waiting
                return reqs, reqs[0].bucket_shapes, True, None
            take, total = [], 0
            for r in reqs:
                if total + r.n <= self.ladder.max_batch:
                    take.append(r)
                    total += r.n
            flush_at = reqs[0].t_enqueue + self.max_wait_s
            if total >= self.ladder.max_batch or now >= flush_at \
                    or self._closed:
                return take, reqs[0].bucket_shapes, False, None
            if earliest is None or flush_at < earliest:
                earliest = flush_at
        return None, None, False, earliest

    def next_batch(self):
        """Block until a batch is ready -> (requests, bucket); None when the
        batcher is closed and drained.  Single consumer."""
        with self._cond:
            while True:
                self._reap()
                if not self._queue:
                    if self._closed:
                        return None
                    self._cond.wait(_IDLE_WAKE_S)
                    continue
                now = time.monotonic()
                take, shapes, direct, earliest = self._formable(now)
                if take is None:
                    self._cond.wait(max(0.0, self._next_wake(earliest) - now)
                                    + 1e-4)
                    continue
                batch = []
                for req in take:
                    self._queue.remove(req)
                    if self._claim(req):
                        batch.append(req)
                if not batch:
                    continue  # the whole take cancelled underneath us
                if direct:
                    (req,) = batch
                    return batch, Bucket(req.n, shapes, direct=True)
                return batch, self.ladder.bucket_for(
                    shapes, sum(r.n for r in batch))

    def _claim(self, req):
        """Transition a popped request to dispatched; a concurrently
        cancelled one is failed+counted here instead (lock held)."""
        if req.mark_dispatched():
            return True
        self.on_drop(req, "cancelled")
        req.set_error(RequestCancelled("cancelled before dispatch"))
        return False
