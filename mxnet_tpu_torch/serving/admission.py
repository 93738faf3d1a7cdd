"""Admission control — bounded queueing, deadlines, graceful shedding
(counterpart of ``mxnet_tpu/serving/admission.py``).

A serving engine that accepts unbounded work converts overload into
unbounded latency and, eventually, OOM.  The controller enforces the
classic triad instead: a **bounded queue** (excess load is shed immediately
with a 503-style error, never buffered), **per-request deadlines** (a
request that cannot be answered in time is dropped from the queue, not run
late), and **typed errors** so callers can distinguish "retry elsewhere"
(``ServerBusy``) from "too slow" (``RequestTimeout``) from "you cancelled"
(``RequestCancelled``).  The model loop itself never sees any of this —
shed/expired requests are filtered before dispatch, so overload can degrade
answers but cannot crash or wedge the device thread.
"""
from __future__ import annotations

import time

from ..base import MXNetError

__all__ = ["ServingError", "ServerBusy", "RequestTimeout", "RequestCancelled",
           "EngineClosed", "AdmissionController"]


class ServingError(MXNetError):
    """Base class for serving-path errors; carries an HTTP-style ``code``
    so an HTTP front end can map it 1:1 onto a status line."""

    code = 500


class ServerBusy(ServingError):
    """Queue at capacity — the request was shed at the door (HTTP 503)."""

    code = 503


class RequestTimeout(ServingError):
    """Deadline expired before the request reached the device (HTTP 504)."""

    code = 504


class RequestCancelled(ServingError):
    """Caller cancelled before dispatch (nginx's 499 convention)."""

    code = 499


class EngineClosed(ServingError):
    """Engine shut down — pending and new requests fail fast (HTTP 503)."""

    code = 503


class AdmissionController:
    """Queue-depth gate + deadline policy.

    ``check(depth)`` runs under the batcher lock (the Engine passes it as
    the ``admit`` hook of ``MicroBatcher.put``), so the bound is exact even
    with many submitter threads.  Shed decisions are counted here:
    ``shed_total`` feeds ``Engine.stats()``.
    """

    def __init__(self, max_queue=256, default_timeout_s=None):
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1, got %r" % (max_queue,))
        self.max_queue = int(max_queue)
        self.default_timeout_s = default_timeout_s
        self.shed_total = 0

    def deadline(self, timeout_s=None):
        """Absolute monotonic deadline for a new request (None = no limit).
        An explicit per-call timeout wins over the engine default."""
        t = timeout_s if timeout_s is not None else self.default_timeout_s
        if t is None or t <= 0:
            return None
        return time.monotonic() + float(t)

    def check(self, depth):
        """Admit or shed a request given the current queue depth (the
        request being admitted is NOT yet counted in ``depth``)."""
        if depth >= self.max_queue:
            self.shed_total += 1
            raise ServerBusy(
                "serving queue full (%d queued, max_queue=%d) — request shed"
                % (depth, self.max_queue))
