"""Lock-discipline checker — ``MXNET_LOCKCHECK=1`` (counterpart of
``mxnet_tpu/analysis/lockcheck.py``).

The serving engine coordinates three hand-ordered mutexes
(``_cache_mu`` / ``_device_mu`` / ``_stats_mu``, ``serving/engine.py``) and
a set of containers each mutex owns.  This module makes that discipline
executable, three checks:

* **order**     — every :class:`CheckedLock` acquisition records the edge
  ``(already-held → acquiring)`` in a process-global order graph.  The
  first time both ``A→B`` and ``B→A`` exist the acquisition is flagged
  ``kind="inversion"`` (a potential deadlock, even if this run never
  interleaved badly — that is the point of checking observed order rather
  than waiting for the hang).
* **reentry**   — re-acquiring a non-reentrant lock the current thread
  already holds (``kind="reentry"``): a guaranteed self-deadlock.
* **ownership** — containers wrapped by :func:`guard` flag any mutating
  method called while the owning lock is NOT held by the calling thread
  (``kind="unguarded-mutation"``); :func:`instrument_fields` catches
  wholesale field *re-assignment* the same way (``self._warmup = {...}``
  outside ``_stats_mu``).

Reporting: every violation appends a ``Diagnostic`` to :func:`violations`
and — under pytest (``PYTEST_CURRENT_TEST`` set) — raises
:class:`LockDisciplineError` so a seeded violation fails the test that
provoked it.  Outside pytest it prints to stderr and continues: a
production canary under ``MXNET_LOCKCHECK=1`` should record, not crash.
The exceptions are **reentry** and **bad-release**, which raise
everywhere — continuing past a reentry blocks forever on the
non-reentrant lock, and honoring a stray release strips the real
holder's ownership.  (The JAX package also counts each violation in its
telemetry registry, ROADMAP.md A10.)

Off path: with the gate unset nothing here is imported by the engine —
the three mutexes stay plain ``threading.Lock`` objects and the
containers stay plain dicts/sets (tested).
"""
from __future__ import annotations

import os
import sys
import threading

from .diagnostics import Diagnostic, ERROR

__all__ = ["LockDisciplineError", "CheckedLock", "guard",
           "instrument_fields", "instrument_engine", "violations", "reset"]


class LockDisciplineError(AssertionError):
    """A lock-order / lock-ownership violation (raised only under pytest;
    recorded everywhere)."""


# process-global state: the order graph spans engines on purpose — two
# engine instances sharing a thread pool must still agree on lock order
_mu = threading.Lock()
_edges = {}        # before_name -> set(after_name): observed order graph
_violations = []   # [Diagnostic], append-only until reset()
_tls = threading.local()


def _held():
    st = getattr(_tls, "held", None)
    if st is None:
        st = _tls.held = []
    return st


def _report(kind, message, where=None, fatal=False):
    """Record + count one violation.  Raises under pytest, or when
    ``fatal`` — continuing past a reentry would block forever on the
    non-reentrant lock, so raising is strictly better than the deadlock
    the canary just diagnosed; every other kind records and continues."""
    d = Diagnostic("lock-" + kind, ERROR, message, where=where,
                   analyzer="lockcheck")
    with _mu:
        _violations.append(d)
    if fatal or "PYTEST_CURRENT_TEST" in os.environ:
        raise LockDisciplineError(str(d))
    print("lockcheck: %s" % d, file=sys.stderr)


def violations():
    """All violations recorded since process start (or :func:`reset`)."""
    with _mu:
        return list(_violations)


def reset():
    """Drop recorded violations AND the learned order graph (tests)."""
    with _mu:
        _violations.clear()
        _edges.clear()


def _path(src, dst):
    """Is ``dst`` reachable from ``src`` in the order graph (BFS over
    _edges)?  Returns the path as a name list, or None.  Caller holds _mu.
    Cycles of ANY length matter: A->B, B->C, C->A deadlocks three threads
    even though no direct reverse edge exists."""
    parents = {src: None}
    frontier = [src]
    while frontier:
        nxt = []
        for n in frontier:
            for m in _edges.get(n, ()):
                if m in parents:
                    continue
                parents[m] = n
                if m == dst:
                    out = [m]
                    while parents[out[-1]] is not None:
                        out.append(parents[out[-1]])
                    return out[::-1]
                nxt.append(m)
        frontier = nxt
    return None


class CheckedLock:
    """``threading.Lock`` drop-in that records per-thread acquisition order
    into the global graph and knows whether the *current* thread holds it
    (plain locks cannot answer that — the ownership checks need it)."""

    __slots__ = ("name", "_lock", "_owner")

    def __init__(self, name):
        self.name = str(name)
        self._lock = threading.Lock()
        self._owner = None  # ident of the holding thread, read racily is ok

    def held(self):
        """Does the CALLING thread hold this lock right now?"""
        return self._owner == threading.get_ident()

    def locked(self):
        return self._lock.locked()

    def acquire(self, blocking=True, timeout=-1):
        held = _held()
        if self.held():
            _report("reentry",
                    "thread %r re-acquires %s which it already holds — a "
                    "non-reentrant Lock self-deadlocks here"
                    % (threading.current_thread().name, self.name),
                    where=self.name, fatal=True)
        inverted = None
        # only unconditional blocking acquires enter the order graph —
        # trylock / timeout acquires cannot deadlock (the caller handles
        # failure), and recording them would poison the graph with edges
        # from deadlock-AVOIDANCE idioms (lockdep exempts trylocks too).
        # Recording happens BEFORE the acquire on purpose: the inversion
        # report must fire before the blocking call that would hang.
        if blocking and timeout == -1:
            with _mu:
                for prior in held:
                    succ = _edges.setdefault(prior.name, set())
                    if self.name in succ:
                        continue
                    # adding prior->self closes a cycle iff prior is
                    # already reachable FROM self — catches N-lock cycles
                    # (A->B, B->C, C->A), not just direct 2-lock reversals
                    cycle = _path(self.name, prior.name)
                    succ.add(self.name)
                    if cycle is not None and inverted is None:
                        inverted = (prior, cycle)
        if inverted is not None:
            prior, cycle = inverted
            _report("inversion",
                    "lock-order inversion: thread %r acquires %s while "
                    "holding %s, but the order %s was also observed — "
                    "threads interleaving these paths deadlock"
                    % (threading.current_thread().name, self.name,
                       prior.name, " -> ".join(cycle)),
                    where="%s<->%s" % (prior.name, self.name))
        ok = self._lock.acquire(blocking) if timeout == -1 \
            else self._lock.acquire(blocking, timeout)
        if ok:
            self._owner = threading.get_ident()
            held.append(self)
        return ok

    def release(self):
        if not self.held():
            # a cross-thread (or unmatched) release would silently strip
            # the real holder's ownership and misattribute the NEXT
            # guarded mutation — diagnose the stray release itself, and
            # refuse it so the holder's state stays truthful
            _report("bad-release",
                    "thread %r releases %s which it does not hold (owner: "
                    "thread ident %s) — a cross-thread or double release"
                    % (threading.current_thread().name, self.name,
                       self._owner), where=self.name, fatal=True)
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break
        self._owner = None
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return "CheckedLock(%s)" % self.name


# mutating methods across the container types the engine guards
# (dict / OrderedDict / set) — reads stay unchecked: the engine's
# documented discipline covers mutation, and e.g. stats() deliberately
# reads queue depth lock-free
_MUTATORS = frozenset({
    "update", "pop", "popitem", "clear", "setdefault",
    "add", "discard", "remove", "move_to_end",
    "append", "extend", "insert",
})


class _Guarded:
    """Container proxy checking the owning :class:`CheckedLock` on every
    mutating operation.  Delegates everything else; supports the mapping
    protocol (``dict(proxy)`` works via ``keys``/``__getitem__``)."""

    __slots__ = ("_obj", "_lock", "_name")

    def __init__(self, obj, lock, name):
        self._obj = obj
        self._lock = lock
        self._name = name

    def _check(self, op):
        if not self._lock.held():
            _report("unguarded-mutation",
                    "field %r mutated (%s) by thread %r without holding its "
                    "owning mutex %s"
                    % (self._name, op, threading.current_thread().name,
                       self._lock.name),
                    where="%s.%s" % (self._name, op))

    # -- mapping/sequence dunders (never reached via __getattr__) -----------
    def __getitem__(self, k):
        return self._obj[k]

    def __setitem__(self, k, v):
        self._check("__setitem__")
        self._obj[k] = v

    def __delitem__(self, k):
        self._check("__delitem__")
        del self._obj[k]

    def __contains__(self, k):
        return k in self._obj

    def __len__(self):
        return len(self._obj)

    def __iter__(self):
        return iter(self._obj)

    def __bool__(self):
        return bool(self._obj)

    def __repr__(self):
        return "Guarded(%s=%r)" % (self._name, self._obj)

    def __getattr__(self, attr):
        val = getattr(self._obj, attr)
        if attr in _MUTATORS:
            def checked(*a, **kw):
                self._check(attr)
                return val(*a, **kw)
            return checked
        return val


def guard(obj, lock, name):
    """Wrap a lock-owned container so unguarded mutation is a violation."""
    return _Guarded(obj, lock, name)


def instrument_fields(obj, owners):
    """Swap ``obj``'s class for a one-off subclass whose ``__setattr__``
    checks the owning lock for fields in ``owners`` (field name -> lock
    attribute name) — catching wholesale reassignment :func:`guard` cannot
    see.  ``isinstance(obj, OriginalClass)`` keeps holding."""
    owners = dict(owners)
    cls = obj.__class__

    def _setattr(self, name, value):
        lk_name = owners.get(name)
        if lk_name is not None:
            lk = self.__dict__.get(lk_name)
            if isinstance(lk, CheckedLock) and not lk.held():
                _report("unguarded-mutation",
                        "field %r reassigned by thread %r without holding "
                        "its owning mutex %s"
                        % (name, threading.current_thread().name, lk.name),
                        where=name)
        object.__setattr__(self, name, value)

    obj.__class__ = type("LockChecked" + cls.__name__, (cls,),
                         {"__setattr__": _setattr})
    return obj


def instrument_engine(engine):
    """Apply the full discipline to a serving ``Engine`` (called from its
    ``__init__`` under ``MXNET_LOCKCHECK=1``).  The ownership map is the one
    ``engine.py`` documents:

    ========== =========================================
    mutex      owns
    ========== =========================================
    _cache_mu  _cache, _direct_cache, _compiled
    _stats_mu  _stats, _bucket_stats, _warmup
    _device_mu device-exclusive sections (no container)
    ========== =========================================
    """
    pre = "%s." % getattr(engine, "name", "engine")
    engine._cache_mu = CheckedLock(pre + "_cache_mu")
    engine._device_mu = CheckedLock(pre + "_device_mu")
    engine._stats_mu = CheckedLock(pre + "_stats_mu")
    engine._cache = guard(engine._cache, engine._cache_mu, "_cache")
    engine._direct_cache = guard(engine._direct_cache, engine._cache_mu,
                                 "_direct_cache")
    engine._compiled = guard(engine._compiled, engine._cache_mu, "_compiled")
    engine._stats = guard(engine._stats, engine._stats_mu, "_stats")
    engine._bucket_stats = guard(engine._bucket_stats, engine._stats_mu,
                                 "_bucket_stats")
    # last: the subclass swap must not flag the guard() assignments above
    instrument_fields(engine, {"_warmup": "_stats_mu"})
    return engine
