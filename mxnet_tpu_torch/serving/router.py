"""Serving router — degrade precision before shedding (counterpart of
``mxnet_tpu/serving/router.py``).

A :class:`Router` fronts per-tier pools of Engine replicas built from one
:class:`~mxnet_tpu_torch.serving.model_registry.RegisteredModel`
(precision-tier twins over shared weights), threads **priority classes**
(``paid``/``best_effort``) through admission, and runs a policy loop whose
FIRST overload response is rerouting best-effort traffic to the cheaper
twin and whose LAST resort is the bounded queues' own shedding:

* paid traffic keeps the native pool: degrading best-effort both serves
  it cheaper AND isolates the native queue for paid latency;
* every reply carries the tier that actually served it (``req.tier``,
  stamped by the engine reply path — the tier-label contract);
* downgrade/shed decisions are counted per priority (``stats()``).

The port's router has no SLO monitor (ROADMAP.md A10): the policy's only
signal is native-pool queue pressure, as the JAX router's with
``MXNET_SLO`` unset.  Construction is always explicit; the
``MXNET_ROUTER_*`` knobs are read once inside
``policy.config_from_env`` at router construction.
"""
from __future__ import annotations

import threading
import time

from .admission import EngineClosed, ServerBusy
from .engine import refuse_unported_gates
from .policy import DegradePolicy, PolicyConfig, config_from_env

__all__ = ["Router", "RouterRequest", "DEFAULT_PRIORITIES"]

DEFAULT_PRIORITIES = ("paid", "best_effort")

# policy-transition history kept for stats()["router"]["transitions"]
_TRANSITION_RING = 32


class RouterRequest:
    """Future returned by :meth:`Router.submit` — the engine
    :class:`~mxnet_tpu_torch.serving.batcher.Request` plus the routing
    facts: which priority the request carried, which tier/engine it was
    routed to, and (once completed) which tier actually served it."""

    __slots__ = ("_req", "priority", "routed_tier", "engine_name")

    def __init__(self, req, priority, routed_tier, engine_name):
        self._req = req
        self.priority = priority
        self.routed_tier = routed_tier
        self.engine_name = engine_name

    @property
    def tier(self):
        """The serving tier label (reply contract): stamped by the engine
        reply path at completion; until then, the routed tier."""
        return getattr(self._req, "tier", self.routed_tier)

    @property
    def n(self):
        return self._req.n

    @property
    def latency_s(self):
        return self._req.latency_s

    @property
    def t_done(self):
        return self._req.t_done

    def result(self, timeout=None):
        return self._req.result(timeout)

    def done(self):
        return self._req.done()

    def cancel(self):
        return self._req.cancel()


class Router:
    """Route requests across a registered model's tier-twin engine pools.

    Parameters
    ----------
    model : RegisteredModel
        The twin set (from :meth:`ModelRegistry.register`).  One Engine
        pool is built per registered tier; ``model.tiers[0]`` is the
        native tier, ``model.tiers[1]`` the degradation target.
    replicas : int or dict
        Engines per pool (a ``{tier: n}`` dict sizes pools separately).
    policy : PolicyConfig or str, optional
        Policy knobs, or just a mode name; default
        ``policy.config_from_env()`` (``MXNET_ROUTER_*``, read here once).
    priorities : sequence of str
        Known priority classes, most-protected first.  ``protected``
        priorities are never degraded.
    slo_monitor :
        Not ported (A10): anything but None raises.
    start : bool
        Start replica device loops + the policy loop (default).  With
        ``start=False`` call :meth:`start` later; :meth:`_policy_tick`
        can always be driven manually (tests).
    """

    def __init__(self, model, replicas=1, policy=None, name="router",
                 priorities=DEFAULT_PRIORITIES, protected=("paid",),
                 default_priority=None, slo_monitor=None, start=True):
        refuse_unported_gates("serving.Router", slo_monitor)
        if len(model.tiers) < 2:
            raise ValueError(
                "router needs a degradation target: register the model "
                "with at least two tiers (got %s)" % (model.tiers,))
        self.name = name
        self.model = model
        self.priorities = tuple(priorities)
        if not self.priorities:
            raise ValueError("need at least one priority class")
        self.default_priority = (default_priority
                                 if default_priority is not None
                                 else self.priorities[-1])
        if self.default_priority not in self.priorities:
            raise ValueError("default_priority %r not in priorities %s"
                             % (self.default_priority, self.priorities))
        if isinstance(policy, str):
            policy = config_from_env(mode=policy)
        elif policy is None:
            policy = config_from_env()
        elif not isinstance(policy, PolicyConfig):
            raise TypeError("policy must be a PolicyConfig or mode string")
        self._policy_cfg = policy
        self._policy = DegradePolicy(policy, self.priorities,
                                     protected=protected)
        self._native = model.native_tier
        self._degrade_tier = model.tiers[1]
        self._mu = threading.Lock()
        self._route = {p: self._native for p in self.priorities}
        self._counters = {p: {"requests": 0, "downgrades": 0, "sheds": 0}
                          for p in self.priorities}
        self._policy_counts = {"degrade": 0, "restore": 0}
        self._transitions = []
        self._last_signals = {}
        self._closed = False
        self._wake = threading.Event()
        self._thread = None
        # replica pools: tier -> [Engine], each over the twin's weights
        if isinstance(replicas, dict):
            counts = {t: int(replicas.get(t, 1)) for t in model.tiers}
        else:
            counts = {t: int(replicas) for t in model.tiers}
        self._pools = {}
        try:
            for tier in model.tiers:
                self._pools[tier] = [
                    model.build_engine(tier, name="%s-%s-%d" % (name, tier, i),
                                       start=start)
                    for i in range(max(1, counts[tier]))]
        except BaseException:
            for pool in self._pools.values():
                for eng in pool:
                    eng.close()
            raise
        if start:
            self.start()

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        """Start replica device loops and the policy loop (idempotent)."""
        if self._closed:
            raise EngineClosed("router is closed")
        for pool in self._pools.values():
            for eng in pool:
                eng.start()
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._policy_loop, name="mxnet-router-%s" % self.name,
                daemon=True)
            self._thread.start()
        return self

    def close(self):
        """Stop the policy loop and close every replica engine."""
        self._closed = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        for pool in self._pools.values():
            for eng in pool:
                eng.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def warmup(self):
        """Pre-build every pool's ladder -> ``{engine name: per-bucket
        report list}``."""
        return {eng.name: eng.warmup() for eng in self.engines()}

    def engines(self, tier=None):
        """Replica engines (one tier's pool, or all)."""
        if tier is not None:
            return list(self._pools[tier])
        return [e for t in self.model.tiers for e in self._pools[t]]

    # -- request path --------------------------------------------------------
    def submit(self, inputs, timeout=None, klass=None, priority=None):
        """Route one request; returns a :class:`RouterRequest`.

        ``priority`` picks the routing class (default
        ``default_priority``; a ``klass`` naming a known priority is used
        when ``priority`` is omitted, so callers may pass one string).
        ``klass`` labels the request and defaults to the priority.
        Raises ``ServerBusy`` when the routed pool's admission queue is
        full (the shed path — counted per priority).
        """
        if self._closed:
            raise EngineClosed("router is closed")
        prio = priority
        if prio is None and klass in self._route:
            prio = klass
        if prio is None or prio not in self._route:
            prio = self.default_priority
        if klass is None:
            klass = prio
        with self._mu:
            tier = self._route[prio]
            c = self._counters[prio]
            c["requests"] += 1
            if tier != self._native:
                c["downgrades"] += 1
        eng = self._pick(self._pools[tier])
        try:
            req = eng.submit(inputs, timeout=timeout, klass=klass)
        except ServerBusy:
            # the LAST resort fired: the routed pool's bounded queue is
            # full.  Count it against the priority so the ladder's
            # "degrade before shed" claim is auditable per class.
            with self._mu:
                self._counters[prio]["sheds"] += 1
            raise
        return RouterRequest(req, prio, tier, eng.name)

    def predict(self, inputs, timeout=None, klass=None, priority=None):
        """Synchronous convenience: submit + wait -> output arrays (the
        same contract as ``Engine.predict``)."""
        return self.submit(inputs, timeout=timeout, klass=klass,
                           priority=priority).result(None)

    @staticmethod
    def _pick(pool):
        """Least-loaded replica (queue depth; stable min, so equal-depth
        pools drain in replica order)."""
        if len(pool) == 1:
            return pool[0]
        return min(pool, key=lambda e: e._batcher.depth())

    # -- policy loop ---------------------------------------------------------
    def _signals(self):
        """The policy inputs: the burn rate (None: no SLO monitor in the
        port) + native-pool queue pressure."""
        pressure = 0.0
        for eng in self._pools[self._native]:
            cap = float(eng.admission.max_queue) or 1.0
            pressure = max(pressure, eng._batcher.depth() / cap)
        return {"burn": None, "pressure": round(pressure, 4)}

    def _policy_tick(self, now=None):
        """One policy evaluation (the loop's body; tests drive it with a
        synthetic clock) -> the applied transitions."""
        now = time.monotonic() if now is None else now
        signals = self._signals()
        actions = self._policy.step(signals, now)
        for action, prio in actions:
            tier = (self._degrade_tier if action == "degrade"
                    else self._native)
            with self._mu:
                self._route[prio] = tier
                self._policy_counts[action] += 1
                self._transitions.append({
                    "action": action, "priority": prio, "tier": tier,
                    "burn": signals["burn"],
                    "pressure": signals["pressure"],
                    "unix_ts": round(time.time(), 3)})
                del self._transitions[:-_TRANSITION_RING]
        self._last_signals = signals
        return actions

    def _policy_loop(self):
        interval = max(0.01, self._policy_cfg.interval_s)
        while not self._closed:
            self._wake.wait(interval)
            if self._closed:
                return
            try:
                self._policy_tick()
            except Exception:
                pass  # the policy loop must never die under the router

    # -- introspection -------------------------------------------------------
    def stats(self):
        """Engine-shaped stats (compiles, submitted, completed, shed) plus
        the ``router`` block; ``slo`` and ``quality`` read None, as the
        JAX router's with their gates off."""
        with self._mu:
            route = dict(self._route)
            counters = {p: dict(c) for p, c in self._counters.items()}
            policy_counts = dict(self._policy_counts)
            transitions = list(self._transitions)
        engines = {}
        compiles = submitted = completed = shed = 0
        for tier in self.model.tiers:
            for eng in self._pools[tier]:
                es = eng.stats()
                compiles += es["compiles"]
                submitted += es["submitted"]
                completed += es["completed"]
                shed += es["shed"]
                engines[eng.name] = {
                    "tier": tier, "queue_depth": es["queue_depth"],
                    "submitted": es["submitted"],
                    "completed": es["completed"], "shed": es["shed"],
                    "compiles": es["compiles"]}
        return {
            "submitted": submitted, "completed": completed, "shed": shed,
            "compiles": compiles,
            "requests": sum(c["requests"] for c in counters.values()),
            "downgrades": sum(c["downgrades"] for c in counters.values()),
            "sheds": sum(c["sheds"] for c in counters.values()),
            # the native tier: what un-degraded traffic is served under
            "precision_tier": self._native,
            "router": {
                "policy": self._policy.status(now=time.monotonic()),
                "native_tier": self._native,
                "degrade_tier": self._degrade_tier,
                "route": route,
                "priorities": counters,
                "transitions": transitions,
                "policy_counts": policy_counts,
                "signals": dict(self._last_signals),
                "replicas": {t: [e.name for e in self._pools[t]]
                             for t in self.model.tiers}},
            "engines": engines,
            "slo": None, "quality": None}
