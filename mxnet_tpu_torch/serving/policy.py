"""Router degradation policy — spend fidelity before availability
(counterpart of ``mxnet_tpu/serving/policy.py``).

The decision ladder, in order of escalation:

1. **native** — every priority serves its native (registration) tier;
2. **degrade** — overload detected: degradable priorities (everything
   outside the protected set, i.e. ``best_effort``) are rerouted to the
   next cheaper twin.  Paid traffic keeps the native pool to itself;
3. **shed** — the true last resort, and it is not a policy action at all:
   each pool's bounded admission queue sheds its own overflow
   (``ServerBusy``), exactly as a bare Engine always has.

Overload is detected from two signals, either sufficient:

* an SLO monitor's windowed error-budget **burn rate** reaching
  ``burn_high`` on any objective.  The port has no SLO monitor yet
  (ROADMAP.md A10), so its router always passes ``burn`` None — the JAX
  router's behaviour with ``MXNET_SLO`` unset;
* native-pool **queue pressure** (depth / max_queue) reaching
  ``pressure`` — the fast path that reacts within one policy tick.

**Hysteresis on upgrade**: degradation clears only after the burn rate
has fallen to ``burn_low`` (or is unknown) AND pressure to half the
trigger level, continuously for ``hold_s`` — a flapping policy would
thrash the twins and make tier labels useless for debugging.

Two modes (``MXNET_ROUTER_POLICY``):

* ``"degrade"`` (default) — the ladder above;
* ``"shed"`` — the pre-twin baseline: every priority stays native and the
  class-blind bounded queue does all the shedding.

:class:`DegradePolicy` is pure decision logic — no threads, no clocks of
its own (``now`` is always passed in), so tests drive it synthetically.
The router owns the loop.  Env knobs are read once at construction
(constructor args win), never on the request path.
"""
from __future__ import annotations

import os

__all__ = ["PolicyConfig", "DegradePolicy", "POLICY_MODES",
           "config_from_env"]

POLICY_MODES = ("degrade", "shed")


def _env_float(name, default):
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return float(default)


class PolicyConfig:
    """Knobs for one policy instance (``MXNET_ROUTER_*``)."""

    __slots__ = ("mode", "burn_high", "burn_low", "hold_s", "interval_s",
                 "pressure")

    def __init__(self, mode="degrade", burn_high=1.0, burn_low=0.5,
                 hold_s=5.0, interval_s=0.25, pressure=0.5):
        if mode not in POLICY_MODES:
            raise ValueError("policy mode %r not in %s"
                             % (mode, list(POLICY_MODES)))
        if not 0.0 < burn_low <= burn_high:
            raise ValueError("need 0 < burn_low <= burn_high, got %g/%g"
                             % (burn_low, burn_high))
        self.mode = mode
        self.burn_high = float(burn_high)
        self.burn_low = float(burn_low)
        self.hold_s = float(hold_s)
        self.interval_s = float(interval_s)
        self.pressure = float(pressure)


def config_from_env(mode=None):
    """PolicyConfig from ``MXNET_ROUTER_*`` (read HERE, at construction —
    a deployment with no router constructs no config and reads nothing).
    Malformed numbers fall back to defaults, an unknown mode falls back
    to ``"degrade"`` — the ``_env_ladder`` never-crash contract."""
    if mode is None:
        mode = (os.environ.get("MXNET_ROUTER_POLICY", "") or
                "degrade").strip().lower()
    if mode not in POLICY_MODES:
        mode = "degrade"
    return PolicyConfig(
        mode=mode,
        burn_high=_env_float("MXNET_ROUTER_BURN_HIGH", 1.0),
        burn_low=min(_env_float("MXNET_ROUTER_BURN_LOW", 0.5),
                     _env_float("MXNET_ROUTER_BURN_HIGH", 1.0)),
        hold_s=_env_float("MXNET_ROUTER_HOLD_S", 5.0),
        interval_s=_env_float("MXNET_ROUTER_INTERVAL_S", 0.25),
        pressure=_env_float("MXNET_ROUTER_PRESSURE", 0.5))


class DegradePolicy:
    """Degrade-first decision state machine (pure logic, router-driven).

    ``step(signals, now)`` -> list of ``(action, priority)`` transitions,
    where action is ``"degrade"`` or ``"restore"``.  ``signals`` is a
    dict with ``"burn"`` (max windowed burn rate across objectives, None
    when unknown) and ``"pressure"`` (native-pool depth/max_queue in
    [0, 1]).
    """

    def __init__(self, config, priorities, protected=("paid",)):
        self.config = config
        self.protected = tuple(p for p in priorities if p in protected)
        self.degradable = tuple(p for p in priorities
                                if p not in protected)
        self.degraded = {}       # priority -> monotonic degrade time
        self._clear_since = None  # start of the current calm stretch
        self.last_signals = {}

    def overloaded(self, signals):
        """Trigger condition (burn OR pressure at the high mark)."""
        burn = signals.get("burn")
        if burn is not None and burn >= self.config.burn_high:
            return True
        pressure = signals.get("pressure") or 0.0
        return (self.config.pressure > 0
                and pressure >= self.config.pressure)

    def _calm(self, signals):
        """Restore condition — stricter than ``not overloaded()`` (the
        hysteresis band): burn at/below burn_low (or unknown) AND
        pressure below half the trigger level."""
        burn = signals.get("burn")
        if burn is not None and burn > self.config.burn_low:
            return False
        pressure = signals.get("pressure") or 0.0
        return pressure < self.config.pressure / 2.0

    def step(self, signals, now):
        self.last_signals = dict(signals)
        actions = []
        if self.config.mode != "degrade":
            return actions  # "shed": admission does everything, class-blind
        if self.overloaded(signals):
            self._clear_since = None
            for p in self.degradable:
                if p not in self.degraded:
                    self.degraded[p] = now
                    actions.append(("degrade", p))
        elif self.degraded:
            if not self._calm(signals):
                # inside the hysteresis band (neither overloaded nor calm):
                # hold the current level and reset the calm clock
                self._clear_since = None
            elif self._clear_since is None:
                self._clear_since = now
            elif now - self._clear_since >= self.config.hold_s:
                for p in sorted(self.degraded):
                    del self.degraded[p]
                    actions.append(("restore", p))
                self._clear_since = None
        else:
            self._clear_since = None
        return actions

    def status(self, now=None):
        """The ``stats()["router"]["policy"]`` block."""
        out = {"mode": self.config.mode,
               "burn_high": self.config.burn_high,
               "burn_low": self.config.burn_low,
               "hold_s": self.config.hold_s,
               "pressure": self.config.pressure,
               "signals": dict(self.last_signals),
               "degraded": sorted(self.degraded)}
        if now is not None and self.degraded:
            out["degraded_for_s"] = {
                p: round(max(0.0, now - t), 3)
                for p, t in self.degraded.items()}
        return out
