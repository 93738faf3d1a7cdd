"""Model registry — precision-tier twins held as hot request classes
(counterpart of ``mxnet_tpu/serving/model_registry.py``).

The router's degradation ladder only works if the cheaper twin is ALREADY
hot when overload hits.  The registry front-loads that at registration:

* the checkpoint is loaded ONCE into a base fp32 :class:`Predictor`;
  every tier twin comes off it via ``Predictor.with_precision`` (shared
  weight tensors — N tiers cost ~1x the weights in device memory);
* ``"int8"`` twins calibrate from a **seed trace** (an iterable of
  ``{input name -> array}`` batches) through
  ``graph_passes.precision.calibrate`` when no explicit
  :class:`CalibrationTable` is passed — an int8 tier without either is
  refused at registration, because the uncalibrated rewrite quantizes
  nothing and would serve the fp32 plan under an int8 label;
* :meth:`RegisteredModel.build_engine` spins an Engine replica for any
  tier off the twin (``Engine(proto=...)`` respecialises over the shared
  weights).

The registry itself is passive bookkeeping: no threads, no env gates.
"""
from __future__ import annotations

import threading

from ..predictor import Predictor

__all__ = ["ModelRegistry", "RegisteredModel", "KNOWN_TIERS"]

# degradation order is REGISTRATION order, but each name must be a tier
# the precision passes know or the fp32 anchor
KNOWN_TIERS = ("fp32", "bf16", "int8")


class RegisteredModel:
    """One model's tier twins + the recipe to build Engine replicas.

    ``tiers`` is ordered: index 0 is the **native** tier (what paid
    traffic gets), later entries are progressively cheaper twins in
    degradation order.  Twins share the base predictor's weight tensors.
    Construct through :meth:`ModelRegistry.register`.
    """

    def __init__(self, name, sample_shapes, tiers, twins, calibration,
                 engine_kw):
        self.name = name
        self.sample_shapes = dict(sample_shapes)
        self.tiers = tuple(tiers)
        self._twins = dict(twins)           # tier -> Predictor
        self.calibration = calibration      # CalibrationTable or None
        self._engine_kw = dict(engine_kw)

    @property
    def native_tier(self):
        return self.tiers[0]

    def twin(self, tier):
        """The hot Predictor for one registered tier."""
        try:
            return self._twins[tier]
        except KeyError:
            raise KeyError("model %r has no tier %r (registered: %s)"
                           % (self.name, tier, list(self.tiers)))

    def build_engine(self, tier, name=None, slo_monitor=None, start=True,
                     **overrides):
        """One Engine replica serving ``tier``'s twin, respecialised off the
        shared-weight twin (``Engine(proto=...)``); registration-time
        engine kwargs (ladder, queue bounds, ...) apply unless overridden
        here."""
        from .engine import Engine

        kw = dict(self._engine_kw)
        kw.update(overrides)
        return Engine(None, None, self.sample_shapes,
                      name=name or "%s-%s" % (self.name, tier),
                      proto=self.twin(tier), slo_monitor=slo_monitor,
                      start=start, **kw)


class ModelRegistry:
    """Named models -> their tier-twin sets.  Thread-safe, passive."""

    def __init__(self):
        self._mu = threading.Lock()
        self._models = {}

    def register(self, name, symbol, params, sample_shapes,
                 tiers=("fp32", "bf16"), calibration=None, seed_trace=None,
                 dtype="float32", device=None, output_names=None, **engine_kw):
        """Load a checkpoint once and build its tier twins.

        Parameters
        ----------
        name : str
            Registry key (also the default engine-name prefix).
        symbol, params : as ``Predictor``.
        sample_shapes : dict
            name -> per-sample shape (no batch dim), as ``Engine``.
        tiers : sequence of str
            Degradation ladder, native first (default ``("fp32",
            "bf16")``).  Each must be in :data:`KNOWN_TIERS`.
        calibration : CalibrationTable, optional
            Explicit int8 calibration; wins over ``seed_trace``.
        seed_trace : iterable of dict, optional
            ``{input name -> array}`` batches fed through
            ``graph_passes.precision.calibrate`` on the fp32 base when an
            ``"int8"`` tier is requested without an explicit table.
        device : as ``Predictor`` (None is CUDA, raising without a card).
        **engine_kw :
            Defaults for every :meth:`RegisteredModel.build_engine` call
            (ladder, max_queue, max_wait_ms, ...).
        """
        tiers = tuple(tiers)
        if not tiers:
            raise ValueError("tiers must name at least the native tier")
        for t in tiers:
            if t not in KNOWN_TIERS:
                raise ValueError("unknown tier %r (known: %s)"
                                 % (t, list(KNOWN_TIERS)))
        if len(set(tiers)) != len(tiers):
            raise ValueError("duplicate tier in %s" % (tiers,))
        if "int8" in tiers and calibration is None and seed_trace is None:
            raise ValueError(
                "tier 'int8' needs calibration= or seed_trace=: the "
                "uncalibrated int8 rewrite quantizes nothing, so registering "
                "it would serve the fp32 plan under an int8 label")
        sample_shapes = {str(k): tuple(int(d) for d in v)
                         for k, v in sample_shapes.items()}
        # one checkpoint load: the fp32 base anchors every twin's weights
        # (batch dim 1 — twins are shape-respecialised per engine bucket,
        # and calibration's structural walk is shape-agnostic)
        base = Predictor(symbol, params,
                         {k: (1,) + v for k, v in sample_shapes.items()},
                         device=device, output_names=output_names, dtype=dtype)
        if "int8" in tiers and calibration is None:
            from ..graph_passes import precision

            calibration = precision.calibrate(base, seed_trace)
        twins = {t: base.with_precision(None if t == "fp32" else t,
                                        calibration if t == "int8" else None)
                 for t in tiers}
        model = RegisteredModel(name, sample_shapes, tiers, twins,
                                calibration, engine_kw)
        with self._mu:
            self._models[name] = model
        return model

    def get(self, name):
        with self._mu:
            try:
                return self._models[name]
            except KeyError:
                raise KeyError("model %r is not registered (have: %s)"
                               % (name, sorted(self._models)))

    def names(self):
        with self._mu:
            return sorted(self._models)

    def unregister(self, name):
        with self._mu:
            self._models.pop(name, None)
