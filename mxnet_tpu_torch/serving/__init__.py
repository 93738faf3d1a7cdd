"""mxnet_tpu_torch.serving — online inference over the port's Predictor
(counterpart of ``mxnet_tpu/serving``).

Concurrent requests are collected by a dynamic micro-batcher into padded
**shape buckets** (a finite ladder -> a finite set of bound plans, built
ahead of traffic by ``warmup``), an **admission controller** bounds the
queue and sheds overload with 503-style errors, and ONE device-loop thread
per engine runs the forwards.

    from mxnet_tpu_torch import serving
    eng = serving.Engine(symbol, params, sample_shapes={"data": (8,)},
                         ladder=serving.BucketLadder((1, 2, 4, 8)))
    eng.warmup()
    out = eng.predict({"data": x})        # x: (n, 8)

Above a single engine: a ``ModelRegistry`` holds a model's precision-tier
twins hot (shared weights, int8 seed-trace calibration), and a ``Router``
fronts per-tier replica pools with priority classes, degrading
best-effort traffic to the cheaper twin under queue pressure BEFORE any
shedding.

Entry points run on CUDA unless ``device="cpu"`` is passed.  Not ported:
the telemetry, tracing, SLO, flight-recorder, ops-server, quality and
cost planes (ROADMAP.md A10), the compile cache, the tuned ladder and the
bind-time precision tier (A9.2); an Engine or Router constructed under
one of their env gates raises NotImplementedError.
"""
from .admission import (AdmissionController, EngineClosed, RequestCancelled,
                        RequestTimeout, ServerBusy, ServingError)
from .batcher import MicroBatcher, Request
from .bucketing import Bucket, BucketLadder, pow2_ladder
from .engine import Engine
from .model_registry import ModelRegistry, RegisteredModel
from .policy import DegradePolicy, PolicyConfig
from .router import Router, RouterRequest
from .warmup import warmup_engine

__all__ = [
    "AdmissionController", "Bucket", "BucketLadder", "DegradePolicy",
    "Engine", "EngineClosed", "MicroBatcher", "ModelRegistry",
    "PolicyConfig", "RegisteredModel", "Request", "RequestCancelled",
    "RequestTimeout", "Router", "RouterRequest", "ServerBusy",
    "ServingError", "pow2_ladder", "warmup_engine",
]
