"""Precision-flow analyzer and the cast-plan contract (counterpart of
``mxnet_tpu/analysis/numerics.py``, whose verdict policy, interval transfer
functions, diagnostics and versions it keeps, so that the port's cast
plans and fingerprints equal the JAX package's on the same symbol).

An abstract interpretation over the plan IR that

1. propagates dtypes through every node (the shared ``_abstract_walk`` on
   meta tensors, the same ``node_call_attrs`` the executor uses) and flags
   silent downcasts, mixed-dtype promotions, float64 creep from its
   origin, and low-precision accumulation;
2. runs an interval analysis seeded from known producer ranges (sigmoid and
   softmax in [0, 1], normalised activations, tanh in [-1, 1], baked
   constants' actual min / max), so exp / log-family ops are judged by the
   range that reaches them;
3. classifies each op by the sensitivity registry
   (``graph_passes.ir.op_sensitivity``) and gives each node a verdict::

       bf16_safe    the node may compute entirely in bf16;
       fp32_accum   bf16 inputs are fine, the accumulator stays fp32;
       fp32_only    the node stays fp32 end to end.

The verdicts ship as a :class:`CastPlan`, the artifact the precision tiers
consume.  Verdicts and fingerprints are computed from shapes, dtype names
and attributes only: nothing runs on a device.
"""
from __future__ import annotations

import hashlib
import json
import math

import torch

from ..graph_passes.ir import (CANCELLATION, EXP_RANGE, NEUTRAL, REDUCE,
                               SENSITIVITY_VERSION, node_attr,
                               op_sensitivity)
from . import register_analyzer
from .diagnostics import Diagnostic, WARNING

__all__ = ["numerics", "precision_plan", "CastPlan", "NUMERICS_VERSION",
           "contract_fingerprint", "param_verdict_classes",
           "BF16_SAFE", "FP32_ACCUM", "FP32_ONLY"]

# Bump on any change to verdict policy, diagnostics, or interval transfer
# functions: it enters every CastPlan fingerprint and contract_fingerprint
# (kept equal to the JAX package's, whose fingerprints the port's match).
NUMERICS_VERSION = 1

BF16_SAFE = "bf16_safe"
FP32_ACCUM = "fp32_accum"
FP32_ONLY = "fp32_only"

_INF = float("inf")
UNKNOWN = (-_INF, _INF)
_UNIT = (0.0, 1.0)
_SYM1 = (-1.0, 1.0)
# "BN-normalized activations" producer range: post-norm values are O(1);
# eight sigmas is generous enough to stay sound for any sane gamma/beta
# while still bounding downstream exp/log ops away from fp32_only
_NORMED = (-8.0, 8.0)

# |x| bound inside which exp-family ops tolerate bf16 input quantization:
# the relative output error of exp under input rounding is ~|x| * 2^-8,
# ~4% at x=10 — acceptable for inference twins; past it, fp32_only
_EXP_SAFE = 10.0
# log amplifies input error by 1/x near zero: below 2^-8 a one-ulp bf16
# input wiggle moves the output by more than bf16 can even represent
_LOG_SAFE_LO = 2.0 ** -8

_LOG_LIKE = frozenset({"log", "log1p", "log2", "log10", "gammaln", "gamma",
                       "_linalg_sumlogdiag"})
# shift-invariant exp family: softmax subtracts the row max internally, so
# the hazard is the input SPREAD, not its magnitude
_SHIFT_INVARIANT = frozenset({"softmax", "log_softmax", "softmin",
                              "SoftmaxActivation", "SoftmaxOutput"})
# two-input power (x**y = exp(y*ln x)): the output range depends on the
# JOINT base/exponent ranges (base near 0 with a negative exponent blows
# up inside intervals that look tame separately), so no per-input band
# test certifies it — never bf16_safe statically
_JOINT_POWER = frozenset({"_power", "broadcast_power"})

# float dtype widths by name — numpy calls bfloat16 kind "V", so
# issubdtype is useless here; unlisted names fall back to kind "f"
_FLOAT_BITS = {"float64": 64, "float32": 32, "float16": 16, "bfloat16": 16,
               "float8_e4m3fn": 8, "float8_e5m2": 8, "float8_e4m3": 8,
               "float8_e5m2fnuz": 8, "float8_e4m3fnuz": 8}

# REDUCE/CANCELLATION ops whose products the matrix units accumulate in fp32
# whatever the input dtype (dot/conv contractions; on the card cuBLAS and
# cuDNN under ``context.full_fp32``): their verdict is still fp32_accum (the
# contract the cast pass must preserve), but a bf16 input is NOT diagnosed
# as low-precision-accum.  sum/mean/var-style reductions accumulate in the
# input dtype and DO get the diagnostic.  The name is the JAX package's.
_MXU_ACCUM = frozenset({"dot", "batch_dot", "FullyConnected", "Convolution",
                        "Deconvolution", "Correlation", "_linalg_gemm",
                        "_linalg_gemm2", "_linalg_syrk", "khatri_rao"})

# CANCELLATION-class norm ops deliberately mix precisions (fp32 moving
# stats against bf16 activations is the documented deployment norm, and
# e.g. LayerNorm upcasts to f32 internally) — exempt from the mixed-dtype
# and silent-downcast DIAGNOSTICS; their fp32_accum verdict still stands.
# "_fp32_island" (the bf16 tier's reduction wrapper) manages precision BY
# CONSTRUCTION — upcast in, fp32 accumulate, re-narrow out — and
# "_precision_cast" is the tier's explicit region-boundary convert.
# Neither exemption changes a diagnostic on a plan with no tier-made node.
_PRECISION_MANAGED = frozenset({"BatchNorm", "LayerNorm", "InstanceNorm",
                                "_bn_affine", "LRN", "L2Normalization",
                                "_fp32_island"})
_EXPLICIT_CASTS = frozenset({"cast", "Cast", "amp_cast", "amp_multicast",
                             "_precision_cast"})


def _dtype_name(dtype):
    """numpy's name of a dtype ("float32", "bfloat16"), for a torch dtype
    too: the name the JAX package's cast-plan rows carry."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return getattr(dtype, "name", None) or str(dtype)


def _float_bits(dtype):
    """Bit width of a float dtype, or None for non-floats."""
    bits = _FLOAT_BITS.get(_dtype_name(dtype))
    if bits is None and isinstance(dtype, torch.dtype) and dtype.is_floating_point:
        bits = dtype.itemsize * 8
    return bits


def _is_lowp(dtype):
    bits = _float_bits(dtype)
    return bits is not None and bits <= 16


# -- interval transfer functions ---------------------------------------------

def _widest(ivals):
    if not ivals:
        return UNKNOWN
    return (min(lo for lo, _ in ivals), max(hi for _, hi in ivals))


def _first(ivals):
    return ivals[0] if ivals else UNKNOWN


def _mul_iv(a, b):
    prods = []
    for x in a:
        for y in b:
            # inf * 0 is nan; the sound interval endpoint for it is 0
            prods.append(0.0 if (x == 0.0 or y == 0.0) else x * y)
    return (min(prods), max(prods))


def _passthrough(node, iv):
    return _first(iv)


def _relu_iv(node, iv):
    lo, hi = _first(iv)
    return (max(lo, 0.0), max(hi, 0.0))


def _activation_iv(node, iv):
    act = node_attr(node, "act_type")
    if act == "sigmoid":
        return _UNIT
    if act in ("tanh", "softsign"):
        return _SYM1
    if act == "relu":
        return _relu_iv(node, iv)
    if act == "softrelu":
        lo, hi = _first(iv)
        return (0.0, _INF if not math.isfinite(hi) else math.log1p(
            math.exp(min(hi, 700.0))))
    return UNKNOWN


def _clip_iv(node, iv):
    lo, hi = _first(iv)
    a_min = node_attr(node, "a_min")
    a_max = node_attr(node, "a_max")
    if a_min is not None:
        lo = max(lo, float(a_min))
        hi = max(hi, float(a_min))
    if a_max is not None:
        lo = min(lo, float(a_max))
        hi = min(hi, float(a_max))
    return (lo, hi)


def _exp_iv(node, iv):
    lo, hi = _first(iv)
    return (math.exp(min(lo, 700.0)) if math.isfinite(lo) else 0.0,
            math.exp(min(hi, 700.0)) if math.isfinite(hi) else _INF)


def _log_iv(node, iv):
    lo, hi = _first(iv)
    return (math.log(lo) if lo > 0 else -_INF,
            (math.log(hi) if hi > 0 else -_INF) if math.isfinite(hi)
            else _INF)


def _square_iv(node, iv):
    lo, hi = _first(iv)
    m = max(abs(lo), abs(hi))
    return (0.0 if lo <= 0.0 <= hi else min(lo * lo, hi * hi),
            m * m if math.isfinite(m) else _INF)


def _sqrt_iv(node, iv):
    lo, hi = _first(iv)
    return (math.sqrt(max(lo, 0.0)) if math.isfinite(lo) else 0.0,
            math.sqrt(max(hi, 0.0)) if math.isfinite(hi) else _INF)


def _add_iv(node, iv):
    (a, b), (c, d) = (iv + [UNKNOWN, UNKNOWN])[:2]
    return (a + c, b + d)


def _sub_iv(node, iv):
    (a, b), (c, d) = (iv + [UNKNOWN, UNKNOWN])[:2]
    return (a - d, b - c)


def _binmul_iv(node, iv):
    (a, b), (c, d) = (iv + [UNKNOWN, UNKNOWN])[:2]
    return _mul_iv((a, b), (c, d))


def _maximum_iv(node, iv):
    (a, b), (c, d) = (iv + [UNKNOWN, UNKNOWN])[:2]
    return (max(a, c), max(b, d))


def _minimum_iv(node, iv):
    (a, b), (c, d) = (iv + [UNKNOWN, UNKNOWN])[:2]
    return (min(a, c), min(b, d))


def _scalar_iv(fn):
    def tf(node, iv):
        s = node_attr(node, "scalar")
        if s is None:
            return UNKNOWN
        return fn(_first(iv), float(s))
    return tf


def _dropout_iv(node, iv):
    # train mode rescales kept units by 1/(1-p); eval is the identity.
    # The union of both covers either mode, keeping the transfer mode-free.
    lo, hi = _first(iv)
    try:
        scale = 1.0 / max(1.0 - float(node_attr(node, "p", 0.5)), 1e-6)
    except (TypeError, ValueError):
        return UNKNOWN
    slo, shi = _mul_iv((lo, hi), (scale, scale))
    return (min(lo, slo), max(hi, shi))


_CONST_RANGE = {
    "sigmoid": _UNIT, "hard_sigmoid": _UNIT, "softmax": _UNIT,
    "softmin": _UNIT, "SoftmaxActivation": _UNIT, "SoftmaxOutput": _UNIT,
    "tanh": _SYM1, "softsign": _SYM1, "erf": _SYM1, "sin": _SYM1,
    "cos": _SYM1, "L2Normalization": _SYM1,
    "BatchNorm": _NORMED, "LayerNorm": _NORMED, "InstanceNorm": _NORMED,
    "_bn_affine": _NORMED,
    "_zeros": (0.0, 0.0), "_zeros_like": (0.0, 0.0),
    "_ones": (1.0, 1.0), "_ones_like": (1.0, 1.0),
}

_PASSTHROUGH_OPS = frozenset({
    "Flatten", "Reshape", "reshape", "transpose", "SwapAxis", "slice",
    "slice_axis", "slice_like", "SliceChannel", "Crop", "expand_dims",
    "squeeze", "_copy", "identity", "BlockGrad", "stop_gradient", "cast",
    "Cast", "_precision_cast",
    "broadcast_to", "broadcast_axis", "broadcast_like", "tile",
    "repeat", "reverse", "sort", "UpSampling", "Pad", "mean",
    "max", "min", "take", "batch_take", "pick", "where", "depth_to_space",
    "space_to_depth", "gather_nd", "SequenceLast", "SequenceReverse",
})

def _pooling_iv(node, iv):
    # max/min/avg pooling stays inside the input interval; sum and lp
    # pooling ((sum |x|^p)^(1/p)) scale with the window — unbounded
    if node_attr(node, "pool_type", "max") in ("sum", "lp"):
        return UNKNOWN
    return _first(iv)


_IVAL_FNS = {
    "Activation": _activation_iv, "relu": _relu_iv, "clip": _clip_iv,
    "Pooling": _pooling_iv,
    "exp": _exp_iv, "log": _log_iv, "square": _square_iv, "sqrt": _sqrt_iv,
    "abs": lambda node, iv: (0.0, max(abs(_first(iv)[0]),
                                      abs(_first(iv)[1]))),
    "elemwise_add": _add_iv, "broadcast_add": _add_iv,
    "add_n": lambda node, iv: ((sum(lo for lo, _ in iv),
                                sum(hi for _, hi in iv)) if iv else UNKNOWN),
    "elemwise_sub": _sub_iv, "broadcast_sub": _sub_iv,
    "elemwise_mul": _binmul_iv, "broadcast_mul": _binmul_iv,
    "_maximum": _maximum_iv, "broadcast_maximum": _maximum_iv,
    "_minimum": _minimum_iv, "broadcast_minimum": _minimum_iv,
    "Concat": lambda node, iv: _widest(iv),
    "Dropout": _dropout_iv,
    "_plus_scalar": _scalar_iv(lambda a, s: (a[0] + s, a[1] + s)),
    "_minus_scalar": _scalar_iv(lambda a, s: (a[0] - s, a[1] - s)),
    "_rminus_scalar": _scalar_iv(lambda a, s: (s - a[1], s - a[0])),
    "_mul_scalar": _scalar_iv(lambda a, s: _mul_iv(a, (s, s))),
    "_div_scalar": _scalar_iv(
        lambda a, s: _mul_iv(a, (1.0 / s, 1.0 / s)) if s else UNKNOWN),
    "_maximum_scalar": _scalar_iv(
        lambda a, s: (max(a[0], s), max(a[1], s))),
    "_minimum_scalar": _scalar_iv(
        lambda a, s: (min(a[0], s), min(a[1], s))),
}


def _node_interval(node, in_ivals):
    """Output interval of one plan node given its inputs' intervals —
    sound-but-loose: anything unlisted is UNKNOWN."""
    opname = getattr(node.op, "name", "")
    fixed = _CONST_RANGE.get(opname)
    if fixed is not None:
        return fixed
    fn = _IVAL_FNS.get(opname)
    if fn is not None:
        try:
            lo, hi = fn(node, in_ivals)
        except (TypeError, ValueError, OverflowError):
            return UNKNOWN
        if math.isnan(lo) or math.isnan(hi) or lo > hi:
            return UNKNOWN
        return (lo, hi)
    if opname in _PASSTHROUGH_OPS:
        return _widest(in_ivals)
    return UNKNOWN


# -- the flow analysis --------------------------------------------------------

def _exp_range_safe(opname, interval):
    """May this exp/log-family node drop to bf16, given the input range
    interval analysis proved?  Unbounded -> never."""
    if opname in _JOINT_POWER:
        return False
    lo, hi = interval
    if not (math.isfinite(lo) and math.isfinite(hi)):
        return False
    if opname in _LOG_LIKE:
        return lo >= _LOG_SAFE_LO
    if opname in _SHIFT_INVARIANT:
        return (hi - lo) <= 2.0 * _EXP_SAFE
    return -_EXP_SAFE <= lo and hi <= _EXP_SAFE


def _const_interval(value):
    """Actual min/max of a baked constant — concrete host data, so this is
    a real (not abstract) range seed.  Large arrays skipped: scanning a
    folded weight tensor is not worth the host time."""
    import numpy as np

    if isinstance(value, torch.Tensor):
        if value.dtype == torch.bfloat16 or value.numel() > 65536:
            return UNKNOWN  # numpy's kind "V" in the JAX package, or too big
        value = value.detach().cpu().numpy()
    try:
        arr = np.asarray(value)
    except Exception:
        return UNKNOWN
    if arr.size == 0 or arr.size > 65536 or arr.dtype.kind not in "fiu":
        return UNKNOWN
    lo, hi = float(arr.min()), float(arr.max())
    if math.isnan(lo) or math.isnan(hi):
        return UNKNOWN
    return (lo, hi)


def _flow(ctx, graph):
    """Run the dtype/interval/sensitivity analysis over ``graph`` ->
    ``(rows, diags)`` where ``rows`` is one cast-plan row per node in plan
    order and ``diags`` the hazard diagnostics.  Memoized per (ctx, graph):
    the registered analyzer and :func:`precision_plan` each need half of
    the result, and a shared context must pay the abstract walk once."""
    from .graph_analyzers import _abstract_walk

    memo = getattr(ctx, "_numerics_flow", None)
    if memo is not None and memo[0] is graph:
        return memo[1]

    f64 = torch.float64
    ivals = {}          # env name -> (lo, hi)
    f64_origin = {}     # env name -> origin label for float64 taint
    creep = {}          # origin label -> [downstream node names]
    rows = []
    diags = []
    seen_nodes = set()  # multi-output nodes record once per output

    for name, aval in list(ctx.arg_avals.items()) + \
            list(ctx.aux_avals.items()):
        ivals[name] = UNKNOWN
        if aval.dtype == f64:
            f64_origin[name] = "input %r" % name
            creep.setdefault("input %r" % name, [])
    for name, value in graph.constants.items():
        ivals[name] = _const_interval(value)

    def record(node, nm, shape, dtype, in_vals, in_names):
        in_ivals = [ivals.get(n, UNKNOWN) for n in in_names]
        interval = _node_interval(node, in_ivals)
        ivals[nm] = interval
        opname = getattr(node.op, "name", "?")
        sens = op_sensitivity(node)

        in_fbits = [(n, _float_bits(getattr(v, "dtype", None)))
                    for n, v in zip(in_names, in_vals)]
        in_fbits = [(n, b) for n, b in in_fbits if b is not None]
        out_bits = _float_bits(dtype)

        # f64 creep: taint flows from the first float64 source downstream;
        # a node MAKING f64 out of narrower inputs is a new origin (the
        # shape_dtype analyzer flags that node itself as f64-promotion —
        # this analysis adds how far the poison spreads)
        if dtype == f64:
            origins = sorted({f64_origin[n] for n in in_names
                              if n in f64_origin})
            if origins:
                f64_origin[nm] = origins[0]
                if node.name not in creep.setdefault(origins[0], []):
                    creep[origins[0]].append(node.name)
            else:
                f64_origin[nm] = "node %r (%s)" % (node.name, opname)
                creep.setdefault(f64_origin[nm], [])

        first = node.name not in seen_nodes
        seen_nodes.add(node.name)
        if first:
            # silent downcast: output narrower than the widest float input
            # without an explicit cast op saying so
            if out_bits is not None and in_fbits \
                    and opname not in _EXPLICIT_CASTS \
                    and opname not in _PRECISION_MANAGED:
                widest_n, widest_b = max(in_fbits, key=lambda nb: nb[1])
                if out_bits < widest_b:
                    diags.append(Diagnostic(
                        "silent-downcast", WARNING,
                        "node %r (%s) narrows %s (%d-bit, via %r) to "
                        "%d-bit %s with no explicit cast — precision is "
                        "dropped where no reader of the graph can see it"
                        % (node.name, opname, widest_n, widest_b, widest_n,
                           out_bits, _dtype_name(dtype)), where=node.name))
            # mixed-dtype binop promotion
            float_dts = sorted({_dtype_name(getattr(v, "dtype", ""))
                                for v in in_vals
                                if _float_bits(getattr(v, "dtype", None))
                                is not None})
            if len(float_dts) > 1 and opname not in _PRECISION_MANAGED \
                    and opname not in _EXPLICIT_CASTS:
                diags.append(Diagnostic(
                    "mixed-dtype-binop", WARNING,
                    "node %r (%s) mixes float input dtypes %s — the op "
                    "silently promotes to the widest; make the cast "
                    "explicit so the intent is reviewable"
                    % (node.name, opname, float_dts), where=node.name))
            # low-precision accumulation (plain reductions accumulate in the
            # input dtype; matrix-unit contractions accumulate fp32)
            if sens in (REDUCE, CANCELLATION) \
                    and opname not in _MXU_ACCUM \
                    and any(b is not None and b <= 16 for _, b in in_fbits):
                diags.append(Diagnostic(
                    "low-precision-accum", WARNING,
                    "node %r (%s) accumulates over %d-bit float inputs — "
                    "each add loses one part in 256; keep an fp32 "
                    "accumulator (the bf16 cast pass must not lower this "
                    "node's reduction dtype)"
                    % (node.name, opname,
                       min(b for _, b in in_fbits if b is not None)),
                    where=node.name))
            # exp/log family reached by an unbounded range in low precision
            if sens == EXP_RANGE \
                    and not _exp_range_safe(opname, _widest(in_ivals)) \
                    and any(b is not None and b <= 16 for _, b in in_fbits):
                diags.append(Diagnostic(
                    "exp-unbounded-lowp", WARNING,
                    "node %r (%s) applies an exp/log-family function to a "
                    "%s-range %s input — bf16/f16 saturates or loses all "
                    "relative precision here; keep this node fp32"
                    % (node.name, opname,
                       "unbounded" if not all(map(
                           math.isfinite, _widest(in_ivals))) else "wide",
                       "/".join(sorted({_dtype_name(getattr(v, "dtype", "?"))
                                        for v in in_vals
                                        if _is_lowp(getattr(v, "dtype",
                                                            None))}))),
                    where=node.name))
            # the verdict row
            if sens in (REDUCE, CANCELLATION):
                verdict = FP32_ACCUM
            elif sens == EXP_RANGE:
                verdict = BF16_SAFE if _exp_range_safe(
                    opname, _widest(in_ivals)) else FP32_ONLY
            else:
                verdict = BF16_SAFE
            rows.append({"node": node.name, "op": opname,
                         "sensitivity": sens, "verdict": verdict,
                         "dtype": _dtype_name(dtype)})

    _abstract_walk(graph, ctx, record=record)

    for origin, downstream in sorted(creep.items()):
        if not downstream:
            # taint that never spread: an f64 input immediately cast away,
            # or a terminal promoting node (which shape_dtype already
            # flags as f64-promotion) — nothing flow-level to add
            continue
        diags.append(Diagnostic(
            "f64-creep", WARNING,
            "float64 originates at %s and flows through %d downstream "
            "node(s): %s — every tainted buffer is 2x memory and breaks "
            "the numerics of the plan; cast at the origin, not downstream"
            % (origin, len(downstream), ", ".join(downstream[:8])),
            where=origin))
    try:
        ctx._numerics_flow = (graph, (rows, diags))
    except AttributeError:
        pass  # a foreign ctx without the memo slot still analyzes fine
    return rows, diags


# -- the registered analyzer --------------------------------------------------

@register_analyzer("numerics", version=NUMERICS_VERSION)
def numerics(ctx):
    """Dtype-flow + sensitivity hazards over the plan actually lowered."""
    from .graph_analyzers import skipped_no_avals

    if not ctx.has_avals:
        return [skipped_no_avals("numerics")]
    _, diags = _flow(ctx, ctx.graph)
    return diags


# -- the cast-plan contract ---------------------------------------------------

class CastPlan:
    """The fingerprinted artifact the precision tiers consume
    (``graph_passes/precision.py``): one verdict row per plan node, in
    plan order.

    ``rows``     tuple of ``{"node", "op", "sensitivity", "verdict",
                 "dtype"}`` dicts;
    ``mode``     "train" | "eval" (the plan the verdicts describe);
    ``versions`` ``(SENSITIVITY_VERSION, NUMERICS_VERSION)`` under which
                 the verdicts were computed.
    """

    __slots__ = ("mode", "rows", "versions")

    def __init__(self, mode, rows, versions=None):
        self.mode = mode
        self.rows = tuple(dict(r) for r in rows)
        self.versions = tuple(versions) if versions is not None \
            else (SENSITIVITY_VERSION, NUMERICS_VERSION)

    def counts(self):
        """Verdict histogram."""
        out = {BF16_SAFE: 0, FP32_ACCUM: 0, FP32_ONLY: 0}
        for r in self.rows:
            out[r["verdict"]] = out.get(r["verdict"], 0) + 1
        return out

    def verdict(self, node_name):
        """Verdict for one node name, or None if the plan has no such
        node (e.g. it was folded away by the pass pipeline)."""
        for r in self.rows:
            if r["node"] == node_name:
                return r["verdict"]
        return None

    def fingerprint(self):
        """Stable identity of this plan's numerics contract: changes when
        and only when the verdict rows (i.e. the plan) or the registry /
        analyzer versions change."""
        blob = json.dumps({"mode": self.mode, "versions": self.versions,
                           "rows": self.rows}, sort_keys=True)
        return "castplan-" + hashlib.sha256(blob.encode()).hexdigest()[:16]

    def to_dict(self):
        """JSON-ready form."""
        return {"mode": self.mode, "fingerprint": self.fingerprint(),
                "versions": list(self.versions),
                "counts": self.counts(), "rows": [dict(r) for r in self.rows]}

    def __repr__(self):
        c = self.counts()
        return "CastPlan(%s, %d nodes: %d bf16_safe / %d fp32_accum / " \
            "%d fp32_only, %s)" % (self.mode, len(self.rows), c[BF16_SAFE],
                                   c[FP32_ACCUM], c[FP32_ONLY],
                                   self.fingerprint())


def precision_plan(ctx):
    """Compute the :class:`CastPlan` for a bound :class:`GraphContext` —
    the implementation behind ``Executor.precision_plan()`` /
    ``Predictor.precision_plan()``.  Raises ``ValueError`` when the
    context carries no avals: a cast plan over unknown dtypes would be a
    guess, and this artifact is a contract."""
    if not ctx.has_avals:
        raise ValueError(
            "precision_plan needs bound shapes/dtypes (arg_avals/aux_avals)"
            " — bind arrays before asking for a cast plan")
    rows, _ = _flow(ctx, ctx.graph)
    return CastPlan("train" if ctx.is_train else "eval", rows)


_VERDICT_RANK = {BF16_SAFE: 0, FP32_ACCUM: 1, FP32_ONLY: 2}


def param_verdict_classes(ctx):
    """{bound arg/aux name -> verdict class} for every input the plan
    consumes: each parameter takes the most conservative verdict
    (``fp32_only`` > ``fp32_accum`` > ``bf16_safe``) among the nodes that
    read it.  Names never consumed by a classified node
    (dead inputs, pass-folded consumers) are simply absent — the caller
    reports them as "unknown", never as blessed.  Shares :func:`_flow`'s
    per-context memo with the analyzer and ``precision_plan`` (one
    abstract walk for all three); raises ``ValueError`` without bound
    avals, exactly like ``precision_plan``."""
    if not ctx.has_avals:
        raise ValueError(
            "param_verdict_classes needs bound shapes/dtypes "
            "(arg_avals/aux_avals) — bind arrays before asking for "
            "verdict classes")
    rows, _ = _flow(ctx, ctx.graph)
    by_node = {r["node"]: r["verdict"] for r in rows}
    bound = set(ctx.arg_names or ()) | set(ctx.aux_names or ())
    out = {}
    for node, in_names in ctx.graph.entries:
        v = by_node.get(node.name)
        if v is None:
            continue
        for n in in_names:
            if n in bound:
                cur = out.get(n)
                if cur is None or _VERDICT_RANK[v] > _VERDICT_RANK[cur]:
                    out[n] = v
    return out


def contract_fingerprint():
    """Version-only identity of the numerics contract: it enters
    ``precision.tier_fingerprint`` (and so ``graph_passes.
    pipeline_fingerprint()`` under a tier); a cast plan's fingerprint
    changes only when its plan changes or these versions bump."""
    return "numerics:%d|sensitivity:%d" % (NUMERICS_VERSION,
                                           SENSITIVITY_VERSION)
