"""Deployment precision tiers (counterpart of
``mxnet_tpu/graph_passes/precision.py``): graph passes that spend the cast
plan's verdicts (``analysis/numerics.py``) on inference plans, set per
executor (``Executor.set_precision_tier``, ``Predictor.with_precision``).
The pass names, versions, tolerances and rewrites are the JAX package's.

``bf16`` tier: ``fold_conv_affine`` then ``bf16_cast``.

* ``fold_conv_affine``: a frozen-statistics ``_bn_affine`` whose input is
  read only by it and made by a Convolution or FullyConnected folds into
  that producer's weight and bias when the plan is built.  The fold is
  computed in numpy float32 as the JAX pass computes it, so the folded
  constants are equal bit for bit; the executor moves them to its device
  once.
* ``bf16_cast``: ``bf16_safe`` regions run in bf16 (one cast node at most
  per value and direction); ``fp32_accum`` convolutions and dense layers
  take bf16 operands with ``accum_dtype="float32"`` and narrow their
  output; other ``fp32_accum`` nodes run in an fp32 island (operands
  widened inside the node, outputs narrowed); ``fp32_only`` nodes see fp32
  operands.  Heads are cast back to their fp32 plan's dtypes.

``int8`` tier: ``fold_conv_affine`` then ``int8_rewrite``.

* ``int8_rewrite``: with a :class:`CalibrationTable` from
  :func:`calibrate`, each Convolution / FullyConnected whose data input is
  calibrated, whose weight is known when the plan is built, and whose
  verdict is not ``fp32_only``, becomes a symmetric int8 node: per-channel
  weight scales and int8 weights baked as constants (numpy, as the JAX
  pass), the activation quantized per tensor as ``clip(round(x *
  fp32(1 / a_scale)), ±127)`` (the jitted JAX tier's arithmetic, see
  :func:`_quantize_activation`), an exact int32 product
  (``ops/quantization.py`` ``_int_conv`` / ``_int_matmul``), the fp32
  dequantization at the exit.
  The quantization is plain PyTorch, as the JAX tier's is plain ``jnp``:
  it is not the arithmetic of the int8 kernel pair (``quantize_int8``
  multiplies by 127/range and rounds half away from zero).

Contracts: with no tier nothing here runs and the executor's plan is the
standard pipeline's; a twin's outputs are held to :func:`tier_tolerance`
against its fp32 plan; weights are baked when the inference plan is first
built, so a twin is rebuilt (``with_precision``) after a weight change.
"""
from __future__ import annotations

import hashlib
import json
import time

import numpy as np
import torch

from .ir import Graph, PlanNode, SynthOp, node_attr, node_call_attrs, node_out_names

__all__ = ["tier_name", "tier_fingerprint", "tier_passes",
           "tier_tolerance", "TOLERANCE", "apply", "TierContext",
           "fold_conv_affine", "bf16_cast", "int8_rewrite", "calibrate",
           "observe_ranges", "CalibrationTable", "VALID_TIERS"]

VALID_TIERS = ("bf16", "int8")

# per-pass tolerance contracts against the fp32 plan (the JAX package's)
TOLERANCE = {
    # algebraically exact up to float reassociation
    "fold_conv_affine": {"rtol": 1e-4, "atol": 1e-5},
    # bf16 keeps 8 mantissa bits; fp32 accumulation bounds the drift
    "bf16_cast": {"rtol": 5e-2, "atol": 5e-2},
    # 8-bit symmetric quantization of weights and activations
    "int8_rewrite": {"rtol": 0.25, "atol": 0.1},
}

def tier_name(t):
    """Report label of a tier: the tier, or ``"fp32"`` when off."""
    return t or "fp32"


def tier_passes(t):
    """The ``(name, version, fn)`` pass list of tier ``t``, in run order."""
    return _TIER_PASSES[t]


def tier_fingerprint(t):
    """Stable identity of a tier: its ``name:version`` passes and the
    numerics contract versions, or None when off."""
    if not t:
        return None
    from ..analysis import numerics

    return "tier=%s|%s|%s" % (
        t, "|".join("%s:%d" % (n, v) for n, v, _ in _TIER_PASSES[t]),
        numerics.contract_fingerprint())


def tier_tolerance(t):
    """rtol / atol of a whole tier (the loosest of its passes): what a
    twin's outputs are held to against its fp32 plan."""
    rows = [TOLERANCE[n] for n, _, _ in _TIER_PASSES[t]]
    return {"rtol": max(r["rtol"] for r in rows),
            "atol": max(r["atol"] for r in rows)}


def _host(v):
    """A tensor (any device) or array -> numpy; bfloat16 as float32, the
    one dtype numpy lacks."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


class TierContext:
    """What a tier pass may consult (built by ``Executor._opt_plan`` when it
    first builds an inference plan): ``cast_plan``, the structural plan's
    :class:`~..analysis.numerics.CastPlan`; ``arg_names`` / ``aux_names``
    and ``arg_avals`` / ``aux_avals`` (meta tensors, the fields of the
    analysis ``GraphContext``, so ``_abstract_walk`` takes this context);
    ``arg_values`` / ``aux_values``, the bound tensors; ``calibration``,
    the int8 tier's :class:`CalibrationTable`."""

    is_train = False  # tier passes exist for inference plans only

    def __init__(self, cast_plan, arg_names, aux_names, arg_avals, aux_avals,
                 arg_values, aux_values, calibration=None):
        self.cast_plan = cast_plan
        self.arg_names = list(arg_names)
        self.aux_names = list(aux_names)
        self.arg_avals = arg_avals
        self.aux_avals = aux_avals
        self.arg_values = dict(arg_values)
        self.aux_values = dict(aux_values)
        self.calibration = calibration
        # fold_conv_affine renames a folded affine's output onto its
        # producer's env name; calibration ranges are keyed on the
        # structural plan's names: {new name -> old name}
        self.calib_alias = {}
        # int8_rewrite's export of every quantized site: {site -> {input
        # (structural env name), lo, hi, a_scale}}
        self.int8_sites = {}

    def calib_range(self, name):
        """Calibrated (lo, hi) of an env name, through any fold rename;
        None without a table or coverage."""
        if self.calibration is None:
            return None
        return self.calibration.range(self.calib_alias.get(name, name))

    def value_of(self, graph, name):
        """Host value (numpy) of an env name, a baked constant or a bound
        argument or auxiliary state; None when the name is computed."""
        if name in graph.constants:
            return _host(graph.constants[name])
        v = self.arg_values.get(name, self.aux_values.get(name))
        return None if v is None else _host(v)

    def dtype_of(self, graph, name):
        """The torch dtype of a constant or bound value (None if neither)."""
        v = graph.constants.get(name, self.arg_values.get(name, self.aux_values.get(name)))
        if v is None:
            return None
        return v.dtype if isinstance(v, torch.Tensor) else _torch_dtype(np.asarray(v).dtype)


def apply(graph, t, ctx):
    """Run tier ``t``'s passes over ``graph`` -> ``(graph, rows)``, rows
    shaped like ``graph_passes.optimize``'s; constants no entry or head
    reads any more are dropped."""
    rows = []
    for name, version, fn in _TIER_PASSES[t]:
        t0 = time.perf_counter()
        n_in = graph.n_nodes
        graph = fn(graph, ctx)
        rows.append({"pass": name, "version": version, "nodes_in": n_in,
                     "nodes_out": graph.n_nodes,
                     "seconds": round(time.perf_counter() - t0, 6)})
    if graph.constants:
        used = set(graph.heads)
        for _, in_names in graph.entries:
            used.update(in_names)
        if any(k not in used for k in graph.constants):
            graph = Graph(graph.entries, graph.heads,
                          {k: v for k, v in graph.constants.items() if k in used})
    return graph, rows


# -- shared plumbing ----------------------------------------------------------

_NP_TO_TORCH = {np.dtype(k): getattr(torch, k) for k in
                ("float64", "float32", "float16", "int64", "int32", "int16", "int8",
                 "uint8", "bool")}


def _torch_dtype(np_dtype):
    return _NP_TO_TORCH[np.dtype(np_dtype)]


class TierOp:
    """Stand-in ``OpDef`` for tier-wrapped nodes.  Unlike
    :class:`~.ir.SynthOp` it carries the wrapped op's ``attr_names`` and
    ``defaults``, so ``node_call_attrs``, ``node_attr`` and the analyzers
    resolve attributes as they did on the original node."""

    aux = ()
    aux_update = None
    mutates = ()
    inputs_fn = None
    infer_params = None
    arg_names = ()

    def __init__(self, name, fn, inner=None, attr_names=()):
        self.name = name
        self.fn = fn
        self.attr_names = tuple(getattr(inner, "attr_names", attr_names))
        self.defaults = dict(getattr(inner, "defaults", {}) or {})

    def __repr__(self):
        return "TierOp(%s)" % self.name


def _cast_fn(x, *, dtype):
    return x.to(getattr(torch, dtype))


_CAST_OP = SynthOp("_precision_cast", _cast_fn, attr_names=("dtype",))


def _out_dtypes(graph, ctx):
    """{env name -> torch dtype} over ``graph`` by one abstract walk on meta
    tensors: the dtypes the fp32 plan runs with."""
    from ..analysis.graph_analyzers import _abstract_walk

    dts = {n: av.dtype for n, av in list(ctx.arg_avals.items()) + list(ctx.aux_avals.items())}
    for n, v in graph.constants.items():
        dts[n] = v.dtype if isinstance(v, torch.Tensor) else _torch_dtype(np.asarray(v).dtype)

    def record(node, nm, shape, dtype, in_vals, in_names):
        dts[nm] = dtype

    _abstract_walk(graph, ctx, record=record)
    return dts


def _consumers(graph):
    """{env name -> number of reads} across entries and heads."""
    n = {}
    for _, in_names in graph.entries:
        for nm in in_names:
            n[nm] = n.get(nm, 0) + 1
    for h in graph.heads:
        n[h] = n.get(h, 0) + 1
    return n


def _producers(graph):
    """{output env name -> (node, in_names)}."""
    out = {}
    for node, in_names in graph.entries:
        for nm in node_out_names(node):
            out[nm] = (node, in_names)
    return out


# -- pass 1: conv / dense weight folding -------------------------------------

# producers whose output channels are weight axis 0 and output axis 1
_FOLDABLE = ("Convolution", "FullyConnected")


def _channel_first(node):
    if node.op.name == "FullyConnected":
        return node_attr(node, "flatten", True)  # (N, num_hidden): axis 1
    layout = node_attr(node, "layout")
    return layout is None or (len(layout) > 1 and layout[1] == "C")


def fold_conv_affine(graph, ctx):
    """Fold ``_bn_affine`` scale and shift into the preceding Convolution /
    FullyConnected weight and bias (numpy float32, baked as constants); the
    affine node is deleted and its consumers read the producer."""
    prods = _producers(graph)
    uses = _consumers(graph)
    rename = {}
    entries = []
    consts = dict(graph.constants)
    replaced = {}  # producer node name -> (PlanNode, new in_names)
    dropped = set()  # entry indices of folded affine nodes

    for idx, (node, in_names) in enumerate(graph.entries):
        if getattr(node.op, "name", "") != "_bn_affine" \
                or node.num_outputs != 1 or len(in_names) != 5:
            continue
        data_nm = in_names[0]
        prod = prods.get(data_nm)
        if prod is None:
            continue
        pnode, pin = prod
        if getattr(pnode.op, "name", "") not in _FOLDABLE \
                or pnode.num_outputs != 1 or not _channel_first(pnode) \
                or pnode.name in replaced:
            continue
        if uses.get(data_nm, 0) != 1:
            continue  # another consumer reads the producer's own output
        ax = node_attr(node, "axis", 1)
        # the fold rescales weight axis 0, the producer's channel axis: a
        # convolution's axis 1 only; a dense layer's (N, num_hidden) 1 or -1
        if pnode.op.name == "FullyConnected":
            if ax not in (1, -1):
                continue
        elif ax != 1:
            continue
        vals = [ctx.value_of(graph, nm) for nm in in_names[1:]]
        if any(v is None for v in vals) or len(pin) < 2:
            continue
        w = ctx.value_of(graph, pin[1])
        if w is None:
            continue
        bias = ctx.value_of(graph, pin[2]) if len(pin) > 2 else None
        if len(pin) > 2 and bias is None:
            continue  # a computed bias: folding would drop it
        gamma, beta, mean, var = (v.astype(np.float32) for v in vals)
        eps = node_attr(node, "eps", 1e-3)
        eps = 1e-3 if eps is None else float(eps)
        if node_attr(node, "fix_gamma", True):
            gamma = np.ones_like(gamma)
        scale = gamma / np.sqrt(var + eps)
        shift = beta - mean * scale
        if w.shape[0] != scale.shape[0]:
            continue
        w2 = (w.astype(np.float32)
              * scale.reshape((-1,) + (1,) * (w.ndim - 1))).astype(w.dtype)
        b2 = (bias.astype(np.float32) * scale + shift).astype(np.float32) \
            if bias is not None else shift.astype(np.float32)
        if ctx.dtype_of(graph, pin[1]) == torch.bfloat16:
            w2 = torch.from_numpy(w2).to(torch.bfloat16)
        wc, bc = "%s__folded_weight" % pnode.name, "%s__folded_bias" % pnode.name
        consts[wc], consts[bc] = w2, b2
        attrs = dict(pnode.attrs)
        attrs["no_bias"] = False
        replaced[pnode.name] = (PlanNode(pnode.op, attrs, pnode.name), (pin[0], wc, bc))
        dropped.add(idx)
        rename["%s_output" % node.name] = data_nm
        # consumers now read the affined value under the producer's name:
        # calibration lookups go to the range recorded for the affine output
        ctx.calib_alias[data_nm] = "%s_output" % node.name

    if not replaced:
        return graph
    for idx, (node, in_names) in enumerate(graph.entries):
        if idx in dropped:
            continue
        if node.name in replaced and getattr(node.op, "name", "") in _FOLDABLE:
            node, in_names = replaced[node.name]
        entries.append((node, tuple(rename.get(n, n) for n in in_names)))
    return Graph(entries, (rename.get(h, h) for h in graph.heads), consts)


# -- pass 2: the bf16 cast pass -----------------------------------------------

_F32 = torch.float32
_BF16 = "bfloat16"

# contractions with the accum_dtype hook (ops/nn.py); other fp32_accum ops
# go through the fp32 island
_ACCUM_DTYPE_OPS = ("Convolution", "FullyConnected")


def _island_fn(inner):
    """The fp32 island around a node: 16-bit float operands widened to fp32
    inside it, the op in fp32, float outputs narrowed to bf16."""

    def fn(*args, **attrs):
        up = [a.float() if isinstance(a, torch.Tensor) and a.is_floating_point()
              and a.element_size() <= 2 else a for a in args]
        res = inner.fn(*up, **attrs)
        outs = res if isinstance(res, tuple) else (res,)
        outs = tuple(o.to(torch.bfloat16) if o.is_floating_point() else o for o in outs)
        return outs if isinstance(res, tuple) else outs[0]

    return fn


def bf16_cast(graph, ctx):
    """The cast plan's consumer: ``bf16_safe`` regions in bf16,
    ``fp32_accum`` with fp32 accumulation, ``fp32_only`` untouched; one
    cast node at most per value and direction; heads widened back."""
    verdicts = {r["node"]: r["verdict"] for r in ctx.cast_plan.rows}
    dts = _out_dtypes(graph, ctx)
    holds = {}        # env name -> "bf16" where the rewritten plan narrowed it
    casts = {}        # (env name, want) -> cast output env name
    entries = []

    def request(nm, want):
        """Env name giving ``nm``'s value in ``want`` ("bf16" | "f32"); adds
        (and remembers) at most one cast node per direction."""
        if dts.get(nm) != _F32:
            return nm  # non-f32 values never take part
        have = holds.get(nm, "f32")
        if have == want:
            return nm
        key = (nm, want)
        hit = casts.get(key)
        if hit is not None:
            return hit
        cnode = PlanNode(_CAST_OP, {"dtype": _BF16 if want == "bf16" else "float32"},
                         "%s__to_%s" % (nm, want))
        out = node_out_names(cnode)[0]
        entries.append((cnode, (nm,)))
        casts[key] = out
        return out

    for node, in_names in graph.entries:
        opname = getattr(node.op, "name", "")
        verdict = verdicts.get(node.name)
        out_nm = node_out_names(node)
        # a node with no float32 operand to narrow stays as it is
        has_f32_in = any(dts.get(n) == _F32 for n in in_names)
        rewriteable = (verdict in ("bf16_safe", "fp32_accum")
                       and node.num_outputs == 1 and has_f32_in
                       and dts.get(out_nm[0]) == _F32
                       and opname != "_precision_cast")
        if not rewriteable:
            # the node sees the fp32 plan's operand dtypes
            entries.append((node, tuple(request(n, "f32") for n in in_names)))
            continue
        if verdict == "bf16_safe":
            entries.append((node, tuple(request(n, "bf16") for n in in_names)))
        elif opname in _ACCUM_DTYPE_OPS:
            attrs = dict(node.attrs)
            attrs["accum_dtype"] = "float32"
            attrs["out_dtype"] = _BF16
            entries.append((PlanNode(node.op, attrs, node.name),
                            tuple(request(n, "bf16") for n in in_names)))
        else:
            # fp32 island: operands as held, no cast nodes at its edges
            entries.append((PlanNode(TierOp("_fp32_island", _island_fn(node.op), inner=node.op),
                                     dict(node.attrs), node.name, node.num_outputs), in_names))
        holds[out_nm[0]] = "bf16"

    heads = tuple(request(h, "f32") for h in graph.heads)
    if not holds and not casts:
        return graph
    return Graph(entries, heads, graph.constants)


# -- pass 3: calibration-based int8 rewrite ----------------------------------


class CalibrationTable:
    """Observed per-tensor ranges from :func:`calibrate`, ``{env name ->
    (lo, hi)}`` and the batch count, with a fingerprint that moves when the
    ranges do (the JAX package's, so a table crosses the packages)."""

    __slots__ = ("ranges", "batches")

    def __init__(self, ranges, batches=0):
        self.ranges = {str(k): (float(lo), float(hi)) for k, (lo, hi) in ranges.items()}
        self.batches = int(batches)

    def range(self, name):
        return self.ranges.get(name)

    def fingerprint(self):
        blob = json.dumps({k: [round(v[0], 6), round(v[1], 6)]
                           for k, v in sorted(self.ranges.items())}, sort_keys=True)
        return "calib-" + hashlib.sha256(blob.encode()).hexdigest()[:16]

    def __repr__(self):
        return "CalibrationTable(%d tensors, %d batches, %s)" % (
            len(self.ranges), self.batches, self.fingerprint())


# float dtypes whose ranges a table records: numpy's kind "f" (the JAX
# package's test), so bfloat16 values are skipped there and here
_CALIB_DTYPES = (torch.float16, torch.float32, torch.float64)


def _structural_env(exe, batch):
    """The environment of one structural inference pass over ``exe``'s
    bound values with ``batch``'s inputs, and its plan."""
    plan, _heads, const_env = exe._structural_plan(False)
    env = dict(exe._device_constants(const_env))
    env.update(exe.arg_dict)
    env.update(exe.aux_dict)
    for n, v in batch.items():
        env[n] = torch.as_tensor(np.asarray(v, np.float32) if not isinstance(v, torch.Tensor)
                                 else v, dtype=torch.float32, device=exe.device)
    return plan, env


def _run_node(node, env, in_names):
    res = node.op.fn(*[env[n] for n in in_names], **node_call_attrs(node, None, False))
    outs = res if isinstance(res, tuple) else (res,)
    if len(outs) > 1 and node.num_outputs == 1:
        outs = outs[:1]
    return zip(node_out_names(node), outs)


def _ranges(items):
    """{name: (lo, hi)} of the float tensors among ``items`` (name, tensor),
    NaN-free and non-empty, with one copy to the host."""
    names, stats = [], []
    for nm, v in items:
        if isinstance(v, torch.Tensor) and v.dtype in _CALIB_DTYPES and v.numel():
            lo, hi = torch.aminmax(v.detach())
            names.append(nm)
            stats.append(torch.stack([lo, hi]).to(torch.float64))
    if not stats:
        return {}
    vals = torch.stack(stats).cpu().tolist()
    return {nm: (lo, hi) for nm, (lo, hi) in zip(names, vals)
            if not (np.isnan(lo) or np.isnan(hi))}


def calibrate(predictor, batches):
    """Per-tensor min / max over ``batches`` (an iterable of ``{input name
    -> array or tensor}``) through the predictor's structural inference plan
    (the fp32 graph the int8 rewrite replaces) -> :class:`CalibrationTable`.
    Every value of the environment is recorded (inputs, weights, node
    outputs), as in the JAX package; it runs eagerly on the predictor's
    device."""
    exe = predictor._exec
    lo, hi = {}, {}
    n_batches = 0
    with torch.inference_mode():
        for batch in batches:
            n_batches += 1
            plan, env = _structural_env(exe, batch)
            for node, in_names in plan:
                env.update(_run_node(node, env, in_names))
            for nm, (l, h) in _ranges(env.items()).items():
                lo[nm] = min(lo.get(nm, l), l)
                hi[nm] = max(hi.get(nm, h), h)
    return CalibrationTable({k: (lo[k], hi[k]) for k in lo}, batches=n_batches)


def observe_ranges(predictor, batch, names):
    """Live (lo, hi) of some structural env names on one batch, the walk of
    :func:`calibrate` stopped once every name is produced -> ``{name ->
    (lo, hi)}`` of the names produced."""
    want = set(names)
    if not want:
        return {}
    exe = predictor._exec
    with torch.inference_mode():
        plan, env = _structural_env(exe, batch)
        found = {nm: env[nm] for nm in want & set(env)}
        for node, in_names in plan:
            if len(found) == len(want):
                break
            for nm, o in _run_node(node, env, in_names):
                env[nm] = o
                if nm in want:
                    found[nm] = o
        return _ranges(found.items())


def _quantize_activation(x, a_inv):
    """clip(round(x * a_inv), -127, 127) as int8, the JAX tier's expression
    as the JAX Predictor runs it: the tier writes ``x / a_scale`` with
    ``a_scale`` a Python constant, and under ``jax.jit`` XLA's simplifier
    makes that a product by fp32(1 / fp32(a_scale)), as it does for the
    detection ops (``ops/detection.py _times_inverse``).  ``a_inv`` is
    that number as a 0-d float32 tensor baked with the plan, so the product
    rounds once on either device; ``torch.round`` rounds half to even as
    ``jnp.round``."""
    return torch.clamp(torch.round(x * a_inv), -127.0, 127.0).to(torch.int8)


def int8_accumulators(data, wq, a_inv, kind, attrs):
    """The exact int32 product of a quantized site: the activation
    quantized by ``a_inv`` (:func:`_quantize_activation`) against the int8
    weight ``wq``; ``kind`` is "Convolution" or "FullyConnected"."""
    from ..ops.nn import pair
    from ..ops.quantization import _int_conv, _int_matmul

    if kind == "Convolution":
        if attrs.get("num_group", 1) != 1:
            raise NotImplementedError("int8 tier: grouped convolutions are not ported")
        geom = (pair(attrs.get("stride") or 1), pair(attrs.get("pad") or 0),
                pair(attrs.get("dilate") or 1))
        return _int_conv(_quantize_activation(data, a_inv), wq, *geom)
    x = data.reshape(data.shape[0], -1) if attrs.get("flatten", True) else data
    lead = x.shape[:-1]
    out = _int_matmul(_quantize_activation(x, a_inv), wq)
    return out.reshape(*lead, wq.shape[0])


def _int8_conv_fn(data, wq, wscale, ascale, ainv, bias=None, **attrs):
    """Symmetric int8 convolution: per-tensor activation scale ``ascale``
    and its inverse ``ainv`` (0-d float32 constants; ``a_scale`` is the
    same number as an attribute), per-channel weight scales, int32
    accumulation, fp32 dequantization."""
    out32 = int8_accumulators(data, wq, ainv, "Convolution", attrs)
    out = out32.to(torch.float32) * (ascale * wscale.reshape(1, -1, 1, 1))
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def _int8_fc_fn(data, wq, wscale, ascale, ainv, bias=None, **attrs):
    """Symmetric int8 dense layer, as :func:`_int8_conv_fn`."""
    out32 = int8_accumulators(data, wq, ainv, "FullyConnected", attrs)
    out = out32.to(torch.float32) * (ascale * wscale)
    if bias is not None:
        out = out + bias
    return out


def int8_rewrite(graph, ctx):
    """Rewrite calibrated Convolution / FullyConnected nodes to int8 (module
    docstring).  Coverage: data input calibrated, weight value known,
    verdict not fp32_only; everything else is left as it is."""
    if ctx.calibration is None:
        return graph
    verdicts = {r["node"]: r["verdict"] for r in ctx.cast_plan.rows}
    dts = _out_dtypes(graph, ctx)
    consts = dict(graph.constants)
    entries = []
    changed = False

    for node, in_names in graph.entries:
        opname = getattr(node.op, "name", "")
        verdict = verdicts.get(node.name)
        ok = (opname in _FOLDABLE and node.num_outputs == 1
              and verdict is not None and verdict != "fp32_only"
              and _channel_first(node) and len(in_names) >= 2
              and dts.get(in_names[0]) == _F32)
        if ok and opname == "Convolution":
            kern = node_attr(node, "kernel")
            ok = kern is not None and len(tuple(np.atleast_1d(kern))) == 2 \
                and node_attr(node, "layout") in (None, "NCHW") \
                and node_attr(node, "num_group", 1) == 1
        # ranges recorded on the structural plan, through any fold rename: a
        # node fed by a folded BatchNorm quantizes with the affined range
        rng = ctx.calib_range(in_names[0]) if ok else None
        w = ctx.value_of(graph, in_names[1]) if ok else None
        if not ok or rng is None or w is None:
            entries.append((node, in_names))
            continue
        a_max = max(abs(rng[0]), abs(rng[1]))
        if not np.isfinite(a_max) or a_max <= 0.0:
            entries.append((node, in_names))
            continue
        a_scale = float(a_max / 127.0)
        ctx.int8_sites[node.name] = {
            "input": ctx.calib_alias.get(in_names[0], in_names[0]),
            "lo": float(rng[0]), "hi": float(rng[1]), "a_scale": a_scale}
        wf = w.astype(np.float32)
        chan_max = np.abs(wf).reshape(wf.shape[0], -1).max(axis=1)
        chan_max = np.where(chan_max > 0, chan_max, 1.0)
        w_scale = (chan_max / 127.0).astype(np.float32)
        wq = np.clip(np.round(wf / w_scale.reshape((-1,) + (1,) * (wf.ndim - 1))),
                     -127, 127).astype(np.int8)
        wc, sc, ac, ic = ("%s__int8_%s" % (node.name, k)
                          for k in ("weight", "scale", "ascale", "ainv"))
        consts[wc], consts[sc] = wq, w_scale
        consts[ac], consts[ic] = np.float32(a_scale), np.float32(1) / np.float32(a_scale)
        fn = _int8_conv_fn if opname == "Convolution" else _int8_fc_fn
        op = TierOp("_int8_%s" % opname.lower(), fn, inner=node.op)
        op.attr_names = tuple(op.attr_names) + ("a_scale",)
        attrs = dict(node.attrs)
        attrs["a_scale"] = a_scale
        entries.append((PlanNode(op, attrs, node.name),
                        (in_names[0], wc, sc, ac, ic) + tuple(in_names[2:3])))
        changed = True

    if not changed:
        return graph
    return Graph(entries, graph.heads, consts)


_TIER_PASSES = {
    "bf16": (("fold_conv_affine", 1, fold_conv_affine),
             ("bf16_cast", 1, bf16_cast)),
    "int8": (("fold_conv_affine", 1, fold_conv_affine),
             ("int8_rewrite", 1, int8_rewrite)),
}
