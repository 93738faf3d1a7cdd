"""The standard pass pipeline (counterpart of
``mxnet_tpu/graph_passes/passes.py``): four passes, registered in the order
they run, with the JAX package's names and versions.

1. ``constant_fold``: nodes whose inputs are all baked constants (ops with
   no tensor input seed the lattice) run once when the plan is built and
   become baked constants.
2. ``common_subexpr_merge``: a structural hash on (op, attributes,
   resolved input names, output count); a later duplicate's consumers (and
   heads) are pointed at the first occurrence.  Stochastic nodes are never
   merged: two Dropouts merged would share one mask.  The duplicate chain
   stays for the sweep.
3. ``inference_rewrite``: inference plans only.  Dropout (the identity in
   eval mode) is deleted, and BatchNorm on its moving statistics becomes
   ``_bn_affine``, the eval branch of ``ops.nn.batch_norm`` in the same
   expression order, so the outputs are equal bit for bit.
4. ``dead_node_elim``: reachability from the heads, walked backwards;
   training plans also keep every node that updates auxiliary states.

Every pass is a pure ``Graph -> Graph`` function; the exclusions that
correctness depends on are in the ``_fold_ok`` / ``_cse_ok`` predicates.
"""
from __future__ import annotations

import numpy as np
import torch

from . import register_pass
from .ir import Graph, PlanNode, SynthOp, node_attr, node_out_names, stochastic

# never bake a constant bigger than this: folding exists to shrink plans
_FOLD_MAX_BYTES = 64 << 20

# op families the passes must not touch: arbitrary user Python (may be
# impure) and native-backed ops
_OPAQUE_OPS = ("Custom",)


def _opaque(op):
    return op.name in _OPAQUE_OPS or op.name.startswith("_native")


def _fold_ok(node):
    """A node may be folded iff its value is a pure function of its
    attributes and inputs in both modes: no random stream (``generator``),
    no train/eval branch (``training``), no auxiliary state, no in-place
    update."""
    op = node.op
    if stochastic(op) or "training" in op.attr_names:
        return False
    if op.aux or op.aux_update is not None or getattr(op, "mutates", ()):
        return False
    return not _opaque(op)


def _cse_ok(node, is_train):
    """A node may be merged with a structural twin iff the two are
    observationally identical: a stochastic node draws its own numbers, and
    in training a node that updates auxiliary states must run once per
    node."""
    op = node.op
    if stochastic(op) or getattr(op, "mutates", ()):
        return False
    if is_train and (op.aux or op.aux_update is not None):
        return False
    return not _opaque(op)


def _canon(v):
    if isinstance(v, np.ndarray):
        return _canon(v.tolist())
    if isinstance(v, (list, tuple)):
        return tuple(_canon(e) for e in v)
    return v


def _attr_sig(attrs):
    """Canonical, order-independent attribute signature."""
    return repr(sorted((k, repr(_canon(v))) for k, v in attrs.items()))


def _eval_outs(node, args):
    """Evaluate one node through the registry as the executor does,
    hidden outputs trimmed."""
    args = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args]
    res = node.op.fn(*args, **dict(node.attrs))
    outs = res if isinstance(res, tuple) else (res,)
    if len(outs) > 1 and node.num_outputs == 1:
        outs = outs[:1]
    return outs


def _nbytes(v):
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    return int(getattr(v, "nbytes", _FOLD_MAX_BYTES + 1))


@register_pass("constant_fold", version=1)
def constant_fold(graph, is_train):
    const = dict(graph.constants)
    kept = []
    for node, in_names in graph.entries:
        if not (_fold_ok(node) and all(n in const for n in in_names)):
            kept.append((node, in_names))
            continue
        try:
            outs = _eval_outs(node, [const[n] for n in in_names])
            nbytes = sum(_nbytes(o) for o in outs)
        except Exception:
            kept.append((node, in_names))
            continue
        if nbytes > _FOLD_MAX_BYTES or len(outs) < node.num_outputs:
            kept.append((node, in_names))
            continue
        for nm, v in zip(node_out_names(node), outs):
            const[nm] = v
    if len(kept) == len(graph.entries):
        return graph
    return Graph(kept, graph.heads, const)


@register_pass("common_subexpr_merge", version=1)
def common_subexpr_merge(graph, is_train):
    rename = {}
    seen = {}
    entries = []
    for node, in_names in graph.entries:
        in_names = tuple(rename.get(n, n) for n in in_names)
        entries.append((node, in_names))
        if not _cse_ok(node, is_train):
            continue
        try:
            sig = (id(node.op), node.num_outputs, in_names, _attr_sig(node.attrs))
        except Exception:
            continue
        rep = seen.get(sig)
        if rep is None:
            seen[sig] = node
        else:  # later twin: consumers re-point at the representative
            for mine, theirs in zip(node_out_names(node), node_out_names(rep)):
                rename[mine] = theirs
    if not rename:
        return graph
    return Graph(entries, (rename.get(h, h) for h in graph.heads), graph.constants)


def _bn_affine_fn(data, gamma, beta, moving_mean, moving_var, *, eps, fix_gamma, axis):
    """BatchNorm on its moving statistics as a per-channel affine: the eval
    branch of ``ops.nn.batch_norm`` line for line (same expression order,
    so the outputs are equal bit for bit), without the batch statistics."""
    ax = axis % data.dim()
    bshape = [1] * data.dim()
    bshape[ax] = data.shape[ax]
    mean, var = moving_mean, moving_var
    g = torch.ones_like(gamma) if fix_gamma else gamma
    inv = torch.sqrt(var + eps)
    scale = (g / inv).to(data.dtype).reshape(bshape)
    shift = (beta - mean * g / inv).to(data.dtype).reshape(bshape)
    return data * scale + shift


_BN_AFFINE_OP = SynthOp("_bn_affine", _bn_affine_fn, attr_names=("eps", "fix_gamma", "axis"))


@register_pass("inference_rewrite", version=1)
def inference_rewrite(graph, is_train):
    if is_train:
        return graph
    rename = {}
    entries = []
    changed = False
    for node, in_names in graph.entries:
        in_names = tuple(rename.get(n, n) for n in in_names)
        opname = getattr(node.op, "name", "")
        explicit_train = bool(node.attrs.get("training"))
        if (opname == "Dropout" and node.num_outputs == 1 and in_names
                and not explicit_train and node_attr(node, "mode") != "always"):
            # eval-mode dropout is the identity: delete the node, point its
            # consumers (and any head) at its data input
            rename["%s_output" % node.name] = in_names[0]
            changed = True
            continue
        if (opname == "BatchNorm" and node.num_outputs == 1 and len(in_names) == 5
                and not explicit_train and not node.attrs.get("output_mean_var")):
            new = PlanNode(_BN_AFFINE_OP,
                           {"eps": node_attr(node, "eps"),
                            "fix_gamma": node_attr(node, "fix_gamma"),
                            "axis": node_attr(node, "axis")},
                           node.name)  # same name -> same output env name
            entries.append((new, in_names))
            changed = True
            continue
        entries.append((node, in_names))
    if not changed:
        return graph
    return Graph(entries, (rename.get(h, h) for h in graph.heads), graph.constants)


@register_pass("dead_node_elim", version=1)
def dead_node_elim(graph, is_train):
    entries = list(graph.entries)
    needed = set(graph.heads)
    keep = [False] * len(entries)
    for i in range(len(entries) - 1, -1, -1):
        node, in_names = entries[i]
        live = any(nm in needed for nm in node_out_names(node))
        if is_train and node.op.aux_update is not None and node.op.aux:
            live = True  # the moving-statistics update is a side effect
        if live:
            keep[i] = True
            needed.update(in_names)
    if all(keep):
        return graph
    kept = [e for e, k in zip(entries, keep) if k]
    used = set(graph.heads)
    for _, in_names in kept:
        used.update(in_names)
    return Graph(kept, graph.heads,
                 {k: v for k, v in graph.constants.items() if k in used})
