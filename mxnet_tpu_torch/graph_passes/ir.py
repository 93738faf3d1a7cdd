"""Graph IR of the pass layer (counterpart of ``mxnet_tpu/graph_passes/ir.py``).

The unit of optimisation is the execution plan the Executor evaluates: a
topologically ordered list of ``(node, in_names)`` entries plus the ordered
head names, exactly what :func:`capture` makes of a Symbol and
``Executor._run`` walks.  :class:`Graph` holds that plan as an immutable
value (tuples all the way down), so every pass is a pure function
``Graph -> Graph`` and the captured plan is never changed in place:
``MXNET_GRAPH_PASSES=0`` runs the captured plan as it is.

Three kinds of node appear in a plan:

* captured ``Symbol`` nodes (everything ``capture`` emits);
* :class:`PlanNode`, a node a pass made (the inference rewrite's
  BatchNorm-as-affine) carrying a :class:`SynthOp`.  Both have the
  attributes ``Executor._run`` reads (``op.fn``, ``op.attr_names``,
  ``op.aux``, ``op.aux_update``, ``attrs``, ``name``, ``num_outputs``), so
  the executor needs no case split;
* baked constants: nodes folded away, their output values moved into
  ``Graph.constants`` (seeded into the evaluation environment before any
  node runs; the executor moves them to its device once, when it builds
  the plan).

The output names are those ``Executor._run`` binds: ``<node>_output`` or
``<node>_output<i>`` (``symbol.symbol._sym_out_name``), a variable by its
name.
"""
from __future__ import annotations

__all__ = ["Graph", "PlanNode", "SynthOp", "capture", "node_out_names",
           "node_call_attrs", "node_attr", "REDUCE", "EXP_RANGE",
           "CANCELLATION", "NEUTRAL", "SENSITIVITY_VERSION",
           "op_sensitivity", "stochastic"]


def node_attr(node, key, default=None):
    """A plan node's attribute with the op's default filled in: the one
    resolution of attributes with defaults, shared by
    :func:`op_sensitivity`, the graph analyzers and the numerics interval
    transfer functions."""
    defaults = getattr(node.op, "defaults", {}) or {}
    return node.attrs.get(key, defaults.get(key, default))


def stochastic(op):
    """Does the op draw random numbers?  The port's stochastic ops (Dropout)
    take a ``torch.Generator`` attribute where the JAX ops take a PRNG
    ``key``."""
    return "generator" in getattr(op, "attr_names", ())


def node_call_attrs(node, generator, is_train):
    """The attributes a plan node's ``op.fn`` is called with: the one place
    that fills in the random stream (``generator``, for a stochastic node
    that names none), the mode (``training``), and, in training, asks an
    op that updates auxiliary states from its batch statistics
    (BatchNorm's ``output_mean_var``, the ``(out, mean, var)`` its
    ``aux_update`` reads; an op without the attribute updates them from its
    output).  Shared by ``Executor`` (real evaluation), calibration and
    ``analysis._abstract_walk`` (meta tensors), so the abstract walk cannot
    drift from what runs."""
    names = node.op.attr_names
    attrs = dict(node.attrs)
    if "generator" in names and "generator" not in attrs:
        attrs["generator"] = generator
    if "training" in names and "training" not in attrs:
        attrs["training"] = is_train
    if is_train and node.op.aux_update is not None and "output_mean_var" in names:
        attrs["output_mean_var"] = True
    return attrs


# -- numeric-sensitivity registry ---------------------------------------------
#
# Kept beside ``node_call_attrs`` on purpose, as in the JAX package: both say
# how a plan node evaluates, and the numerics analyzer consults this table
# while walking plans.  The table, its classes and its version are the JAX
# package's, so that cast plans and their fingerprints agree between the two.
#
#   REDUCE        accumulation over many elements (sum, mean, dot, conv,
#                 BN statistics): bf16 inputs are fine, the accumulator must
#                 stay fp32.
#   EXP_RANGE     exp / log family: safe in low precision only where the
#                 interval analysis bounds the input.
#   CANCELLATION  subtraction of near-equal quantities (variance chains,
#                 normalization statistics): keep fp32.
#   NEUTRAL       element-local, monotone or data-movement ops.
#
# Bump SENSITIVITY_VERSION on any change of the table: it enters every cast
# plan's fingerprint.

REDUCE = "reduce"
EXP_RANGE = "exp_range"
CANCELLATION = "cancellation"
NEUTRAL = "neutral"

SENSITIVITY_VERSION = 1

_OP_SENSITIVITY = {
    # accumulating reductions + matmul/conv contractions
    "sum": REDUCE, "mean": REDUCE, "prod": REDUCE, "nansum": REDUCE,
    "nanprod": REDUCE, "add_n": REDUCE, "norm": REDUCE,
    "_square_sum": REDUCE, "dot": REDUCE, "batch_dot": REDUCE,
    "FullyConnected": REDUCE, "Convolution": REDUCE, "Deconvolution": REDUCE,
    "Correlation": REDUCE, "L2Normalization": REDUCE,
    "softmax_cross_entropy": REDUCE, "_linalg_gemm": REDUCE,
    "_linalg_gemm2": REDUCE, "_linalg_syrk": REDUCE,
    "_linalg_sumlogdiag": REDUCE, "khatri_rao": REDUCE,
    # exp/log-family range hazards
    "exp": EXP_RANGE, "expm1": EXP_RANGE, "log": EXP_RANGE,
    "log1p": EXP_RANGE, "log2": EXP_RANGE, "log10": EXP_RANGE,
    "softmax": EXP_RANGE, "log_softmax": EXP_RANGE, "softmin": EXP_RANGE,
    "SoftmaxActivation": EXP_RANGE, "SoftmaxOutput": EXP_RANGE,
    "gamma": EXP_RANGE, "gammaln": EXP_RANGE, "sinh": EXP_RANGE,
    "cosh": EXP_RANGE, "_power": EXP_RANGE, "broadcast_power": EXP_RANGE,
    "_rpower_scalar": EXP_RANGE,
    # catastrophic-cancellation chains (normalization statistics)
    "moments": CANCELLATION, "BatchNorm": CANCELLATION,
    "LayerNorm": CANCELLATION, "InstanceNorm": CANCELLATION,
    "LRN": CANCELLATION,
}


def op_sensitivity(node):
    """Sensitivity class of a plan node, resolving the attribute-dependent
    cases: average and sum pooling accumulate (max pooling only compares),
    Activation goes by ``act_type``.  Unknown ops are NEUTRAL."""
    opname = getattr(node.op, "name", "")
    if opname == "Pooling":
        pool = node_attr(node, "pool_type", "max")
        return REDUCE if pool in ("avg", "sum", "lp") else NEUTRAL
    if opname == "Activation":
        act = node.attrs.get("act_type")
        if act in ("softrelu",):  # log(1+exp(x))
            return EXP_RANGE
        return NEUTRAL
    return _OP_SENSITIVITY.get(opname, NEUTRAL)


class SynthOp:
    """Stand-in for an ``OpDef`` in pass-made nodes: only what
    ``Executor._run`` touches.  ``aux_update`` is always None (a made node
    never owns auxiliary states), so the executor's auxiliary-state branch,
    the one place that reads ``node.inputs``, never fires on one."""

    __slots__ = ("name", "fn", "attr_names")

    aux = ()
    aux_update = None
    mutates = ()
    inputs_fn = None
    infer_params = None
    arg_names = ()
    defaults = {}

    def __init__(self, name, fn, attr_names=()):
        self.name = name
        self.fn = fn
        self.attr_names = tuple(attr_names)

    def __repr__(self):
        return "SynthOp(%s)" % self.name


class PlanNode:
    """A pass-made plan node (the attributes of a captured Symbol node that
    the executor reads, without the graph structure)."""

    __slots__ = ("op", "attrs", "name", "num_outputs", "inputs")

    is_var = False

    def __init__(self, op, attrs, name, num_outputs=1):
        self.op = op
        self.attrs = dict(attrs)
        self.name = name
        self.num_outputs = num_outputs
        self.inputs = []

    def __repr__(self):
        return "PlanNode(%s:%s)" % (self.op.name, self.name)


def node_out_names(node):
    """The environment names a plan node's outputs bind to."""
    if node.num_outputs > 1:
        return ["%s_output%d" % (node.name, i) for i in range(node.num_outputs)]
    return ["%s_output" % node.name]


def capture(symbol):
    """A Symbol DAG as ``(plan, head_names)``: ``plan`` is ``[(node,
    [input env name, ...]), ...]`` in topological order, variables left out
    (their values enter the environment from the bound arguments and
    auxiliary states); ``head_names`` is the env name of every output in
    ``symbol.list_outputs()`` order."""
    from ..symbol.symbol import _sym_out_name

    plan = [(node, [_sym_out_name(i) for i in node.inputs])
            for node in symbol._walk() if not node.is_var]
    return plan, symbol.list_outputs()


class Graph:
    """Immutable value of the pass layer: ``entries`` (topologically
    ordered ``(node, in_names)`` pairs), ``heads`` (ordered output env
    names) and ``constants`` (env name -> baked value, a numpy array or a
    tensor, seeded before evaluation)."""

    __slots__ = ("entries", "heads", "constants")

    def __init__(self, entries, heads, constants=None):
        self.entries = tuple((node, tuple(in_names)) for node, in_names in entries)
        self.heads = tuple(heads)
        self.constants = dict(constants) if constants else {}

    @property
    def n_nodes(self):
        return len(self.entries)

    def __repr__(self):
        return "Graph(%d nodes, %d heads, %d constants)" % (
            len(self.entries), len(self.heads), len(self.constants))
