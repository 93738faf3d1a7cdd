"""Symbol — the lazy operator graph (counterpart of ``mxnet_tpu/symbol/symbol.py``).

A Symbol is an immutable node (op, inputs, attrs, name) that may expose
several outputs.  The graph is data; ``simple_bind`` allocates its arrays on
a device and returns an :class:`~mxnet_tpu_torch.executor.Executor`, which
runs the registry's functions over it in topological order.

Shape inference uses the ops' ``infer_params`` rules for parameter inputs
and runs every op on ``meta`` tensors for the rest: PyTorch computes the
output shapes and dtypes and no data, and the kernel wrappers take their
plain versions there, so nothing is launched.

Ported: ``Symbol``, ``Variable``, ``Group``, multi-output indexing,
``get_internals``, the ``list_*`` methods, user attributes (``attr=``,
``attr_dict``), ``infer_shape``, ``bind``, ``simple_bind``, ``+``, and
``tojson`` / ``save`` / ``load`` / ``load_json`` in the JSON the JAX package
writes, so a symbol file of either package loads in the other.
Composition and the other arithmetic operators are not.
"""
from __future__ import annotations

import json
import re
import threading

import torch

from ..context import resolve_device
from ..ops import registry as _registry

__all__ = ["Symbol", "Variable", "var", "Group", "NameManager", "load", "load_json"]

_TUPLE_RE = re.compile(r"^[\(\[].*[\)\]]$")


def parse_attr(value):
    """A string attribute -> a Python value (bool, None, tuple, int, float or
    the string), as ``mxnet_tpu/base.py parse_attr`` reads one."""
    if not isinstance(value, str):
        return value
    s = value.strip()
    low = s.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    if low == "none":
        return None
    if _TUPLE_RE.match(s):
        inner = s[1:-1].strip()
        if not inner:
            return ()
        return tuple(parse_attr(tok) for tok in inner.split(","))
    for kind in (int, float):
        try:
            return kind(s)
        except ValueError:
            pass
    return s


def attr_str(value):
    """An attribute value -> its string form (``mxnet_tpu/base.py
    attr_str``): tuples and lists as ``(a, b)``."""
    if isinstance(value, (tuple, list)):
        return "(" + ", ".join(attr_str(v) for v in value) + ")"
    return str(value)


class NameManager:
    """Automatic unique names for symbols: ``<hint><n>``, one counter per
    hint (reference python/mxnet/name.py; a thread-local current manager,
    replaced inside ``with NameManager():``)."""

    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        if name:
            return name
        n = self._counter.get(hint, 0)
        self._counter[hint] = n + 1
        return "%s%d" % (hint, n)

    def __enter__(self):
        self._old_manager = NameManager.current()
        NameManager._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        NameManager._current.value = self._old_manager

    @staticmethod
    def current():
        if not hasattr(NameManager._current, "value"):
            NameManager._current.value = NameManager()
        return NameManager._current.value


class Symbol:
    __slots__ = ("op", "inputs", "attrs", "name", "num_outputs", "out_index",
                 "_dtype_hint", "_user_attrs")

    def __init__(self, op, inputs, attrs, name, num_outputs=1, out_index=None,
                 user_attrs=None):
        self.op = op                  # OpDef, or None for variables and groups
        self.inputs = inputs          # list of Symbols (single-output views)
        self.attrs = attrs            # the op's attributes
        self.name = name
        self.num_outputs = num_outputs
        self.out_index = out_index    # set on one output of a multi-output node
        self._dtype_hint = None       # a variable's torch dtype, if not float32
        self._user_attrs = dict(user_attrs or {})  # __lr_mult__, __init__, ...

    # -- graph structure ----------------------------------------------------
    @property
    def is_var(self):
        return self.op is None and not self.is_group

    @property
    def is_group(self):
        return self.op is None and self.attrs.get("__group__", False)

    def __getitem__(self, index):
        if self.is_group:
            return self.inputs[index]
        if self.num_outputs == 1 and index == 0:
            return self
        if index >= self.num_outputs:
            raise IndexError(index)
        return Symbol(self.op, self.inputs, self.attrs, self.name,
                      self.num_outputs, out_index=index, user_attrs=self._user_attrs)

    def _base(self):
        """The node itself, ignoring an output selection."""
        if self.out_index is None:
            return self
        return Symbol(self.op, self.inputs, self.attrs, self.name, self.num_outputs,
                      user_attrs=self._user_attrs)

    def get_internals(self):
        """Every node output, in topological order, as a Group whose outputs
        are named ``<node>_output`` (reference symbol.py get_internals)."""
        seen = []
        names = set()

        def visit(s):
            base = s._base()
            if base.is_group:
                for inp in base.inputs:
                    visit(inp)
                return
            if base.name in names:
                return
            names.add(base.name)
            for inp in base.inputs:
                visit(inp)
            for i in range(base.num_outputs):
                seen.append(base[i] if base.num_outputs > 1 else base)

        visit(self)
        return Group(seen)

    # -- naming / listing ---------------------------------------------------
    def _outputs_of(self):
        """(node, output index) pairs that this symbol exposes."""
        if self.is_group:
            out = []
            for s in self.inputs:
                out.extend(s._outputs_of())
            return out
        if self.out_index is None and self.num_outputs > 1:
            return [(self[i], i) for i in range(self.num_outputs)]
        return [(self, self.out_index or 0)]

    def list_outputs(self):
        return [_sym_out_name(node) for node, _ in self._outputs_of()]

    def _walk(self):
        """Unique base nodes, inputs before their consumers (by name)."""
        visited = set()
        order = []

        def visit(s):
            base = s._base()
            if base.name in visited:
                return
            for inp in base.inputs:
                visit(inp)
            visited.add(base.name)
            order.append(base)

        for s in (self.inputs if self.is_group else [self]):
            visit(s)
        return order

    def list_arguments(self):
        """Free variables in DFS order, auxiliary states excluded."""
        aux = set(self.list_auxiliary_states())
        return [n.name for n in self._walk() if n.is_var and n.name not in aux]

    def list_auxiliary_states(self):
        """Variables that ops take as auxiliary states (BatchNorm's moving
        statistics)."""
        aux_names = []
        for node in self._walk():
            if node.op is not None and node.op.aux:
                for arg, inp in zip(_node_input_names(node), node.inputs):
                    if arg in node.op.aux and inp.is_var:
                        aux_names.append(inp.name)
        return aux_names

    def attr_dict(self):
        """{node name: {attribute: string}} over the graph: each node's user
        attributes (``__lr_mult__``, ``__wd_mult__``, ...) and op attributes
        (reference symbol.py attr_dict)."""
        out = {}
        for node in self._walk():
            d = dict(node._user_attrs)
            d.update((k, attr_str(v)) for k, v in node.attrs.items())
            if d:
                out[node.name] = d
        return out

    # -- shape inference ----------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from the shapes of some
        arguments, given positionally in ``list_arguments`` order or by
        name.  Raises ValueError naming what stays unknown."""
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        known = {n: tuple(s) for n, s in zip(arg_names, args) if s is not None}
        known.update({k: tuple(v) for k, v in kwargs.items() if v is not None})
        metas = _infer_graph(self, known)
        out_names = self.list_outputs()
        missing = [n for n in arg_names + aux_names + out_names if n not in metas]
        if missing:
            raise ValueError("infer_shape incomplete; unknown for: %s" % missing)
        shape = lambda n: tuple(metas[n].shape)
        return ([shape(n) for n in arg_names], [shape(n) for n in out_names],
                [shape(n) for n in aux_names])

    # -- arithmetic -----------------------------------------------------------
    def __add__(self, other):
        if not isinstance(other, Symbol):
            return NotImplemented  # Symbol + scalar (_plus_scalar) is not ported
        name = NameManager.current().get(None, "broadcast_add")
        return Symbol(_registry.get("broadcast_add"), [self, other], {}, name)

    def __repr__(self):
        return "<Symbol %s>" % self.name

    # -- binding --------------------------------------------------------------
    def bind(self, device=None, args=None, args_grad=None, grad_req="write",
             aux_states=None):
        """Bind to given arrays (reference symbol.py bind): ``args``,
        ``args_grad`` and ``aux_states`` are dicts by name or lists in
        ``list_arguments`` / ``list_auxiliary_states`` order.  A tensor on
        ``device`` is used as it is (the executor updates it in place),
        anything else is copied there.  ``grad_req`` ("write", "add" or
        "null") is one for all or a dict / list per argument.

        ``device`` is None (CUDA), a string or a ``torch.device``; without
        CUDA it raises unless ``device="cpu"``."""
        from ..executor import Executor

        dev = resolve_device(device)
        names, aux_names = self.list_arguments(), self.list_auxiliary_states()
        return Executor(self, dev, _named(args, names, "args", dev),
                        _named(args_grad, names, "args_grad", dev),
                        grad_req, _named(aux_states, aux_names, "aux_states", dev))

    def simple_bind(self, device=None, grad_req="write", **shapes):
        """Allocate every argument and auxiliary state from shape inference,
        zero-filled on ``device``, and bind (reference symbol.py:1287).
        Gradient buffers are allocated for every argument unless
        ``grad_req`` is ``"null"``; ``grad_req`` as ``bind``.

        ``device`` is None (CUDA), a string or a ``torch.device``; without
        CUDA it raises unless ``device="cpu"``.  Variables marked with a
        dtype (the int8 weights of a quantized symbol) are allocated in it.
        """
        from ..executor import Executor

        dev = resolve_device(device)
        metas = self._arg_metas(shapes)
        alloc = lambda n: torch.zeros(metas[n].shape, dtype=metas[n].dtype, device=dev)
        names = self.list_arguments()
        grads = None if grad_req == "null" else {n: alloc(n) for n in names}
        return Executor(self, dev, {n: alloc(n) for n in names}, grads, grad_req,
                        {n: alloc(n) for n in self.list_auxiliary_states()})

    # -- serialization --------------------------------------------------------
    def tojson(self):
        """The graph as JSON, in the JAX package's format (reference
        Symbol::ToJSON): ``{"nodes": [{op, name, attrs, inputs}], "heads":
        [[node, output, 0]], "attrs": {"mxnet_tpu_version": 1}}``, attribute
        values as strings."""
        nodes, index = [], {}
        for node in self._walk():
            inputs = []
            for inp in node.inputs:
                inputs.append([index[inp.name], inp.out_index or 0, 0])
            nodes.append({"op": node.op.name if node.op else "null", "name": node.name,
                          "attrs": {k: attr_str(v) for k, v in node.attrs.items()},
                          "inputs": inputs})
            index[node.name] = len(nodes) - 1
        heads = [[index[node.name], idx, 0] for node, idx in self._outputs_of()]
        return json.dumps({"nodes": nodes, "heads": heads,
                           "attrs": {"mxnet_tpu_version": 1}}, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    def _arg_metas(self, shapes):
        """{name: meta tensor} of every argument and auxiliary state, in the
        shape and dtype that ``simple_bind`` allocates."""
        metas = _infer_graph(self, {k: tuple(v) for k, v in shapes.items()})
        names = self.list_arguments() + self.list_auxiliary_states()
        missing = [n for n in names if n not in metas]
        if missing:
            raise ValueError("no shape known for %s" % missing)
        return {n: metas[n] for n in names}


def _sym_out_name(s):
    """The environment name of a single-output view: a variable's name, or
    ``<node>_output`` / ``<node>_output<i>``."""
    if s.is_var:
        return s.name
    if s.num_outputs > 1:
        return "%s_output%d" % (s.name, s.out_index or 0)
    return "%s_output" % s.name


def _node_input_names(node):
    if node.op.inputs_fn is not None:
        return node.op.inputs_fn(node.attrs)
    return node.op.arg_names[: len(node.inputs)]


def _num_outputs_of(opdef, attrs):
    if opdef.name in ("_contrib_quantize", "_contrib_requantize") or \
            opdef.name.startswith("_contrib_quantized_"):
        return 3  # (values, min_range, max_range)
    if opdef.name == "BatchNorm" and attrs.get("output_mean_var"):
        return 3  # (out, mean, var)
    return 1


def _on_device(v, dev):
    """A tensor on ``dev`` as it is; anything else copied there (float64
    arrays as float32, as the JAX package's ``nd.array``)."""
    t = torch.as_tensor(v, device=dev)
    return t.float() if not isinstance(v, torch.Tensor) and t.dtype == torch.float64 else t


def _named(arrays, names, what, dev):
    """A dict by name, or a list in ``names`` order (None entries dropped),
    -> {name: tensor on ``dev``}; None -> {}."""
    if arrays is None:
        return {}
    if not isinstance(arrays, dict):
        if len(arrays) != len(names):
            raise ValueError("%s has %d arrays, expected %d (%s)"
                             % (what, len(arrays), len(names), names))
        arrays = {n: a for n, a in zip(names, arrays) if a is not None}
    return {k: _on_device(v, dev) for k, v in arrays.items()}


def _make_sym_op_func(opdef, public_name):
    """The ``sym.<op>`` builder of a registered op: tensor inputs as
    positional arguments or keywords, attributes as keywords; a missing
    parameter input becomes a Variable named ``<node>_<arg>``."""

    def sym_func(*args, **kwargs):
        name = kwargs.pop("name", None)
        user_attrs = kwargs.pop("attr", None)
        named = dict(zip(opdef.arg_names, args))
        attrs = {}
        for k, v in kwargs.items():
            if k in opdef.arg_names and isinstance(v, Symbol):
                named[k] = v
            elif k not in ("cudnn_tune", "cudnn_off", "workspace", "__layout__"):
                attrs[k] = parse_attr(v)
        if opdef.inputs_fn is not None:
            needed = opdef.inputs_fn(attrs)
        else:
            needed = [a for a in opdef.arg_names if a not in opdef.defaults or a in named]
        name = NameManager.current().get(name, opdef.hint)
        inputs = [named[a] if a in named else Variable("%s_%s" % (name, a))
                  for a in needed]
        return Symbol(opdef, inputs, attrs, name, _num_outputs_of(opdef, attrs),
                      user_attrs=user_attrs)

    sym_func.__name__ = public_name.lstrip("_")
    sym_func.__qualname__ = sym_func.__name__
    sym_func.__doc__ = opdef.__doc__
    sym_func.opdef = opdef
    return sym_func


def Variable(name, attr=None):
    """A symbolic variable; ``attr`` its user attributes (``{"__lr_mult__":
    "0.1"}``, ``{"__init__": initializer.dumps()}``)."""
    return Symbol(None, [], {}, name, user_attrs=attr)


var = Variable


def Group(symbols):
    """Several symbols as one multi-output symbol (reference sym.Group)."""
    return Symbol(None, list(symbols), {"__group__": True}, "_group")


def load(fname):
    """A symbol from a JSON file of either package (``Symbol.save``)."""
    with open(fname) as f:
        return load_json(f.read())


def load_json(json_str):
    """A symbol from ``tojson``'s output (``mxnet_tpu/symbol/symbol.py
    load_json``); every op must be registered in the port."""
    data = json.loads(json_str)
    built = []
    for rec in data["nodes"]:
        if rec["op"] == "null":
            built.append(Variable(rec["name"]))
            continue
        opdef = _registry.get(rec["op"])
        attrs = {k: parse_attr(v) for k, v in rec.get("attrs", {}).items()}
        inputs = [built[i][o] if built[i].num_outputs > 1 else built[i]
                  for i, o, _ in rec["inputs"]]
        built.append(Symbol(opdef, inputs, attrs, rec["name"],
                            _num_outputs_of(opdef, attrs)))
    heads = [built[i][o] if built[i].num_outputs > 1 else built[i]
             for i, o, _ in data["heads"]]
    return heads[0] if len(heads) == 1 else Group(heads)


def _infer_graph(sym, known_shapes):
    """Walk the graph once on ``meta`` tensors -> {environment name: meta
    tensor} for every variable and node output whose shape follows from
    ``known_shapes``.  Parameter variables get their shapes from the
    consuming op's ``infer_params`` rule."""
    metas = {}
    meta = lambda shape, var: torch.empty(shape, dtype=var._dtype_hint or torch.float32,
                                          device="meta")
    for node in sym._walk():
        if node.is_var:
            if node.name in known_shapes:
                metas[node.name] = meta(known_shapes[node.name], node)
            continue
        in_names = [_sym_out_name(i) for i in node.inputs]
        arg_names = _node_input_names(node)
        if node.op.infer_params is not None:
            known = {a: tuple(metas[n].shape) for n, a in zip(in_names, arg_names)
                     if n in metas}
            try:
                params = node.op.infer_params(node.attrs, known)
            except KeyError:  # the rule needs an input shape not known yet
                params = {}
            for inp, n, a in zip(node.inputs, in_names, arg_names):
                if n not in metas and inp.is_var and a in params:
                    metas[n] = meta(params[a], inp)
        if not all(n in metas for n in in_names):
            continue
        try:
            res = node.op.fn(*[metas[n] for n in in_names], **node.attrs)
        except (RuntimeError, TypeError, ValueError, NotImplementedError) as e:
            raise ValueError("shape inference failed at op %s(%s): %s"
                             % (node.op.name, node.name, e)) from e
        outs = res if isinstance(res, tuple) else (res,)
        for i, o in enumerate(outs[: node.num_outputs]):
            metas[_sym_out_name(node[i] if node.num_outputs > 1 else node)] = o
    return metas
