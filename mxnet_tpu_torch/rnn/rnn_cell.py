"""Symbol-based RNN cells (counterpart of ``mxnet_tpu/rnn/rnn_cell.py``;
reference python/mxnet/rnn/rnn_cell.py: BaseRNNCell :108, RNNCell :362,
LSTMCell :408, GRUCell :469, FusedRNNCell :536, SequentialRNNCell :748,
DropoutCell :827, ModifierCell :867, ZoneoutCell :909, ResidualCell :957,
BidirectionalCell :998).

A cell builds symbols: ``unroll`` writes one step's graph per time step
(the executor runs it node by node), and ``FusedRNNCell`` emits the
registry's ``RNN`` op over the whole sequence.  Their parameter names and
the fused cell's packed vector are the JAX package's, so a checkpoint
crosses the packages.  The weight helpers (``unpack_weights`` /
``pack_weights``) take and give CPU tensors (or anything numpy reads).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import symbol
from ..initializer import LSTMBias
from ..symbol import Symbol


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)


def _tensor(a):
    return torch.from_numpy(np.ascontiguousarray(a).copy())


class _DeferredZeros:
    """Unknown-batch zero state (the reference's shape-0 convention,
    rnn_cell.py:108 begin_state): ``begin_state(func=sym.zeros)`` with a 0
    in the shape yields this placeholder, which ``unroll`` resolves to
    ``_zeros_rows`` against the sequence's inputs."""

    def __init__(self, name, shape, dtype=None):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = dtype

    def resolve(self, batch_ref):
        """batch_ref: a Symbol whose axis 0 is the batch dimension."""
        bidx = self.shape.index(0)
        tail = tuple(s for i, s in enumerate(self.shape) if i != bidx)
        kw = {} if self.dtype is None else {"dtype": self.dtype}
        z = symbol._zeros_rows(batch_ref, tail=tail, name=self.name, **kw)
        if bidx:
            ndim = len(self.shape)
            axes = tuple(list(range(1, bidx + 1)) + [0] + list(range(bidx + 1, ndim)))
            z = symbol.transpose(z, axes=axes)
        return z


def _resolve_states(states, batch_ref):
    return [s.resolve(batch_ref) if isinstance(s, _DeferredZeros) else s for s in states]


__all__ = [
    "RNNParams",
    "BaseRNNCell",
    "RNNCell",
    "LSTMCell",
    "GRUCell",
    "FusedRNNCell",
    "SequentialRNNCell",
    "DropoutCell",
    "ModifierCell",
    "ZoneoutCell",
    "ResidualCell",
    "BidirectionalCell",
]


class RNNParams:
    """Container for cell parameter symbols (reference rnn_cell.py:78)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


def _normalize_sequence(length, inputs, layout, merge, in_layout=None):
    """(reference rnn_cell.py:51) Returns (list-or-merged inputs, axis)."""
    assert inputs is not None
    axis = layout.find("T")
    in_axis = in_layout.find("T") if in_layout is not None else axis
    if isinstance(inputs, Symbol):
        if merge is False:
            if len(inputs.list_outputs()) != 1:
                raise ValueError("unroll doesn't allow grouped symbol as input")
            inputs = list(
                symbol.split(inputs, axis=in_axis, num_outputs=length, squeeze_axis=1)
            )
    else:
        assert length is None or len(inputs) == length
        if merge is True:
            inputs = [symbol.expand_dims(i, axis=axis) for i in inputs]
            inputs = symbol.Concat(*inputs, dim=axis)
    if isinstance(inputs, Symbol) and axis != in_axis:
        perm = [0, 1, 2]
        perm[axis], perm[in_axis] = perm[in_axis], perm[axis]
        inputs = symbol.transpose(inputs, axes=tuple(perm))
    return inputs, axis


class BaseRNNCell:
    """Abstract RNN cell (reference rnn_cell.py:108)."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [ele["shape"] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=None, batch_ref=None, **kwargs):
        """Initial states.  With ``batch_ref`` (a Symbol carrying the batch
        dim on axis 0) states are batch-dynamic zeros; otherwise they are
        bindable Variables with partial shape hints (the reference's shape-0
        convention)."""
        assert not self._modified, "After applying modifier cells the base cell cannot be called directly."
        states = []
        for info in self.state_info:
            self._init_counter += 1
            name = "%sbegin_state_%d" % (self._prefix, self._init_counter)
            if func is not None:
                kw = dict(kwargs)
                if info is not None:
                    kw.update(info)
                shape = kw.get("shape")
                if shape is not None and any(s == 0 for s in shape):
                    # reference shape-0 = unknown batch; only zeros can be
                    # deferred to bind time
                    if func is symbol.zeros or getattr(func, "__name__", "") == "zeros":
                        state = _DeferredZeros(name, shape, dtype=kw.get("dtype"))
                    else:
                        raise ValueError(
                            "begin_state func=%r got partial shape %s (0 = unknown "
                            "batch). Only sym.zeros supports deferred batch; pass a "
                            "fully-specified shape or use begin_state() inside "
                            "unroll." % (func, (shape,))
                        )
                else:
                    state = func(name=name, **kw)
            elif batch_ref is not None:
                tail = tuple(info["shape"][1:])
                state = symbol._zeros_rows(batch_ref, tail=tail, name=name)
            else:
                v = symbol.Variable(name)
                v._shape_hint = tuple(info["shape"])
                state = v
            states.append(state)
        return states

    def unpack_weights(self, args):
        """Fused-format -> per-gate weights (reference :232); identity for
        unfused cells with per-gate names."""
        args = dict(args)
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group_name in ["i2h", "h2h"]:
            weight = args.pop("%s%s_weight" % (self._prefix, group_name))
            bias = args.pop("%s%s_bias" % (self._prefix, group_name))
            w = _np(weight)
            b = _np(bias)
            for j, gate in enumerate(self._gate_names):
                wname = "%s%s%s_weight" % (self._prefix, group_name, gate)
                bname = "%s%s%s_bias" % (self._prefix, group_name, gate)
                args[wname] = _tensor(w[j * h : (j + 1) * h].copy())
                args[bname] = _tensor(b[j * h : (j + 1) * h].copy())
        return args

    def pack_weights(self, args):
        """Inverse of unpack_weights (reference :252)."""
        args = dict(args)
        if not self._gate_names:
            return args
        for group_name in ["i2h", "h2h"]:
            ws, bs = [], []
            for gate in self._gate_names:
                wname = "%s%s%s_weight" % (self._prefix, group_name, gate)
                bname = "%s%s%s_bias" % (self._prefix, group_name, gate)
                w = args.pop(wname)
                b = args.pop(bname)
                ws.append(_np(w))
                bs.append(_np(b))
            args["%s%s_weight" % (self._prefix, group_name)] = _tensor(np.concatenate(ws))
            args["%s%s_bias" % (self._prefix, group_name)] = _tensor(np.concatenate(bs))
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC", merge_outputs=None):
        """Unrolls the cell for ``length`` steps (reference :276)."""
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state(batch_ref=inputs[0])
        states = _resolve_states(begin_state, inputs[0])
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        outputs, _ = _normalize_sequence(length, outputs, layout, merge_outputs)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


class RNNCell(BaseRNNCell):
    """Elman RNN cell (reference rnn_cell.py:362)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        states = _resolve_states(states, inputs)
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(
            data=inputs, weight=self._iW, bias=self._iB,
            num_hidden=self._num_hidden, name="%si2h" % name,
        )
        h2h = symbol.FullyConnected(
            data=states[0], weight=self._hW, bias=self._hB,
            num_hidden=self._num_hidden, name="%sh2h" % name,
        )
        output = self._get_activation(i2h + h2h, self._activation, name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell (reference rnn_cell.py:408)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None, forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        self._iB = self.params.get("i2h_bias", init=LSTMBias(forget_bias=forget_bias))
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [
            {"shape": (0, self._num_hidden), "__layout__": "NC"},
            {"shape": (0, self._num_hidden), "__layout__": "NC"},
        ]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        states = _resolve_states(states, inputs)
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(
            data=inputs, weight=self._iW, bias=self._iB,
            num_hidden=self._num_hidden * 4, name="%si2h" % name,
        )
        h2h = symbol.FullyConnected(
            data=states[0], weight=self._hW, bias=self._hB,
            num_hidden=self._num_hidden * 4, name="%sh2h" % name,
        )
        gates = i2h + h2h
        slices = list(symbol.SliceChannel(gates, num_outputs=4, name="%sslice" % name))
        in_gate = symbol.Activation(slices[0], act_type="sigmoid")
        forget_gate = symbol.Activation(slices[1], act_type="sigmoid")
        in_transform = symbol.Activation(slices[2], act_type="tanh")
        out_gate = symbol.Activation(slices[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * symbol.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell (reference rnn_cell.py:469)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        states = _resolve_states(states, inputs)
        name = "%st%d_" % (self._prefix, self._counter)
        prev_h = states[0]
        i2h = symbol.FullyConnected(
            data=inputs, weight=self._iW, bias=self._iB,
            num_hidden=self._num_hidden * 3, name="%si2h" % name,
        )
        h2h = symbol.FullyConnected(
            data=prev_h, weight=self._hW, bias=self._hB,
            num_hidden=self._num_hidden * 3, name="%sh2h" % name,
        )
        i2h_r, i2h_z, i2h = list(symbol.SliceChannel(i2h, num_outputs=3))
        h2h_r, h2h_z, h2h = list(symbol.SliceChannel(h2h, num_outputs=3))
        reset_gate = symbol.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = symbol.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = symbol.Activation(i2h + reset_gate * h2h, act_type="tanh")
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Fused multi-layer RNN over the registry ``RNN`` op (reference :536;
    ``ops/rnn.py``)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm", bidirectional=False,
                 dropout=0.0, get_next_state=False, forget_bias=1.0,
                 prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._forget_bias = forget_bias
        self._parameter = self.params.get("parameters")

    @property
    def state_info(self):
        b = self._bidirectional + 1
        n = (self._mode == "lstm") + 1
        return [
            {"shape": (b * self._num_layers, 0, self._num_hidden), "__layout__": "LNC"}
            for _ in range(n)
        ]

    @property
    def _gate_names(self):
        return {
            "rnn_relu": [""],
            "rnn_tanh": [""],
            "lstm": ["_i", "_f", "_c", "_o"],
            "gru": ["_r", "_z", "_o"],
        }[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def begin_state(self, func=None, batch_ref=None, **kwargs):
        if batch_ref is None or func is not None:
            return super().begin_state(func=func, batch_ref=batch_ref, **kwargs)
        # batch axis is axis 1 here (LNC) — build (L, N, C) zeros from ref
        states = []
        b = self._bidirectional + 1
        n = (self._mode == "lstm") + 1
        for i in range(n):
            z = symbol._zeros_rows(
                batch_ref, tail=(b * self._num_layers, self._num_hidden)
            )
            states.append(symbol.transpose(z, axes=(1, 0, 2)))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC", merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, True)
        if axis == 1:  # NTC -> TNC for the RNN op
            inputs = symbol.transpose(inputs, axes=(1, 0, 2))
        batch_ref_nc = symbol.transpose(inputs, axes=(1, 0, 2))
        if begin_state is None:
            begin_state = self.begin_state(batch_ref=batch_ref_nc)
        states = _resolve_states(begin_state, batch_ref_nc)
        kwargs = {}
        if self._mode == "lstm":
            kwargs["state_cell"] = states[1]
        rnn = symbol.RNN(
            data=inputs,
            parameters=self._parameter,
            state=states[0],
            mode=self._mode,
            state_size=self._num_hidden,
            num_layers=self._num_layers,
            bidirectional=self._bidirectional,
            p=self._dropout,
            state_outputs=self._get_next_state,
            name="%srnn" % self._prefix,
            **kwargs,
        )
        if not self._get_next_state:
            outputs, states = rnn[0], []
        elif self._mode == "lstm":
            outputs, states = rnn[0], [rnn[1], rnn[2]]
        else:
            outputs, states = rnn[0], [rnn[1]]
        if layout == "NTC":
            outputs = symbol.transpose(outputs, axes=(1, 0, 2))
        if merge_outputs is False:
            outputs = list(
                symbol.split(outputs, axis=layout.find("T"), num_outputs=length, squeeze_axis=1)
            )
        return outputs, states

    def _slot_names(self):
        """Per-(layer, direction) unfused prefixes, enumeration order matching
        the fused vector (ops/rnn.py _unpack_params)."""
        names = []
        for i in range(self._num_layers):
            if self._bidirectional:
                names.append("%sl%d_" % (self._prefix, i))
                names.append("%sr%d_" % (self._prefix, i))
            else:
                names.append("%sl%d_" % (self._prefix, i))
        return names

    def unpack_weights(self, args):
        """Fused parameter vector -> per-layer i2h/h2h arrays matching
        unfuse() naming (reference FusedRNNCell.unpack_weights :621)."""
        args = dict(args)
        p = args.pop("%sparameters" % self._prefix)
        p = _np(p)
        h = self._num_hidden
        g = self._num_gates
        d = 2 if self._bidirectional else 1
        L = self._num_layers
        rest = (L - 1) * d * g * h * (d * h + h + 2)
        isz = (p.size - rest) // (d * g * h) - h - 2
        slots = self._slot_names()
        pos = 0
        for li, slot in enumerate(slots):
            layer = li // d
            in_size = isz if layer == 0 else d * h
            wi = p[pos : pos + g * h * in_size].reshape(g * h, in_size)
            pos += g * h * in_size
            wh = p[pos : pos + g * h * h].reshape(g * h, h)
            pos += g * h * h
            args[slot + "i2h_weight"] = _tensor(wi.copy())
            args[slot + "h2h_weight"] = _tensor(wh.copy())
        for slot in slots:
            args[slot + "i2h_bias"] = _tensor(p[pos : pos + g * h].copy())
            pos += g * h
            args[slot + "h2h_bias"] = _tensor(p[pos : pos + g * h].copy())
            pos += g * h
        return args

    def pack_weights(self, args):
        """Inverse of unpack_weights (reference :652)."""
        args = dict(args)
        slots = self._slot_names()
        chunks = []
        for slot in slots:
            wi = args.pop(slot + "i2h_weight")
            wh = args.pop(slot + "h2h_weight")
            chunks.append(_np(wi).ravel())
            chunks.append(_np(wh).ravel())
        for slot in slots:
            bi = args.pop(slot + "i2h_bias")
            bh = args.pop(slot + "h2h_bias")
            chunks.append(_np(bi).ravel())
            chunks.append(_np(bh).ravel())
        args["%sparameters" % self._prefix] = _tensor(np.concatenate(chunks))
        return args

    def unfuse(self):
        """Equivalent stack of unfused cells (reference :676)."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden, activation="relu", prefix=p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden, activation="tanh", prefix=p),
            "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p),
            "gru": lambda p: GRUCell(self._num_hidden, prefix=p),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(
                    BidirectionalCell(
                        get_cell("%sl%d_" % (self._prefix, i)),
                        get_cell("%sr%d_" % (self._prefix, i)),
                        output_prefix="%sbi_l%d_" % (self._prefix, i),
                    )
                )
            else:
                stack.add(get_cell("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout, prefix="%s_dropout%d_" % (self._prefix, i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Stacks cells (reference rnn_cell.py:748)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells = []
        self._override_cell_params = params is not None

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            state = states[p : p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC", merge_outputs=None):
        self.reset()
        num_cells = len(self._cells)
        if begin_state is None:
            inputs_list, _ = _normalize_sequence(length, inputs, layout, False)
            begin_state = self.begin_state(batch_ref=inputs_list[0])
            inputs = inputs_list
        p = 0
        next_states = []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            states = begin_state[p : p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs,
            )
            next_states.extend(states)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """Dropout on outputs (reference rnn_cell.py:827)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(data=inputs, p=self.dropout)
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC", merge_outputs=None):
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, merge_outputs)
        if isinstance(inputs, Symbol):
            return self(inputs, begin_state if begin_state is not None else [])
        return super().unroll(
            length, inputs, begin_state=begin_state, layout=layout, merge_outputs=merge_outputs
        )


class ModifierCell(BaseRNNCell):
    """Wraps a cell to modify its behavior (reference rnn_cell.py:867)."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=None, batch_ref=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, batch_ref=batch_ref, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)

    def __call__(self, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (reference rnn_cell.py:909)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, FusedRNNCell), "FusedRNNCell doesn't support zoneout."
        assert not isinstance(base_cell, BidirectionalCell), "BidirectionalCell doesn't support zoneout since it doesn't support step."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell, p_outputs, p_states = self.base_cell, self.zoneout_outputs, self.zoneout_states
        states = _resolve_states(states, inputs)
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return symbol.Dropout(data=symbol.ones_like(like), p=p)

        prev_output = self.prev_output if self.prev_output is not None else symbol.zeros_like(next_output)
        output = (
            symbol.where(mask(p_outputs, next_output), next_output, prev_output)
            if p_outputs != 0.0
            else next_output
        )
        states = (
            [symbol.where(mask(p_states, new_s), new_s, old_s) for new_s, old_s in zip(next_states, states)]
            if p_states != 0.0
            else next_states
        )
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """Adds input to output (reference rnn_cell.py:957)."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = symbol.elemwise_add(output, inputs)
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC", merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs,
        )
        self.base_cell._modified = True
        merge_outputs = isinstance(outputs, Symbol) if merge_outputs is None else merge_outputs
        inputs, _ = _normalize_sequence(length, inputs, layout, merge_outputs)
        if merge_outputs:
            outputs = symbol.elemwise_add(outputs, inputs)
        else:
            outputs = [symbol.elemwise_add(o, i) for o, i in zip(outputs, inputs)]
        return outputs, states


class BidirectionalCell(BaseRNNCell):
    """Forward + backward cells over the sequence (reference rnn_cell.py:998)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(prefix="", params=params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        if self._override_cell_params:
            assert l_cell._own_params and r_cell._own_params
            l_cell.params._params.update(self.params._params)
            r_cell.params._params.update(self.params._params)
        self.params._params.update(l_cell.params._params)
        self.params._params.update(r_cell.params._params)
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError("Bidirectional cannot be stepped. Please use unroll")

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC", merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state(batch_ref=inputs[0])
        states = begin_state
        l_cell, r_cell = self._cells
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[: len(l_cell.state_info)],
            layout=layout, merge_outputs=merge_outputs,
        )
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[len(l_cell.state_info):],
            layout=layout, merge_outputs=merge_outputs,
        )
        if merge_outputs is None:
            merge_outputs = isinstance(l_outputs, Symbol) and isinstance(r_outputs, Symbol)
            l_outputs, _ = _normalize_sequence(None, l_outputs, layout, merge_outputs)
            r_outputs, _ = _normalize_sequence(None, r_outputs, layout, merge_outputs)
        if merge_outputs:
            r_outputs = symbol.reverse(r_outputs, axis=layout.find("T"))
            outputs = symbol.Concat(l_outputs, r_outputs, dim=2, name="%sout" % self._output_prefix)
        else:
            outputs = [
                symbol.Concat(l_o, r_o, dim=1, name="%st%d" % (self._output_prefix, i))
                for i, (l_o, r_o) in enumerate(zip(l_outputs, reversed(r_outputs)))
            ]
        states = l_states + r_states
        return outputs, states
