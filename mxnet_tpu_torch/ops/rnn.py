"""The fused recurrent op ``RNN`` and ``split_v2`` (counterpart of
``mxnet_tpu/ops/rnn.py``; reference src/operator/rnn-inl.h).

``RNN`` runs every layer and direction over the whole sequence as the JAX
op's ``_run_layer`` does: the input projection is one product over all T
steps, then T steps of the h2h product and the gates.  The same code runs
on the CPU and on the card.  The parameters are the reference's packed
vector (``_unpack_params``: every layer's and direction's i2h and h2h
weights, then all their biases), so ``FusedRNNCell`` checkpoints cross the
packages.  Gate order: LSTM i, f, c, o; GRU r, z, o.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["rnn", "rnn_param_size", "split_v2"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _layer_param_size(mode, input_size, hidden, directions):
    return directions * _GATES[mode] * hidden * (input_size + hidden + 2)


def rnn_param_size(mode, input_size, hidden, num_layers, bidirectional):
    """The packed parameter count (reference rnn-inl.h GetParamSize)."""
    d = 2 if bidirectional else 1
    size = _layer_param_size(mode, input_size, hidden, d)
    for _ in range(num_layers - 1):
        size += _layer_param_size(mode, d * hidden, hidden, d)
    return size


def _unpack_params(params, mode, input_size, hidden, num_layers, d):
    """The packed vector -> [(wi, wh, bi, bh)] per (layer, direction), as
    views of ``params``."""
    g = _GATES[mode]
    ws, pos = [], 0
    for layer in range(num_layers):
        isz = input_size if layer == 0 else d * hidden
        for _ in range(d):
            wi = params[pos:pos + g * hidden * isz].reshape(g * hidden, isz)
            pos += g * hidden * isz
            wh = params[pos:pos + g * hidden * hidden].reshape(g * hidden, hidden)
            pos += g * hidden * hidden
            ws.append((wi, wh))
    out = []
    for wi, wh in ws:
        bi = params[pos:pos + g * hidden]
        pos += g * hidden
        bh = params[pos:pos + g * hidden]
        pos += g * hidden
        out.append((wi, wh, bi, bh))
    if pos != params.shape[0]:
        raise ValueError("RNN: parameters has %d values, mode %s with these sizes takes %d"
                         % (params.shape[0], mode, pos))
    return out


def _step_fn(mode, clip):
    """One time step ``(carry, x_gates, wh, bh) -> (carry, h)`` of the JAX
    op's ``_step_fn``.  ``clip`` is None or (min, max, nan) of the LSTM cell
    state, applied inside the step; the bounds are taken by ``maximum`` /
    ``minimum`` (the JAX op's ``clip``, whose gradient splits ties)."""
    if mode == "lstm":

        def step(carry, xg, wh, bh):
            h, c = carry
            gates = xg + h @ wh.T + bh
            i, f, g, o = gates.chunk(4, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            c = f * c + i * torch.tanh(g)
            if clip is not None:
                lo, hi, nan = clip
                if nan:
                    c = torch.nan_to_num(c, nan=0.0)
                c = torch.minimum(torch.maximum(c, lo), hi)
            h = o * torch.tanh(c)
            return (h, c), h

        return step
    if mode == "gru":

        def step(carry, xg, wh, bh):
            (h,) = carry
            hg = h @ wh.T + bh
            xr, xz, xn = xg.chunk(3, dim=-1)
            hr, hz, hn = hg.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1 - z) * n + z * h
            return (h,), h

        return step

    def step(carry, xg, wh, bh):
        (h,) = carry
        pre = xg + h @ wh.T + bh
        # relu's gradient at exactly 0 is 0, as the Activation op's
        h = torch.tanh(pre) if mode == "rnn_tanh" else torch.relu(pre)
        return (h,), h

    return step


def _run_layer(x, h0, c0, wi, wh, bi, bh, mode, reverse, clip):
    """One direction of one layer over the sequence x (T, N, I) -> (outputs
    (T, N, H), final carry)."""
    t, n, isz = x.shape
    x_gates = (x.reshape(t * n, isz) @ wi.T + bi).reshape(t, n, -1)
    step = _step_fn(mode, clip)
    carry = (h0, c0) if mode == "lstm" else (h0,)
    ys = [None] * t
    for s in (range(t - 1, -1, -1) if reverse else range(t)):
        carry, ys[s] = step(carry, x_gates[s], wh, bh)
    return torch.stack(ys), carry


def _rnn_inputs(attrs):
    if attrs.get("mode", "lstm") == "lstm":
        return ["data", "parameters", "state", "state_cell"]
    return ["data", "parameters", "state"]


def _rnn_infer(attrs, shapes):
    dshape = shapes["data"]
    hidden = attrs["state_size"]
    nl = attrs["num_layers"]
    bi = attrs.get("bidirectional", False)
    d = 2 if bi else 1
    mode = attrs.get("mode", "lstm")
    out = {"parameters": (rnn_param_size(mode, dshape[2], hidden, nl, bi),),
           "state": (nl * d, dshape[1], hidden)}
    if mode == "lstm":
        out["state_cell"] = (nl * d, dshape[1], hidden)
    return out


@register("RNN", inputs_fn=_rnn_inputs, infer_params=_rnn_infer,
          num_outputs=lambda attrs: 3 if attrs.get("mode", "lstm") == "lstm" else 2)
def rnn(data, parameters, state, state_cell=None, *, state_size, num_layers, mode="lstm",
        bidirectional=False, p=0.0, state_outputs=False, lstm_state_clip_min=None,
        lstm_state_clip_max=None, lstm_state_clip_nan=False, training=False,
        generator=None):
    """Fused multi-layer RNN (reference src/operator/rnn-inl.h).

    data (T, N, I), sequence-major; state (L·D, N, H), and state_cell
    likewise for LSTM.  Returns (out (T, N, D·H), final h[, final c]) in
    every case; ``state_outputs`` says how many of them the frontends show.
    Between layers, in training with ``p`` > 0, dropout keeps each value
    where ``uniform < 1 − p`` drawn from ``generator`` (a
    ``torch.Generator`` on the data's device, where the JAX op folds
    ``key``); the global random state is never used.
    """
    if mode not in _GATES:
        raise ValueError("RNN: unknown mode %r" % (mode,))
    d = 2 if bidirectional else 1
    layers = _unpack_params(parameters, mode, data.shape[2], state_size, num_layers, d)
    clip = None
    if mode == "lstm" and lstm_state_clip_min is not None and lstm_state_clip_max is not None:
        clip = (torch.full((), lstm_state_clip_min, dtype=data.dtype, device=data.device),
                torch.full((), lstm_state_clip_max, dtype=data.dtype, device=data.device),
                bool(lstm_state_clip_nan))
    drop = p > 0 and training and num_layers > 1
    if drop and generator is None:
        raise ValueError("RNN dropout in training needs a torch.Generator; the global "
                         "random state is not used")
    x = data
    h_finals, c_finals = [], []
    for layer in range(num_layers):
        outs = []
        for direction in range(d):
            li = layer * d + direction
            wi, wh, bi, bh = layers[li]
            c0 = state_cell[li] if mode == "lstm" else None
            ys, carry = _run_layer(x, state[li], c0, wi, wh, bi, bh, mode,
                                   direction == 1, clip)
            outs.append(ys)
            h_finals.append(carry[0])
            if mode == "lstm":
                c_finals.append(carry[1])
        x = outs[0] if d == 1 else torch.cat(outs, dim=-1)
        if drop and layer < num_layers - 1:
            keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
            scale = torch.full((), 1.0 - p, dtype=x.dtype, device=x.device)
            x = torch.where(keep, x / scale, x.new_zeros(()))
    if mode == "lstm":
        return x, torch.stack(h_finals), torch.stack(c_finals)
    return x, torch.stack(h_finals)


def _split_v2_outputs(attrs):
    ios = attrs["indices_or_sections"]
    return int(ios) if isinstance(ios, int) else len(ios) + 1


@register("split_v2", num_outputs=_split_v2_outputs)
def split_v2(data, *, indices_or_sections, axis=0, squeeze_axis=False):
    """numpy's ``split`` (reference matrix_op split_v2): ``indices_or_sections``
    equal parts (which must divide the axis), or the parts between the
    given indices."""
    if isinstance(indices_or_sections, int):
        n = data.shape[axis]
        if n % indices_or_sections:
            raise ValueError("split_v2: axis %d of size %d does not split into %d equal "
                             "parts" % (axis, n, indices_or_sections))
        parts = torch.split(data, n // indices_or_sections, dim=axis)
    else:
        parts = torch.tensor_split(data, list(indices_or_sections), dim=axis)
    if squeeze_axis:
        parts = [s.squeeze(axis) for s in parts]
    return tuple(parts)
