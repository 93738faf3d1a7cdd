"""Shape and layout operators (counterpart of ``mxnet_tpu/ops/matrix.py``;
reference src/operator/tensor/matrix_op.cc): ``Reshape`` with MXNet's
special codes, ``transpose``, the slices, ``Concat`` / ``stack`` /
``SliceChannel``, ``tile`` / ``repeat`` / ``reverse``, ``dot`` /
``batch_dot``, ``where``, the broadcasts, ``Pad`` and the rest of the JAX
group, under its names and aliases."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import register

__all__ = ["infer_reshape", "reshape", "flatten"]


def infer_reshape(src_shape, target, reverse=False):
    """MXNet Reshape target -> concrete shape (reference matrix_op-inl.h
    ReshapeParam; ``mxnet_tpu/ops/matrix.py infer_reshape``).

    Codes: 0 copies the input dim at this position, -1 is inferred from the
    rest, -2 copies every remaining input dim, -3 merges two consecutive
    input dims, -4 splits one input dim into the next two target values
    (one of them may be -1); a positive value is taken as it is.
    ``reverse`` matches the codes from the right.
    """
    src = list(src_shape)
    target = list(target)
    if reverse:
        src = src[::-1]
        target = target[::-1]
    out = []
    i = t = 0
    while t < len(target):
        code = target[t]
        if code == 0:
            out.append(src[i])
            i += 1
        elif code == -1:
            out.append(-1)
            i += 1
        elif code == -2:
            out.extend(src[i:])
            i = len(src)
        elif code == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif code == -4:
            d1, d2 = target[t + 1], target[t + 2]
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            out.extend([d1, d2])
            i += 1
            t += 2
        elif code > 0:
            out.append(int(code))
            i += 1
        else:
            raise ValueError("Reshape: unknown code %d (the codes are 0, -1, -2, -3, -4)"
                             % code)
        t += 1
    if reverse:
        out = out[::-1]
    if -1 in out:
        known = math.prod(d for d in out if d != -1)
        out[out.index(-1)] = math.prod(src_shape) // max(known, 1)
    return tuple(int(d) for d in out)


def reshape(data, shape, reverse=False):
    """Reshape with the MXNet special codes (reference matrix_op.cc Reshape)."""
    return data.reshape(infer_reshape(data.shape, shape, reverse))


@register("Reshape", alias=("reshape",))
def reshape_op(data, *, shape=None, reverse=False):
    """Reshape with the MXNet special codes (reference matrix_op.cc Reshape)."""
    return reshape(data, shape, reverse)


@register("Flatten", alias=("flatten",))
def flatten(data):
    """Collapse all axes but the first (reference matrix_op.cc Flatten)."""
    return data.reshape((data.shape[0], -1) if data.dim() > 1 else (data.shape[0],))


@register("transpose")
def transpose(data, *, axes=None):
    """Permute the axes; none given: reverse them."""
    if axes is None or axes == ():
        axes = tuple(reversed(range(data.dim())))
    return data.permute(*axes)


@register("expand_dims")
def expand_dims(data, *, axis):
    return data.unsqueeze(axis)


@register("squeeze")
def squeeze(data, *, axis=None):
    if axis is None:
        return data.squeeze()
    return data.squeeze(axis if isinstance(axis, int) else tuple(axis))


def _slice_dim(data, d, sl):
    """``data`` sliced along ``d`` by a Python slice (negative steps too)."""
    start, stop, step = sl.indices(data.shape[d])
    if step > 0:
        return data[(slice(None),) * d + (slice(start, max(start, stop), step),)]
    idx = torch.arange(start, stop, step, device=data.device)
    return data.index_select(d, idx)


def _apply_slices(data, slices):
    for d, sl in enumerate(slices):
        if sl != slice(None):
            data = _slice_dim(data, d, sl)
    return data


@register("slice", alias=("crop",))
def slice_op(data, *, begin, end, step=None):
    """N-d slice: ``begin`` / ``end`` / ``step`` per leading axis, None for
    the full range, step 0 as 1 (reference matrix_op.cc slice)."""
    nd = data.dim()
    begin = tuple(begin) + (None,) * (nd - len(begin))
    end = tuple(end) + (None,) * (nd - len(end))
    step = tuple(step or ()) + (None,) * (nd - len(tuple(step or ())))
    return _apply_slices(data, [slice(b, e, s if s != 0 else None)
                                for b, e, s in zip(begin, end, step)])


@register("slice_axis")
def slice_axis(data, *, axis, begin, end):
    """``data[begin:end]`` along ``axis`` (end None: to the end)."""
    sl = [slice(None)] * data.dim()
    sl[axis] = slice(begin, data.shape[axis] if end is None else end)
    return _apply_slices(data, sl)


@register("slice_like")
def slice_like(data, shape_like, *, axes=()):
    """``data`` cut to ``shape_like``'s extent on ``axes`` (all shared
    axes when empty)."""
    axes = axes or tuple(range(min(data.dim(), shape_like.dim())))
    sl = [slice(None)] * data.dim()
    for ax in axes:
        sl[ax] = slice(0, shape_like.shape[ax])
    return _apply_slices(data, sl)


@register("Concat", alias=("concat",))
def concat(*args, dim=1):
    """Concatenate along ``dim`` (reference src/operator/nn/concat.cc)."""
    return torch.cat(args, dim=dim)


@register("stack")
def stack(*args, axis=0):
    return torch.stack(args, dim=axis)


@register("SliceChannel", alias=("split",),
          num_outputs=lambda attrs: int(attrs["num_outputs"]))
def split(data, *, num_outputs, axis=1, squeeze_axis=False):
    """``num_outputs`` equal parts along ``axis``, as a tuple (reference
    slice_channel.cc)."""
    n = data.shape[axis]
    if n % num_outputs:
        raise ValueError("SliceChannel: axis %d of size %d does not split into %d"
                         % (axis, n, num_outputs))
    parts = torch.split(data, n // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


@register("repeat")
def repeat(data, *, repeats, axis=None):
    """Each element ``repeats`` times along ``axis`` (None: of the flat
    array)."""
    return torch.repeat_interleave(data, repeats, dim=axis)


@register("tile")
def tile(data, *, reps):
    return torch.tile(data, tuple(reps) if not isinstance(reps, int) else (reps,))


@register("reverse", alias=("flip",))
def reverse(data, *, axis):
    return torch.flip(data, (axis,) if isinstance(axis, int) else tuple(axis))


@register("SwapAxis", alias=("swapaxes",))
def swapaxes(data, *, dim1=0, dim2=0):
    """Swap two axes (reference src/operator/swapaxis.cc)."""
    return data.transpose(dim1, dim2)


@register("dot")
def dot(lhs, rhs, *, transpose_a=False, transpose_b=False):
    """Contract ``lhs``'s last axis with ``rhs``'s first (reference
    dot-inl.h); ``transpose_a`` moves ``lhs``'s first axis last and
    ``transpose_b`` ``rhs``'s last axis first."""
    if transpose_a and lhs.dim() > 1:
        lhs = lhs.permute(*range(1, lhs.dim()), 0)
    if transpose_b and rhs.dim() > 1:
        rhs = rhs.permute(rhs.dim() - 1, *range(rhs.dim() - 1))
    return torch.tensordot(lhs, rhs, dims=1)


@register("batch_dot")
def batch_dot(lhs, rhs, *, transpose_a=False, transpose_b=False):
    """Batched matrix product (reference dot-inl.h batch_dot)."""
    if transpose_a:
        lhs = lhs.transpose(-1, -2)
    if transpose_b:
        rhs = rhs.transpose(-1, -2)
    return torch.matmul(lhs, rhs)


@register("where")
def where(condition, x, y):
    """``x`` where ``condition`` is nonzero, else ``y``; a 1-d condition
    selects whole rows (reference control_flow.cc where)."""
    if condition.dim() == 1 and x.dim() > 1 and condition.shape[0] == x.shape[0]:
        condition = condition.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(condition != 0, x, y)


@register("broadcast_to")
def broadcast_to(data, *, shape):
    """Broadcast to ``shape``; a 0 keeps the input's dim."""
    tgt = tuple(s if s != 0 else d for s, d in zip(shape, data.shape))
    return data.expand(tgt).clone()


@register("broadcast_axis", alias=("broadcast_axes",))
def broadcast_axis(data, *, axis=(), size=()):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    size = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(data.shape)
    for a, s in zip(axis, size):
        tgt[a] = s
    return data.expand(tuple(tgt)).clone()


@register("broadcast_like")
def broadcast_like(lhs, rhs, *, lhs_axes=None, rhs_axes=None):
    if lhs_axes is None:
        return lhs.expand(rhs.shape).clone()
    tgt = list(lhs.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        tgt[la] = rhs.shape[ra]
    return lhs.expand(tuple(tgt)).clone()


_PAD_MODES = {"constant": "constant", "edge": "replicate", "reflect": "reflect"}


@register("Pad", alias=("pad",))
def pad(data, *, mode="constant", pad_width, constant_value=0.0):
    """Pad a 4-D or 5-D array (reference src/operator/pad.cc): ``pad_width``
    is MXNet's flat form, two values per axis, the first two axes 0."""
    if mode not in _PAD_MODES:
        raise ValueError("unsupported pad mode %r" % mode)
    pairs = [(pad_width[2 * i], pad_width[2 * i + 1]) for i in range(len(pad_width) // 2)]
    flat = [v for p in reversed(pairs) for v in p]
    while len(flat) > 2 and flat[-2:] == [0, 0] and mode != "constant":
        flat = flat[:-2]  # torch's edge / reflect pads take the trailing axes only
    if mode == "constant":
        return F.pad(data, flat, mode="constant", value=constant_value)
    return F.pad(data, flat, mode=_PAD_MODES[mode])


@register("space_to_depth")
def space_to_depth(data, *, block_size):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register("depth_to_space")
def depth_to_space(data, *, block_size):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("diag")
def diag(data, *, k=0):
    if data.dim() <= 2:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=-2, dim2=-1)


@register("shape_array")
def shape_array(data):
    return torch.tensor(tuple(data.shape), dtype=torch.int32, device=data.device)


@register("size_array")
def size_array(data):
    return torch.tensor([data.numel()], dtype=torch.int32, device=data.device)
