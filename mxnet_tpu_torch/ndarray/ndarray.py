"""NDArray — the imperative array of the port (counterpart of
``mxnet_tpu/ndarray/ndarray.py``; reference python/mxnet/ndarray/ndarray.py).

An NDArray holds one ``torch.Tensor`` (``_data``).  Every operation on it
goes through the registry's functions (``mxnet_tpu_torch.nd``), so that it
builds an autograd graph inside ``autograd.record()`` and none outside.

Mutation (``a += b``, ``a[1:3] = x``, ``copyto``) writes the tensor in
place when it is a leaf that takes a gradient (an ``attach_grad``'ed array,
a Parameter's data), under ``torch.no_grad``: PyTorch refuses an in-place
write to such a leaf while its graph is recorded.  Any other array is
rebound to the updated tensor, as the JAX package rebinds; a view taken
before keeps the old values.
"""
from __future__ import annotations

import numpy as np
import torch

from ..context import Context, as_device

__all__ = ["NDArray", "array", "empty", "concatenate", "waitall"]


def np_dtype(tdtype):
    """A ``torch.dtype`` -> the numpy dtype (bfloat16: the torch dtype)."""
    if tdtype == torch.bfloat16:
        return tdtype
    return np.dtype(str(tdtype).replace("torch.", ""))


def _index(key):
    """An index with NDArray parts -> one with int64 tensors."""
    if isinstance(key, NDArray):
        return key._data.to(torch.int64)
    if isinstance(key, tuple):
        return tuple(_index(k) for k in key)
    return key


class NDArray:
    __slots__ = ("_data", "grad", "_grad_req", "__weakref__")

    # numpy's operators defer to NDArray's reflected ones
    __array_priority__ = 100.0

    def __init__(self, data):
        if not isinstance(data, torch.Tensor):
            raise TypeError("NDArray holds a torch.Tensor, got %s" % type(data))
        self._data = data
        self.grad = None
        self._grad_req = "null"

    # -- properties ---------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return np_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return Context(self._data.device)

    ctx = context

    @property
    def stype(self):
        return "default"

    # -- conversion ---------------------------------------------------------
    def asnumpy(self):
        """A numpy copy on the host (bfloat16 as float32); waits for the
        device.  Always a copy: a later update of the array does not show
        in it."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy() if t.is_cuda else t.numpy().copy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    item = asscalar

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    def astype(self, dtype, copy=True):
        from . import _call

        return _call("cast", self, dtype=dtype)

    def copy(self):
        from . import _call

        return _call("_copyto", self)

    def copyto(self, other):
        """Copy into another NDArray (its device and dtype kept), or onto a
        Context as a new array."""
        if isinstance(other, NDArray):
            other._set_data(self._data.detach().to(other._data.device, other._data.dtype))
            return other
        return NDArray(self._data.detach().to(as_device(other), copy=True))

    def as_in_context(self, context):
        if as_device(context) == self._data.device:
            return self
        return NDArray(self._data.to(as_device(context)))

    as_in_ctx = as_in_context

    def tostype(self, stype):
        if stype != "default":
            raise NotImplementedError("sparse storage is not ported (ROADMAP A8.4)")
        return self

    # -- autograd -----------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Make this array a variable of the recorded graphs: a leaf
        (detached from any graph it came from) with a zero gradient buffer
        ``grad``, written ("write") or accumulated ("add") by
        ``backward``."""
        from .. import autograd

        self._data = self._data.detach().requires_grad_(True)
        self.grad = NDArray(torch.zeros_like(self._data))
        self._grad_req = grad_req
        autograd._mark_variable(self)

    def detach(self):
        return NDArray(self._data.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd

        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph, train_mode)

    # -- mutation -----------------------------------------------------------
    def _is_grad_leaf(self):
        return self._data.requires_grad and self._data.is_leaf

    def _set_data(self, value):
        """Replace the values (same shape; cast to this array's dtype)."""
        if tuple(value.shape) != self.shape:
            value = value.expand(self.shape) if value.dim() <= self.ndim else value
            if tuple(value.shape) != self.shape:
                raise ValueError("inplace update shape mismatch: %s vs %s"
                                 % (tuple(value.shape), self.shape))
        if self._is_grad_leaf():
            with torch.no_grad():
                self._data.copy_(value)
        else:
            self._data = value.to(self._data.dtype)

    def _value(self, value):
        if isinstance(value, NDArray):
            value = value._data
        if isinstance(value, torch.Tensor):
            return value.to(self._data.device, self._data.dtype)
        if isinstance(value, (int, float, bool)):
            return value
        return torch.as_tensor(np.asarray(value), dtype=self._data.dtype,
                               device=self._data.device)

    def __setitem__(self, key, value):
        from .. import autograd

        key, value = _index(key), self._value(value)
        if self._is_grad_leaf():
            with torch.no_grad():
                self._data[key] = value
            return
        grad_mode = torch.enable_grad() if autograd.is_recording() else torch.no_grad()
        with grad_mode:
            t = self._data.clone()
            t[key] = value
        self._data = t

    def __getitem__(self, key):
        from . import _invoke_fn

        key = _index(key)
        return _invoke_fn(lambda t: t[key], [self], {})

    # -- shape --------------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        from . import _call

        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if not shape:
            shape = kwargs.get("shape")
        return _call("Reshape", self, shape=tuple(shape), reverse=kwargs.get("reverse", False))

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def flatten(self):
        return self.reshape((self.shape[0], -1))

    def transpose(self, axes=None):
        from . import _call

        return _call("transpose", self, axes=axes)

    @property
    def T(self):
        return self.transpose()

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        from . import _call

        return _call("SliceChannel", self, num_outputs=num_outputs, axis=axis,
                     squeeze_axis=squeeze_axis)

    # -- python protocol ----------------------------------------------------
    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("The truth value of an NDArray with multiple elements is ambiguous.")

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (self.asnumpy(), "x".join(map(str, self.shape)),
                                          self.context)

    def __hash__(self):
        return id(self)

    # -- arithmetic: the registry's broadcast and scalar ops ----------------
    def _binop(self, name, other, reverse=False):
        from . import _binary_dispatch

        return _binary_dispatch(name, self, other, reverse)

    def __add__(self, o):
        return self._binop("add", o)

    def __radd__(self, o):
        return self._binop("add", o, True)

    def __sub__(self, o):
        return self._binop("sub", o)

    def __rsub__(self, o):
        return self._binop("sub", o, True)

    def __mul__(self, o):
        return self._binop("mul", o)

    def __rmul__(self, o):
        return self._binop("mul", o, True)

    def __truediv__(self, o):
        return self._binop("div", o)

    def __rtruediv__(self, o):
        return self._binop("div", o, True)

    def __mod__(self, o):
        return self._binop("mod", o)

    def __rmod__(self, o):
        return self._binop("mod", o, True)

    def __pow__(self, o):
        return self._binop("power", o)

    def __rpow__(self, o):
        return self._binop("power", o, True)

    def __neg__(self):
        from . import _call

        return _call("negative", self)

    def __abs__(self):
        from . import _call

        return _call("abs", self)

    def __eq__(self, o):
        return self._binop("equal", o)

    def __ne__(self, o):
        return self._binop("not_equal", o)

    def __gt__(self, o):
        return self._binop("greater", o)

    def __ge__(self, o):
        return self._binop("greater_equal", o)

    def __lt__(self, o):
        return self._binop("lesser", o)

    def __le__(self, o):
        return self._binop("lesser_equal", o)

    def _inplace(self, fn, o):
        self._set_data(fn(o)._data)
        return self

    def __iadd__(self, o):
        return self._inplace(self.__add__, o)

    def __isub__(self, o):
        return self._inplace(self.__sub__, o)

    def __imul__(self, o):
        return self._inplace(self.__mul__, o)

    def __itruediv__(self, o):
        return self._inplace(self.__truediv__, o)


def array(source_array, ctx=None, dtype=None):
    """An NDArray from an array-like, on ``ctx`` (None: the current
    context, which is the card unless ``with mx.cpu():`` is entered).
    float64 data becomes float32 and int64 int32, as in the JAX package."""
    from ..ops.elemwise import to_dtype

    dev = as_device(ctx)
    if isinstance(source_array, NDArray):
        t = source_array._data.detach()
        return NDArray(t.to(dev, to_dtype(dtype) if dtype is not None else t.dtype, copy=True))
    if isinstance(source_array, torch.Tensor):
        src = source_array.detach()
    else:
        src = np.asarray(source_array)
    if dtype is None:
        name = str(src.dtype).replace("torch.", "")
        dtype = {"float64": "float32", "int64": "int32"}.get(name, name)
    if not isinstance(src, torch.Tensor):
        src = torch.as_tensor(src)
    return NDArray(src.to(dev, to_dtype(dtype), copy=True))


def empty(shape, ctx=None, dtype="float32"):
    from ..ops.elemwise import to_dtype

    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return NDArray(torch.zeros(shape, dtype=to_dtype(dtype or "float32"), device=as_device(ctx)))


def concatenate(arrays, axis=0, always_copy=True):
    from . import _call

    return _call("Concat", *arrays, dim=axis)


def waitall():
    """Wait for every queued device operation (reference MXNDArrayWaitAll)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
