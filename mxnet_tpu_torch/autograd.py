"""Imperative autograd (counterpart of ``mxnet_tpu/autograd.py``; reference
python/mxnet/autograd.py and src/imperative/imperative.cc).

It rides on ``torch.autograd``: inside ``record()`` the nd frontend runs
each operation with PyTorch's graph recording on, outside it with
``torch.no_grad()``, so that no graph is built.  ``backward`` computes the
gradients of the heads with respect to every live variable (an array
after ``attach_grad`` / ``mark_variables``, a Gluon Parameter's data) that
the graph reaches, with ``torch.autograd.grad``, and writes them into each
variable's ``grad`` buffer: overwritten under ``grad_req="write"``, added
under ``"add"`` (PyTorch itself always adds).  A variable the graph does
not reach keeps its buffer as it was.  A head that is not a scalar is
differentiated against ones: its gradient is that of the sum of its
elements.

``record(train_mode)`` / ``pause`` / ``train_mode`` / ``predict_mode`` set
the thread's recording and training flags; the training flag is what the
Gluon layers read (BatchNorm's batch statistics, Dropout), not
``nn.Module.train()``.  ``Function`` is a ``torch.autograd.Function``
whose forward and backward the user writes on NDArrays.
"""
from __future__ import annotations

import threading
import weakref

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording", "is_training",
           "mark_variables", "backward", "grad", "set_recording", "set_training", "Function"]

_STATE = threading.local()

# the variables, process-wide (a model built in one thread trains in
# another), by id, held weakly: a variable dies with its array
_MARKED = weakref.WeakValueDictionary()
_MARKED_LOCK = threading.Lock()


def _st():
    if not getattr(_STATE, "init", False):
        _STATE.recording = False
        _STATE.training = False
        _STATE.init = True
    return _STATE


def _mark_variable(arr):
    with _MARKED_LOCK:
        _MARKED[id(arr)] = arr


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each array a variable whose gradient ``backward`` writes into
    the matching buffer of ``gradients`` (reference autograd.py:216)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        if not v._is_grad_leaf():
            v._data = v._data.detach().requires_grad_(True)
        v.grad = g
        v._grad_req = req
        _mark_variable(v)


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(is_record):
    """Set the recording flag; returns the previous one."""
    st = _st()
    prev, st.recording = st.recording, bool(is_record)
    return prev


def set_training(train):
    """Set the training flag; returns the previous one."""
    st = _st()
    prev, st.training = st.training, bool(train)
    return prev


class _RecordingStateScope:
    def __init__(self, is_record, train):
        self._enter_record = is_record
        self._enter_train = train
        self._prev = None

    def __enter__(self):
        st = _st()
        self._prev = (st.recording, st.training)
        if self._enter_record is not None:
            st.recording = self._enter_record
        if self._enter_train is not None:
            st.training = self._enter_train
        return self

    def __exit__(self, *exc):
        st = _st()
        st.recording, st.training = self._prev


def record(train_mode=True):
    """``with autograd.record():`` — operations inside build a graph
    (reference autograd.py:122); ``train_mode`` sets the training flag."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    """``with autograd.pause():`` — no graph inside (reference autograd.py:146)."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def grad_mode():
    """The ``torch`` grad mode of an operation run now: enabled while
    recording, else ``no_grad``."""
    return torch.enable_grad() if _st().recording else torch.no_grad()


def _live_variables():
    with _MARKED_LOCK:
        found = list(_MARKED.values())
    return [v for v in found if v._grad_req != "null" and v._data.requires_grad]


def _head_grads(heads, head_grads):
    out = []
    for i, h in enumerate(heads):
        g = None if head_grads is None else head_grads[i]
        if g is None:
            out.append(torch.ones_like(h._data))
        else:
            out.append(g._data if hasattr(g, "_data") else torch.as_tensor(
                g, dtype=h._data.dtype, device=h._data.device))
    return out


def _heads(heads):
    return list(heads) if isinstance(heads, (list, tuple)) else [heads]


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to the live variables, written
    into their ``grad`` buffers (reference Imperative::Backward,
    imperative.cc:270)."""
    heads = _heads(heads)
    variables = _live_variables()
    if not variables:
        raise ValueError("There are no variables attached with gradients (attach_grad).")
    if not any(h._data.requires_grad for h in heads):
        raise ValueError("None of the attached variables participate in the recorded "
                         "graph (was the forward run inside autograd.record()?)")
    grads = torch.autograd.grad([h._data for h in heads], [v._data for v in variables],
                                _head_grads(heads, head_grads), retain_graph=retain_graph,
                                allow_unused=True)
    from .ndarray.ndarray import NDArray

    with torch.no_grad():
        for v, g in zip(variables, grads):
            if g is None:
                continue  # not reached by this graph: the buffer stays
            if v.grad is None:
                v.grad = NDArray(g.detach())
            elif v._grad_req == "add":
                v.grad._data.add_(g)
            else:
                v.grad._data.copy_(g)


def grad(heads, variables, head_grads=None, retain_graph=None, create_graph=False,
         train_mode=True):
    """The gradients of ``heads`` with respect to ``variables``, returned
    as new arrays (reference autograd.py:270); ``create_graph`` records
    them, for a second derivative.  ``retain_graph`` defaults to
    ``create_graph``."""
    from .ndarray.ndarray import NDArray

    heads = _heads(heads)
    variables = _heads(variables)
    if retain_graph is None:
        retain_graph = create_graph
    gs = torch.autograd.grad([h._data for h in heads], [v._data for v in variables],
                             _head_grads(heads, head_grads), retain_graph=retain_graph,
                             create_graph=create_graph, allow_unused=True)
    return [NDArray(torch.zeros_like(v._data) if g is None else
                    (g if create_graph else g.detach()))
            for v, g in zip(variables, gs)]


class Function:
    """A differentiable function with a hand-written gradient (reference
    autograd.py:363): subclass it, write ``forward`` and ``backward`` on
    NDArrays, and call an instance.  It runs as a ``torch.autograd.Function``;
    ``save_for_backward`` keeps arrays for ``backward``."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray

        fn = self
        multi = []

        class _Apply(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *tensors):
                with pause():
                    out = fn.forward(*[NDArray(t) for t in tensors])
                multi.append(isinstance(out, (list, tuple)))
                outs = out if multi[0] else (out,)
                return tuple(o._data for o in outs)

            @staticmethod
            def backward(ctx, *grads):
                with pause():
                    ig = fn.backward(*[NDArray(g) for g in grads])
                ig = ig if isinstance(ig, (list, tuple)) else (ig,)
                return tuple(g._data for g in ig)

        with grad_mode():
            outs = _Apply.apply(*[i._data for i in inputs])
        outs = [NDArray(o) for o in outs]
        return outs if multi[0] else outs[0]
