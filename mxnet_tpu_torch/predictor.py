"""Deployment inference (counterpart of ``mxnet_tpu/predictor.py``; the
reference's C predict API, ``include/mxnet/c_predict_api.h``).

A predictor is made from a symbol JSON and a parameter file, takes inputs,
runs forward and hands back outputs, with no training machinery.  It runs
the Executor's inference plan: the captured graph through the graph-pass
pipeline (eval Dropout deleted, BatchNorm as an affine, duplicates merged,
dead branches swept), and for a precision twin (``with_precision``) the
tier's passes after it.

Reference map:

- ``MXPredCreate`` / ``MXPredCreatePartialOut`` -> ``Predictor(...)`` /
  ``Predictor(..., output_names=[...])``
- ``MXPredReshape``        -> ``Predictor.reshape``
- ``MXPredSetInput``       -> ``Predictor.set_input``
- ``MXPredForward``        -> ``Predictor.forward``
- ``MXPredGetOutputShape`` -> ``Predictor.get_output_shape``
- ``MXPredGetOutput``      -> ``Predictor.get_output``
- ``MXNDListCreate``       -> ``load_ndarray_file``

The predictor runs on CUDA unless ``device="cpu"`` is passed, and raises
without a card otherwise.  The ahead-of-time compile half of the JAX
predictor (``aot_lower`` / ``aot_finalize`` / ``aot_warm``) is not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ndarray as nd
from . import symbol as sym_mod
from .context import resolve_device

__all__ = ["Predictor", "create", "load_ndarray_file"]


def load_ndarray_file(fname):
    """A name -> tensor file saved by ``ndarray.save`` (reference
    ``MXNDListCreate``; e.g. a deployment's mean image)."""
    return nd.load(fname)


def _torch_dtype(dtype):
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype))


class Predictor:
    """Inference-only executor over a saved (symbol, params) pair.

    Parameters
    ----------
    symbol : Symbol or str
        A Symbol, a path to ``*-symbol.json`` or a JSON string.
    params : dict or str
        ``{name: tensor or array}`` (``arg:`` / ``aux:`` prefixes optional,
        as in the checkpoint format) or a path to a ``*.params`` file.
    input_shapes : dict
        name -> shape of every data input.
    device : None, str or torch.device
        None is CUDA (raises without it); ``"cpu"`` runs on the CPU.
    output_names : list of str, optional
        Internal outputs to return instead (``MXPredCreatePartialOut``),
        with or without their ``_output`` suffix.
    dtype : str
        The compute dtype of the inputs and the floating-point weights
        ("bfloat16" casts them once, at load); auxiliary states keep theirs.

    The weights are moved to the device once, here; every predictor made
    from this one (``with_shapes``, ``with_precision``) binds the same
    tensors.
    """

    def __init__(self, symbol, params, input_shapes, device=None, output_names=None,
                 dtype="float32"):
        if isinstance(symbol, str):
            s = symbol.lstrip()
            symbol = sym_mod.load_json(symbol) if s.startswith("{") else sym_mod.load(symbol)
        if output_names:
            internals = symbol.get_internals()
            avail = internals.list_outputs()
            picked = []
            for name in output_names:
                cand = name if name in avail else name + "_output"
                if cand not in avail:
                    raise ValueError("output %r not in graph (have e.g. %s)" % (name, avail[:8]))
                picked.append(internals[avail.index(cand)])
            symbol = sym_mod.Group(picked) if len(picked) > 1 else picked[0]
        dev = resolve_device(device)
        arg_params, aux_params = self._load_params(params, dev, _torch_dtype(dtype))
        self._init_bound(symbol, dtype, dev, arg_params, aux_params, input_shapes)

    def _init_bound(self, symbol, dtype, device, arg_params, aux_params, input_shapes):
        """The init tail shared with ``with_shapes`` / ``with_precision``:
        every field a bound predictor carries."""
        self._symbol = symbol
        self._dtype = dtype
        self._device = device
        self._arg_params = arg_params
        self._aux_params = aux_params
        self._input_names = list(input_shapes.keys())
        self._build(dict(input_shapes))

    @staticmethod
    def _load_params(params, device, dtype):
        """``params`` (or the file it names) -> ({arg: tensor}, {aux:
        tensor}) on ``device``, floating-point arguments in ``dtype``."""
        if isinstance(params, str):
            params = nd.load(params)
        args, aux = {}, {}
        for k, v in params.items():
            t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
            if k.startswith("aux:"):
                aux[k[4:]] = t.to(device)
                continue
            if t.is_floating_point():
                t = t.to(dtype)
            args[k[4:] if k.startswith("arg:") else k] = t.to(device)
        return args, aux

    def _build(self, input_shapes):
        self._input_shapes = input_shapes
        # every argument in the deploy dtype but the weights that are not
        # floating point (a quantized symbol's int8 weights keep theirs)
        types = {n: self._dtype for n in self._symbol.list_arguments()}
        types.update({n: v.dtype for n, v in self._arg_params.items()
                      if n in types and not v.is_floating_point()})
        exe = self._symbol.simple_bind(device=self._device, grad_req="null",
                                       type_dict=types, **input_shapes)
        # the loaded weights are bound as they are (shared, not copied);
        # inputs are fed per call, never from the parameter file
        for bound, params in ((exe.arg_dict, self._arg_params), (exe.aux_dict, self._aux_params)):
            for k, v in params.items():
                if k not in bound or k in input_shapes:
                    continue
                if tuple(v.shape) != tuple(bound[k].shape):
                    raise ValueError("parameter %s has shape %s, the symbol expects %s"
                                     % (k, tuple(v.shape), tuple(bound[k].shape)))
                bound[k] = v
        self._exec = exe
        # the inputs' own buffers: a copied input goes here, never into a
        # caller's tensor that an earlier call adopted
        self._input_bufs = {n: exe.arg_dict[n] for n in input_shapes}
        self._outputs = None

    # -- c_predict_api surface ----------------------------------------------
    def set_input(self, name, value):
        """Stage one input (``MXPredSetInput``).  A tensor on the device in
        the bound dtype is taken as it is (read, never written); anything
        else is copied into the input's own buffer."""
        if name not in self._input_shapes:
            raise KeyError("unknown input %r (declared: %s)" % (name, self._input_names))
        if tuple(value.shape) != tuple(self._input_shapes[name]):
            raise ValueError("input %r shape %s != declared %s (use reshape())"
                             % (name, tuple(value.shape), self._input_shapes[name]))
        buf = self._input_bufs[name]
        if isinstance(value, torch.Tensor) and value.device == buf.device \
                and value.dtype == buf.dtype:
            self._exec.arg_dict[name] = value
            return
        with torch.no_grad():
            buf.copy_(torch.as_tensor(np.asarray(value) if not isinstance(value, torch.Tensor)
                                      else value))
        self._exec.arg_dict[name] = buf

    def forward(self, **kwargs):
        """Run inference (``MXPredForward``); inputs may be given as
        keywords.  Returns the outputs, tensors on the device."""
        for k, v in kwargs.items():
            self.set_input(k, v)
        self._outputs = self._exec.forward(is_train=False)
        return self._outputs

    def get_output_shape(self, index=0):
        """An output's shape without running (``MXPredGetOutputShape``)."""
        _, out_shapes, _ = self._symbol.infer_shape(**self._input_shapes)
        return tuple(out_shapes[index])

    def get_output(self, index=0):
        """An output copied to the host as numpy (``MXPredGetOutput``);
        bfloat16 comes back as float32."""
        if self._outputs is None:
            self.forward()
        out = self._outputs[index]
        return (out.float() if out.dtype == torch.bfloat16 else out).cpu().numpy()

    # -- ahead-of-time compile: not ported ---------------------------------
    def aot_lower(self):
        raise NotImplementedError("Predictor.aot_lower: the ahead-of-time compile cache is "
                                  "not ported (ROADMAP.md A9)")

    def aot_finalize(self, handle):
        raise NotImplementedError("Predictor.aot_finalize: the ahead-of-time compile cache "
                                  "is not ported (ROADMAP.md A9)")

    def aot_warm(self):
        raise NotImplementedError("Predictor.aot_warm: the ahead-of-time compile cache is "
                                  "not ported (ROADMAP.md A9)")

    # -- the pass layer's surfaces -------------------------------------------
    def pass_stats(self):
        """Graph-pass results of this predictor's inference plan
        (``{"eval": {nodes_pre, nodes_post, seconds, passes}}`` once the
        first forward has run; empty with ``MXNET_GRAPH_PASSES=0``)."""
        return self._exec.pass_stats()

    def check(self):
        """Graph-analyzer diagnostics of the inference plan -> sorted
        [Diagnostic].  Shapes and dtypes only: nothing runs."""
        return self._exec.check(is_train=False)

    def precision_plan(self):
        """The cast plan (``analysis.numerics.CastPlan``) of the inference
        plan: per-node ``bf16_safe | fp32_accum | fp32_only`` verdicts and a
        fingerprint, what the precision tiers consume."""
        return self._exec.precision_plan(is_train=False)

    def _tier_carried(self, exe, like):
        """Give ``exe`` the tier (and table) of executor ``like`` where it
        was set explicitly."""
        if exe._precision_tier != like._precision_tier or like._calibration is not None:
            exe.set_precision_tier(like._precision_tier, like._calibration)

    def with_shapes(self, input_shapes):
        """A sibling predictor for ``input_shapes`` that binds this one's
        symbol and weight tensors (nothing re-read, nothing copied: one
        copy of the weights serves every shape).  This one's precision tier
        carries over."""
        clone = object.__new__(Predictor)
        clone._init_bound(self._symbol, self._dtype, self._device, self._arg_params,
                          self._aux_params, input_shapes)
        self._tier_carried(clone._exec, self._exec)
        return clone

    def with_precision(self, tier, calibration=None):
        """The precision twin of this predictor: the same symbol and weight
        tensors (shared as in ``with_shapes``), its inference plan rewritten
        by the tier's passes (``graph_passes/precision.py``): ``"bf16"``,
        ``"int8"`` (with the :func:`graph_passes.precision.calibrate`
        table; without one nothing is quantized), or ``"fp32"`` / None for
        a plain twin.  Its outputs
        are held to ``precision.tier_tolerance(tier)`` against this
        predictor's."""
        clone = object.__new__(Predictor)
        clone._init_bound(self._symbol, self._dtype, self._device, self._arg_params,
                          self._aux_params, dict(self._input_shapes))
        clone._exec.set_precision_tier(tier, calibration)
        return clone

    @property
    def precision_tier(self):
        """``"fp32"``, ``"bf16"`` or ``"int8"``."""
        return self._exec.precision_tier

    @property
    def int8_sites(self):
        """The int8 rewrite's sites of the inference plan, ``{site ->
        {input, lo, hi, a_scale}}`` (``input`` is the structural env name
        the calibrated range is keyed on); empty until the plan is built,
        and for any other tier."""
        return dict(self._exec._int8_sites)

    def reshape(self, input_shapes):
        """Re-specialise to new input shapes (``MXPredReshape``): weights
        are kept, inputs allocated anew; the tier carries over."""
        shapes = dict(self._input_shapes)
        shapes.update(input_shapes)
        self._input_shapes = shapes
        old = self._exec
        self._exec = old.reshape(**shapes)
        self._tier_carried(self._exec, old)
        dt = _torch_dtype(self._dtype)
        for n in self._input_names:
            arr = self._exec.arg_dict[n]
            self._exec.arg_dict[n] = torch.zeros(arr.shape, dtype=dt, device=arr.device)
        self._input_bufs = {n: self._exec.arg_dict[n] for n in self._input_names}
        self._outputs = None

    @property
    def outputs(self):
        return self._outputs


def create(symbol_file, param_file, input_shapes, device=None, output_names=None,
           dtype="float32"):
    """Functional spelling of ``MXPredCreate(PartialOut)``."""
    return Predictor(symbol_file, param_file, input_shapes, device=device,
                     output_names=output_names, dtype=dtype)
