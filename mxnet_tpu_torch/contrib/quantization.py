"""Model quantization (counterpart of ``mxnet_tpu/contrib/quantization.py``;
reference python/mxnet/contrib/quantization.py and
src/operator/quantization/quantize_graph_pass.cc).

The int8 post-training workflow, upstream's
example/quantization/imagenet_gen_qsym.py::

    qsym, qargs, aux = quantize_model(sym, arg_params, aux_params,
                                      excluded_sym_names=["fc1"],
                                      calib_mode="naive", calib_data=it)
    exe = qsym.simple_bind(device="cuda", grad_req="null", data=shape)

The rewrite is a Python pass over the Symbol graph.  Node and op names of
the rewritten graph are the JAX package's, so that the two graphs compare
node by node.  The weights are quantized offline on the device (the
``quantize_int8`` kernel on the card); the calibration statistics are host
numpy, as in the reference, fed by one device-to-host copy per batch.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from .. import symbol as _sym
from ..context import resolve_device
from ..ops.quantization import quantize
from ..symbol import Symbol

__all__ = ["quantize_model"]

_QUANTIZABLE = {"Convolution", "FullyConnected"}
_PASSTHROUGH = {"Pooling", "Flatten"}


def _runtime_minmax(s, name):
    return _sym.min(s, name=name + "_min"), _sym.max(s, name=name + "_max")


class _Rewriter:
    """One _quantize_symbol run (reference quantize_graph_pass.cc)."""

    def __init__(self, excluded, offline, out_type):
        self.excluded = excluded
        self.offline = offline
        self.out_type = out_type
        self.fmap = {}  # (base_name, out_idx) -> float-domain Symbol
        self.qmap = {}  # base_name -> (q, mn, mx) triple in quantized domain
        self.deq_cache = {}

    def fval(self, inp):
        base = inp._base()
        idx = inp.out_index or 0
        key = (base.name, idx)
        if key in self.fmap:
            return self.fmap[key]
        if base.name in self.qmap:  # only quantized form exists: dequantize
            ck = (base.name, idx, "deq")
            if ck not in self.deq_cache:
                q, mn, mx = self.qmap[base.name]
                self.deq_cache[ck] = _sym.contrib.dequantize(
                    q, mn, mx, name=base.name + "_dequantize"
                )
            return self.deq_cache[ck]
        return inp  # untouched original (variable)

    def qval(self, inp):
        """Quantized-domain triple for an input, inserting quantize ops /
        offline-quantized param variables as needed."""
        base = inp._base()
        if base.name in self.qmap:
            return self.qmap[base.name]
        if base.is_var and base.name in self.offline:
            q = _sym.Variable(base.name + "_quantize")
            q._dtype_hint = torch.int8  # simple_bind allocates the arg as int8
            mn = _sym.Variable(base.name + "_quantize_min")
            mx = _sym.Variable(base.name + "_quantize_max")
            self.qmap[base.name] = (q, mn, mx)
            return self.qmap[base.name]
        f = self.fval(inp)
        fmn, fmx = _runtime_minmax(f, base.name)
        out_type = self.out_type if base.is_var else "int8"
        trip = _sym.contrib.quantize(
            f, fmn, fmx, out_type=out_type, name=base.name + "_quantize"
        )
        self.qmap[base.name] = (trip[0], trip[1], trip[2])
        return self.qmap[base.name]

    def visit(self, node):
        if node.is_var:
            self.fmap[(node.name, 0)] = node
            return
        opname = node.op.name
        if opname in _QUANTIZABLE and node.name not in self.excluded:
            self._rewrite_quantizable(node)
        elif opname in _PASSTHROUGH and node.inputs and \
                node.inputs[0]._base().name in self.qmap and node.name not in self.excluded:
            self._rewrite_passthrough(node)
        elif opname == "Activation" and node.attrs.get("act_type", "relu") == "relu" \
                and node.inputs and node.inputs[0]._base().name in self.qmap \
                and node.name not in self.excluded:
            q, mn, mx = self.qmap[node.inputs[0]._base().name]
            trip = _sym.contrib.quantized_act(q, mn, mx, act_type="relu", name=node.name)
            self.qmap[node.name] = (trip[0], trip[1], trip[2])
        else:
            new_inputs = [self.fval(i) for i in node.inputs]
            rebuilt = Symbol(node.op, new_inputs, dict(node.attrs), node.name, node.num_outputs)
            for i in range(node.num_outputs):
                self.fmap[(node.name, i)] = rebuilt[i] if node.num_outputs > 1 else rebuilt

    def _rewrite_quantizable(self, node):
        attrs = dict(node.attrs)
        qd, mnd, mxd = self.qval(node.inputs[0])
        qw, mnw, mxw = self.qval(node.inputs[1])
        # keyword-wire the tensor args: inputs_fn drops bias from the middle
        # of the positional list when no_bias, so positions cannot be trusted
        tensor_kw = dict(
            data=qd, weight=qw, min_data=mnd, max_data=mxd,
            min_weight=mnw, max_weight=mxw,
        )
        no_bias = attrs.get("no_bias", False)
        if not no_bias and len(node.inputs) > 2:
            qb, mnb, mxb = self.qval(node.inputs[2])
            tensor_kw.update(bias=qb, min_bias=mnb, max_bias=mxb)
        fn = (
            _sym.contrib.quantized_conv
            if node.op.name == "Convolution"
            else _sym.contrib.quantized_fully_connected
        )
        out = fn(name=node.name + "_quantize", **tensor_kw, **attrs)
        req = _sym.contrib.requantize(
            out[0], out[1], out[2], name=node.name + "_requantize"
        )
        self.qmap[node.name] = (req[0], req[1], req[2])

    def _rewrite_passthrough(self, node):
        q, mn, mx = self.qmap[node.inputs[0]._base().name]
        if node.op.name == "Pooling":
            trip = _sym.contrib.quantized_pooling(q, mn, mx, name=node.name, **dict(node.attrs))
        else:
            trip = _sym.contrib.quantized_flatten(q, mn, mx, name=node.name)
        self.qmap[node.name] = (trip[0], trip[1], trip[2])


def _quantize_symbol(sym, excluded_symbols=None, offline_params=None,
                     quantized_dtype="int8"):
    """Rewrite a float Symbol into its quantized counterpart (reference
    contrib/quantization.py:75 over quantize_graph_pass.cc)."""
    excluded = {s._base().name for s in (excluded_symbols or [])}
    offline = set(offline_params or [])
    rw = _Rewriter(excluded, offline, quantized_dtype)
    for node in sym._walk():
        rw.visit(node)
    outs = []
    for head, idx in sym._outputs_of():
        outs.append(rw.fval(head))
    return outs[0] if len(outs) == 1 else _sym.Group(outs)


def _quantize_params(qsym, params):
    """Offline-quantize parameters consumed as ``*_quantize`` by the rewritten
    graph (reference _quantize_params)."""
    quantized_params = {}
    for name in qsym.list_arguments():
        if name.endswith("_quantize"):
            param = params[name[: -len("_quantize")]]
            # the weight's own min and max as (1,) ranges, on its device
            q, mn, mx = quantize(param, param.amin().reshape(1),
                                 param.amax().reshape(1), out_type="int8")
            quantized_params[name] = q
            quantized_params[name + "_min"] = mn
            quantized_params[name + "_max"] = mx
        elif name in params:
            quantized_params[name] = params[name]
    return quantized_params


def _calibrate_quantized_sym(qsym, th_dict):
    """Attach calibrated ranges to requantize nodes (reference
    _calibrate_quantized_sym :173)."""
    memo = {}

    def rebuild(s):
        if s.is_group:
            return _sym.Group([rebuild(i) for i in s.inputs])
        base = s._base()
        if base.name in memo:
            new_base = memo[base.name]
        else:
            if base.is_var:
                new_base = base
            else:
                new_inputs = [rebuild(i) for i in base.inputs]
                attrs = dict(base.attrs)
                if base.op.name == "_contrib_requantize":
                    layer = base.name[: -len("_requantize")] + "_output"
                    if layer in th_dict:
                        mn, mx = th_dict[layer]
                        attrs["min_calib_range"] = float(mn)
                        attrs["max_calib_range"] = float(mx)
                new_base = Symbol(base.op, new_inputs, attrs, base.name, base.num_outputs)
            memo[base.name] = new_base
        if s.out_index is not None and new_base.num_outputs > 1:
            return new_base[s.out_index]
        return new_base

    return rebuild(qsym)


def _collect_layer_output_min_max(mod, data_iter, include_layer=None,
                                  max_num_examples=None):
    """Run forward over calibration data collecting per-layer (min, max)
    (reference _LayerOutputMinMaxCollector :144).  Each batch's minima and
    maxima are reduced on the device and copied to the host together."""
    th_dict = {}
    num = 0
    for batch in data_iter:
        outs = mod.predict_internals(batch)
        names = [n for n in outs if include_layer is None or include_layer(n)]
        ext = torch.stack([torch.stack((outs[n].amin(), outs[n].amax())).float()
                           for n in names]).cpu().tolist() if names else []
        for name, (mn, mx) in zip(names, ext):
            if name in th_dict:
                th_dict[name] = (min(th_dict[name][0], mn), max(th_dict[name][1], mx))
            else:
                th_dict[name] = (mn, mx)
        num += batch.data[0].shape[0]
        if max_num_examples is not None and num >= max_num_examples:
            break
    return th_dict, num


def _smooth_distribution(p, eps=0.0001):
    """(reference :234; Shannon-entropy smoothing for KL calibration)."""
    is_zeros = (p == 0).astype(np.float32)
    is_nonzeros = (p != 0).astype(np.float32)
    n_zeros = is_zeros.sum()
    n_nonzeros = p.size - n_zeros
    if not n_nonzeros:
        raise ValueError("The discrete probability distribution is malformed. All entries are 0.")
    eps1 = eps * float(n_zeros) / float(n_nonzeros)
    assert eps1 < 1.0, "n_zeros=%d, n_nonzeros=%d, eps1=%f" % (n_zeros, n_nonzeros, eps1)
    hist = p.astype(np.float32)
    hist += eps * is_zeros + (-eps1) * is_nonzeros
    assert (hist <= 0).sum() == 0
    return hist


def _kl_divergence(p, q):
    p = p / p.sum()
    q = q / q.sum()
    mask = p > 0
    return float(np.sum(p[mask] * np.log(p[mask] / np.maximum(q[mask], 1e-12))))


def _get_optimal_threshold(arr, num_bins=8001, num_quantized_bins=255):
    """KL-minimizing threshold (reference :253; 8-bit TensorRT calibration)."""
    arr = np.asarray(arr).ravel()
    th = max(abs(float(arr.min())), abs(float(arr.max())))
    if th == 0:
        return 0.0, 0.0, 0.0, 0.0
    hist, hist_edges = np.histogram(arr, bins=num_bins, range=(-th, th))
    zero_bin_idx = num_bins // 2
    num_half_quantized_bins = num_quantized_bins // 2

    thresholds = np.zeros(num_bins // 2 + 1 - num_quantized_bins // 2)
    divergence = np.zeros_like(thresholds)
    for i in range(num_quantized_bins // 2, num_bins // 2 + 1):
        p_bin_idx_start = zero_bin_idx - i
        p_bin_idx_stop = zero_bin_idx + i + 1
        thresholds[i - num_half_quantized_bins] = hist_edges[p_bin_idx_stop]
        sliced_nd_hist = hist[p_bin_idx_start:p_bin_idx_stop].astype(np.float64)

        p = sliced_nd_hist.copy()
        left_outlier_count = np.sum(hist[0:p_bin_idx_start])
        p[0] += left_outlier_count
        right_outlier_count = np.sum(hist[p_bin_idx_stop:])
        p[-1] += right_outlier_count
        is_nonzeros = (p != 0).astype(np.int32)

        num_merged_bins = sliced_nd_hist.size // num_quantized_bins
        quantized_bins = np.zeros(num_quantized_bins)
        for j in range(num_quantized_bins):
            start = j * num_merged_bins
            stop = start + num_merged_bins
            quantized_bins[j] = sliced_nd_hist[start:stop].sum()
        quantized_bins[-1] += sliced_nd_hist[num_quantized_bins * num_merged_bins:].sum()

        q = np.zeros(sliced_nd_hist.size, dtype=np.float64)
        for j in range(num_quantized_bins):
            start = j * num_merged_bins
            stop = q.size if j == num_quantized_bins - 1 else start + num_merged_bins
            norm = is_nonzeros[start:stop].sum()
            if norm != 0:
                q[start:stop] = float(quantized_bins[j]) / float(norm)
        q[p == 0] = 0
        try:
            p = _smooth_distribution(p)
            q = _smooth_distribution(q)
        except ValueError:
            divergence[i - num_half_quantized_bins] = float("inf")
            continue
        divergence[i - num_half_quantized_bins] = _kl_divergence(p, q)

    min_divergence_idx = int(np.argmin(divergence))
    opt_th = thresholds[min_divergence_idx]
    return float(arr.min()), float(arr.max()), float(divergence[min_divergence_idx]), float(opt_th)


def _get_optimal_thresholds(nd_dict, logger=None):
    th_dict = {}
    for name, arrs in nd_dict.items():
        flat = np.concatenate([a.ravel() for a in arrs])
        _, _, _, opt_th = _get_optimal_threshold(flat)
        th_dict[name] = (-opt_th, opt_th)
        if logger is not None:
            logger.debug("layer=%s th=%f" % (name, opt_th))
    return th_dict


def _collect_layer_outputs(mod, data_iter, include_layer=None,
                           max_num_examples=None):
    nd_dict = {}
    num = 0
    for batch in data_iter:
        outs = mod.predict_internals(batch)
        for name, arr in outs.items():
            if include_layer is not None and not include_layer(name):
                continue
            nd_dict.setdefault(name, []).append(arr.cpu().numpy())
        num += batch.data[0].shape[0]
        if max_num_examples is not None and num >= max_num_examples:
            break
    return nd_dict, num


class _InternalsRunner:
    """Binds ``sym.get_internals()`` once per input shape on ``device`` and
    gives {output name: tensor} per batch."""

    def __init__(self, sym, arg_params, aux_params, data_names, device):
        self.internals = sym.get_internals()
        self.names = self.internals.list_outputs()
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.data_names = data_names
        self.device = device
        self.exe = None
        self.shapes = None

    def predict_internals(self, batch):
        shapes = {n: tuple(d.shape) for n, d in zip(self.data_names, batch.data)}
        if self.exe is None or shapes != self.shapes:
            self.shapes = shapes
            self.exe = self.internals.simple_bind(device=self.device,
                                                  grad_req="null", **shapes)
            for bound, params in ((self.exe.arg_dict, self.arg_params),
                                  (self.exe.aux_dict, self.aux_params)):
                for k, v in params.items():
                    if k in bound:
                        bound[k].copy_(v)
        feed = {n: d for n, d in zip(self.data_names, batch.data)}
        outs = self.exe.forward(is_train=False, **feed)
        return dict(zip(self.names, outs))


def quantize_model(sym, arg_params, aux_params, data_names=("data",), device=None,
                   excluded_sym_names=None, calib_mode="entropy",
                   calib_data=None, num_calib_examples=None, calib_layer=None,
                   quantized_dtype="int8", logger=logging):
    """Generate an int8 model from an fp32 model, optionally calibrated
    (reference contrib/quantization.py:405).

    ``arg_params`` / ``aux_params`` map names to tensors (or arrays); they are
    moved to ``device`` (None means CUDA, which raises without a card unless
    ``device="cpu"``), where the weights are quantized and the calibration
    forwards run.  Returns (qsym, qarg_params, aux_params), the parameters as
    tensors on the device: ``<w>_quantize`` int8 with its (1,) ranges
    ``<w>_quantize_min`` / ``_max``.
    """
    dev = resolve_device(device)
    if excluded_sym_names is None:
        excluded_sym_names = []
    if not isinstance(excluded_sym_names, list):
        raise ValueError("excluded_sym_names must be a list of strings")
    if quantized_dtype not in ("int8", "uint8"):
        raise ValueError("unknown quantized_dtype %s, expected int8 or uint8"
                         % quantized_dtype)
    arg_params = {k: torch.as_tensor(v, device=dev) for k, v in arg_params.items()}
    aux_params = {k: torch.as_tensor(v, device=dev) for k, v in aux_params.items()}

    excluded_syms = []
    nodes = sym.get_internals()
    onames = nodes.list_outputs()
    for name in excluded_sym_names:
        excluded_syms.append(nodes[onames.index(name + "_output")])

    qsym = _quantize_symbol(
        sym, excluded_symbols=excluded_syms,
        offline_params=list(arg_params.keys()), quantized_dtype=quantized_dtype,
    )
    qarg_params = _quantize_params(qsym, arg_params)

    if calib_mode is not None and calib_mode != "none":
        if calib_data is None:
            raise ValueError("calib_data must be provided when calib_mode=%s" % calib_mode)
        if calib_layer is None:
            calib_layer = lambda name: name.endswith("_output")
        runner = _InternalsRunner(sym, arg_params, aux_params, list(data_names), dev)
        if calib_mode == "entropy":
            nd_dict, _ = _collect_layer_outputs(
                runner, calib_data, include_layer=calib_layer,
                max_num_examples=num_calib_examples,
            )
            th_dict = _get_optimal_thresholds(nd_dict, logger=logger)
        elif calib_mode == "naive":
            th_dict, _ = _collect_layer_output_min_max(
                runner, calib_data, include_layer=calib_layer,
                max_num_examples=num_calib_examples,
            )
        else:
            raise ValueError("unknown calibration mode %s, expected none/naive/entropy"
                             % calib_mode)
        qsym = _calibrate_quantized_sym(qsym, th_dict)

    return qsym, qarg_params, aux_params
