"""The port's symbolic training path (mxnet_tpu_torch: SoftmaxOutput's
fused gradient, ``Executor`` training forward and ``backward``, ``Module``,
SGD, ``Module.fit``, checkpoints) against the JAX package, on the CPU.

Two networks: bench.py's ``MXNET_BENCH=module`` MLP (fc1 128→256, relu,
fc2 256→256, relu, fc3 256→10, SoftmaxOutput) at batch 8, and the CIFAR
ResNet-8 v2 of train_cifar10.py's symbol builder (``get_symbol(10, 8,
"3,28,28")``, batch-statistics BatchNorm) at batch 4, both built under a
fresh name manager so that node names match.  Weights cross from numpy
(He-scaled weights, BN affine around 1 and 0, moving statistics around 0
and 1): the two packages' random streams differ, so nothing freshly
initialised is compared.

Tolerances: SoftmaxOutput's gradient rtol 1e-5; executor outputs,
gradients and moving statistics rtol 1e-4 / atol 1e-5; parameters after
Module steps rtol 1e-4 (fp32 sums in another order, three steps).
"""
import math
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import lr_scheduler as jlrs
from mxnet_tpu import metric as jmetric
from mxnet_tpu import module as jmodule
from mxnet_tpu.io import DataBatch as JaxBatch
from mxnet_tpu.io import NDArrayIter as JaxIter
from mxnet_tpu.name import NameManager as JaxNameManager
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu_torch import lr_scheduler as tlrs
from mxnet_tpu_torch import metric as tmetric
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.io import DataBatch, NDArrayIter
from mxnet_tpu_torch.models import resnet_symbol
from mxnet_tpu_torch.module import Module
from mxnet_tpu_torch.ops import nn as tnn

from conftest import load_example_module

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
NETS = {"mlp": (8, (8, 128)), "resnet8": (4, (4, 3, 28, 28))}
SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps this file off
    the cores that the suite's parallel workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mlp(S):
    """bench.py main_module's symbol."""
    data = S.var("data")
    h = S.Activation(S.FullyConnected(data, name="fc1", num_hidden=256), name="a1",
                     act_type="relu")
    h = S.Activation(S.FullyConnected(h, name="fc2", num_hidden=256), name="a2",
                     act_type="relu")
    return S.SoftmaxOutput(S.FullyConnected(h, name="fc3", num_hidden=10), name="softmax")


def _symbols(net):
    """(JAX symbol, port symbol) of ``net``."""
    if net == "mlp":
        with JaxNameManager():
            j = _mlp(mx.sym)
        with tsym.NameManager():
            return j, _mlp(tsym)
    m = load_example_module(
        "image_classification_resnet_symbols",
        str(ROOT / "examples" / "image-classification" / "symbols" / "resnet.py"))
    with JaxNameManager():
        j = m.get_symbol(10, 8, "3,28,28")
    with tsym.NameManager():
        return j, resnet_symbol.get_symbol(10, 8, "3,28,28")


def _params(jsym, shape, rng):
    arg_shapes, _, aux_shapes = jsym.infer_shape(data=shape)
    args, aux = {}, {}
    for n, s in zip(jsym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_weight"):
            v = rng.randn(*s) * math.sqrt(2.0 / np.prod(s[1:]))
        elif n.endswith("_gamma"):
            v = rng.uniform(0.5, 1.5, s)
        else:
            v = rng.randn(*s) * 0.1
        args[n] = v.astype(np.float32)
    for n, s in zip(jsym.list_auxiliary_states(), aux_shapes):
        v = rng.uniform(0.5, 1.5, s) if n.endswith("_var") else rng.randn(*s) * 0.1
        aux[n] = v.astype(np.float32)
    return args, aux


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else a.asnumpy()


@pytest.fixture(scope="module")
def nets():
    out = {}
    for i, (net, (batch, shape)) in enumerate(NETS.items()):
        rng = np.random.RandomState(i)
        jsym, psym = _symbols(net)
        args, aux = _params(jsym, shape, rng)
        batches = [(rng.randn(*shape).astype(np.float32),
                    rng.randint(0, 10, (batch,)).astype(np.float32)) for _ in range(3)]
        out[net] = dict(jsym=jsym, psym=psym, args=args, aux=aux, batches=batches,
                        shape=shape, batch=batch)
    return out


# -- SoftmaxOutput's fused gradient -------------------------------------------


@pytest.mark.parametrize("smooth_alpha", [0.0, 0.1])
@pytest.mark.parametrize("multi_output", [False, True], ids=["last_axis", "multi_output"])
@pytest.mark.parametrize("use_ignore", [False, True], ids=["all", "use_ignore"])
@pytest.mark.parametrize("normalization", ["null", "batch", "valid"])
def test_softmax_output_gradient_matches_jax(normalization, use_ignore, multi_output,
                                             smooth_alpha):
    """(p − onehot)·scale with smoothing, ignore-label masking and the three
    normalizations, whatever the cotangent (a random one here); the label's
    gradient is zero."""
    rng = np.random.RandomState(7)
    shape, lshape = ((3, 5, 4), (3, 4)) if multi_output else ((6, 5), (6,))
    data = rng.randn(*shape).astype(np.float32)
    label = rng.randint(-1, 5, lshape).astype(np.float32)  # -1 is ignore_label
    cot = rng.randn(*shape).astype(np.float32)
    attrs = dict(grad_scale=1.5, multi_output=multi_output, use_ignore=use_ignore,
                 normalization=normalization, smooth_alpha=smooth_alpha)
    jout, vjp = jax.vjp(lambda d, l: jnn.softmax_output(d, l, **attrs),
                        jnp.asarray(data), jnp.asarray(label))
    jgrad, jlgrad = vjp(jnp.asarray(cot))
    td = torch.from_numpy(data).requires_grad_()
    tl = torch.from_numpy(label).requires_grad_()
    out = tnn.softmax_output(td, tl, **attrs)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-7)
    assert not tl.grad.any() and not np.asarray(jlgrad).any()
    if use_ignore:
        rows = (label == -1)
        axis = 1 if multi_output else -1
        assert rows.any() and not np.take(td.grad.numpy(), 0, axis=axis)[rows].any()


def test_softmax_output_head_ignores_its_cotangent(nets):
    """backward() (ones) and backward(out_grads=anything) give the same
    gradients through a SoftmaxOutput head; the inference forward is the
    plain softmax."""
    n = nets["mlp"]
    exe = n["psym"].simple_bind(device="cpu", data=n["shape"])
    exe.copy_params_from(n["args"])
    x, y = n["batches"][0]
    exe.forward(is_train=True, data=x, softmax_label=y)
    exe.backward()
    ones = {k: v.clone() for k, v in exe.grad_dict.items()}
    exe.backward(out_grads=torch.randn(8, 10, generator=torch.Generator().manual_seed(1)))
    for k, v in exe.grad_dict.items():
        assert torch.equal(v, ones[k]), k
    assert ones["fc1_weight"].abs().max() > 0
    out = exe.forward(data=x)[0]
    h = torch.relu(torch.from_numpy(x) @ exe.arg_dict["fc1_weight"].T + exe.arg_dict["fc1_bias"])
    h = torch.relu(h @ exe.arg_dict["fc2_weight"].T + exe.arg_dict["fc2_bias"])
    ref = torch.softmax(h @ exe.arg_dict["fc3_weight"].T + exe.arg_dict["fc3_bias"], -1)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-7)


# -- Executor: training forward and backward ------------------------------------


def _grad_req(names):
    """Weights "write", biases, gammas and betas "add", the first bias and
    the inputs "null"."""
    req = {}
    first_bias = next(n for n in names if n.endswith(("_bias", "_beta")))
    for n in names:
        if n in ("data", "softmax_label") or n == first_bias:
            req[n] = "null"
        elif n.endswith("_weight"):
            req[n] = "write"
        else:
            req[n] = "add"
    return req


def _second_head(net, sym):
    """An internal output to group with the softmax head: a head whose
    cotangent the gradient does read.  In the ResNet it is conv0's output,
    before the batch-statistics BatchNorms: the ones cotangent of an output
    behind one is constant over each channel and cancels inside its
    backward, leaving rounding noise on both sides."""
    name = "a2_output" if net == "mlp" else "conv0_output"
    internals = sym.get_internals()
    return internals[internals.list_outputs().index(name)]


@pytest.mark.parametrize("net", list(NETS))
def test_executor_training_forward_and_backward_match_jax(nets, net):
    """forward(is_train=True): outputs and moving statistics; backward()
    with ones; backward(out_grads) on a second head; grad_req write / add /
    null per argument."""
    n = nets[net]
    x, y = n["batches"][0]
    jsym = mx.sym.Group([n["jsym"], _second_head(net, n["jsym"])])
    psym = tsym.Group([n["psym"], _second_head(net, n["psym"])])
    req = _grad_req(jsym.list_arguments())
    jexe = jsym.simple_bind(grad_req=req, data=n["shape"], softmax_label=(n["batch"],))
    pexe = psym.simple_bind(device="cpu", grad_req=req, data=n["shape"],
                            softmax_label=(n["batch"],))
    for bound, params in ((jexe.arg_dict, n["args"]), (jexe.aux_dict, n["aux"])):
        for k, v in params.items():
            bound[k][:] = v
    pexe.copy_params_from(n["args"], n["aux"])
    for k in req:  # "add" accumulates onto what is there
        jexe.grad_dict[k][:] = 0.5
        pexe.grad_dict[k].fill_(0.5)
    jout = jexe.forward(is_train=True, data=mx.nd.array(x), softmax_label=mx.nd.array(y))
    pout = pexe.forward(is_train=True, data=torch.from_numpy(x),
                        softmax_label=torch.from_numpy(y))
    for got, ref in zip(pout, jout):
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-4, atol=1e-5)
    for k in n["aux"]:
        assert not np.array_equal(_np(jexe.aux_dict[k]), n["aux"][k]), k
        np.testing.assert_allclose(_np(pexe.aux_dict[k]), _np(jexe.aux_dict[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    g2 = np.random.RandomState(3).randn(*jout[1].shape).astype(np.float32)
    for out_grads in (None, [np.ones(jout[0].shape, np.float32), g2]):
        jexe.backward(out_grads=None if out_grads is None else [mx.nd.array(g) for g in out_grads])
        pexe.backward(out_grads=out_grads)
        for k, r in req.items():
            got, ref = _np(pexe.grad_dict[k]), _np(jexe.grad_dict[k])
            if r == "null":
                assert (got == 0.5).all() and (ref == 0.5).all(), k
                continue
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5, err_msg=k)
    for k in n["aux"]:  # backward updates no moving statistic
        np.testing.assert_allclose(_np(pexe.aux_dict[k]), _np(jexe.aux_dict[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_executor_reshape_and_output_dict(nets):
    n = nets["mlp"]
    exe = n["psym"].simple_bind(device="cpu", data=n["shape"])
    exe.copy_params_from(n["args"])
    small = exe.reshape(data=(2, 128), softmax_label=(2,))
    assert small.arg_dict["fc1_weight"] is exe.arg_dict["fc1_weight"]
    assert small.arg_dict["data"].shape == (2, 128) and "fc1_weight" in small.grad_dict
    out = small.forward(data=n["batches"][0][0][:2])
    assert list(small.output_dict) == ["softmax_output"] and out[0].shape == (2, 10)
    with pytest.raises(ValueError, match="unknown argument"):
        exe.copy_params_from({"nope": np.zeros(3)})


# -- Module ----------------------------------------------------------------------


def _jax_module(n, opt=SGD, **kw):
    m = jmodule.Module(n["jsym"], context=mx.cpu())
    m.bind(data_shapes=[("data", n["shape"])], label_shapes=[("softmax_label", (n["batch"],))])
    m.init_params(arg_params={k: mx.nd.array(v) for k, v in n["args"].items()},
                  aux_params={k: mx.nd.array(v) for k, v in n["aux"].items()}, **kw)
    m.init_optimizer(optimizer="sgd", optimizer_params=dict(opt))
    return m


def _port_module(n, opt=SGD):
    m = Module(n["psym"], device="cpu")
    m.bind(data_shapes=[("data", n["shape"])], label_shapes=[("softmax_label", (n["batch"],))])
    m.init_params(arg_params=n["args"], aux_params=n["aux"])
    m.init_optimizer(optimizer="sgd", optimizer_params=dict(opt))
    return m


@pytest.fixture(scope="module")
def steps(nets):
    """Three forward_backward + update of each network at wd 1e-2 on both
    sides from the same weights: every parameter and moving statistic after
    each step."""
    out = {}
    for net, n in nets.items():
        jm, pm = _jax_module(n), _port_module(n)
        rec = []
        for x, y in n["batches"]:
            jm.forward_backward(JaxBatch(data=[mx.nd.array(x)], label=[mx.nd.array(y)]))
            jm.update()
            pm.forward_backward(DataBatch([torch.from_numpy(x)], [torch.from_numpy(y)]))
            pm.update()
            (ja, jx), (pa, px) = jm.get_params(), pm.get_params()
            rec.append(({k: _np(v) for k, v in {**ja, **jx}.items()},
                        {k: _np(v).copy() for k, v in {**pa, **px}.items()},
                        _np(jm.get_outputs()[0]), _np(pm.get_outputs()[0])))
        out[net] = rec
    return out


@pytest.mark.parametrize("step", range(3))
@pytest.mark.parametrize("net", list(NETS))
def test_module_steps_match_jax(nets, steps, net, step):
    ref, got, jout, pout = steps[net][step]
    assert sorted(got) == sorted(ref)
    np.testing.assert_allclose(pout, jout, rtol=1e-4, atol=1e-6)
    start = {**nets[net]["args"], **nets[net]["aux"]}
    for k, r in ref.items():
        assert not np.array_equal(r, start[k]) or k.startswith("bn_data_gamma"), k
        np.testing.assert_allclose(got[k], r, rtol=1e-4, atol=1e-6 * np.abs(r).max(),
                                   err_msg=k)


def test_weight_decay_spares_biases_and_betas(nets, steps):
    """At wd 1e-2 the exemption of ``_bias`` / ``_beta`` shows: their first
    update is −lr·rescale·grad exactly, with no decay term."""
    n = nets["resnet8"]
    pm = _port_module(n)
    x, y = n["batches"][0]
    pm.forward_backward(DataBatch([torch.from_numpy(x)], [torch.from_numpy(y)]))
    grads = {k: v.clone() for k, v in pm._exec.grad_dict.items()}
    pm.update()
    opt = pm._optimizer
    assert opt.rescale_grad == 1.0 / 4
    for name in ("bn1_beta", "fc1_bias", "stage1_unit1_bn1_gamma", "fc1_weight"):
        w0 = torch.from_numpy(n["args"][name])
        g = grads[name] * opt.rescale_grad
        wd = 0.0 if name.endswith(("_beta", "_bias")) else 1e-2
        want = w0 + (0.9 * torch.zeros_like(w0) - 0.05 * (g + wd * w0))
        torch.testing.assert_close(pm.get_params()[0][name], want, rtol=0, atol=0)


def test_multi_tensor_update_equals_the_per_parameter_updater(nets):
    """Module.update (one multi-tensor step) against the Updater applied
    parameter by parameter, bit for bit, over two steps with a clip."""
    n = nets["resnet8"]
    opt = dict(SGD, clip_gradient=0.05)
    pm, ref = _port_module(n, opt), _port_module(n, opt)
    updater = topt.get_updater(ref._optimizer)
    for x, y in n["batches"][:2]:
        b = DataBatch([torch.from_numpy(x)], [torch.from_numpy(y)])
        pm.forward_backward(b)
        pm.update()
        ref.forward_backward(b)
        for i, name in enumerate(ref._param_names):
            updater(i, ref._exec.grad_dict[name], ref._exec.arg_dict[name])
        for k, v in ref.get_params()[0].items():
            assert torch.equal(pm.get_params()[0][k], v), k
    for i, s in updater.states.items():
        assert torch.equal(pm._updater.states[i], s)


def test_module_fit_matches_jax(nets):
    """One epoch of 3 batches through Module.fit with a MultiFactorScheduler
    (the lr falls after the second update) and Accuracy: the metric after
    each batch, the parameters after the epoch, and score."""
    n = nets["mlp"]
    x = np.concatenate([b[0] for b in n["batches"]])
    y = np.concatenate([b[1] for b in n["batches"]])
    res = []
    for side in ("jax", "port"):
        seen = []
        cb = lambda p, s=seen: s.append(p.eval_metric.get()[1])
        if side == "jax":
            mod = jmodule.Module(n["jsym"], context=mx.cpu())
            it = JaxIter(x, y, batch_size=n["batch"])
            metric, sched, args = jmetric.Accuracy(), jlrs.MultiFactorScheduler([2], 0.1), \
                {k: mx.nd.array(v) for k, v in n["args"].items()}
        else:
            mod = Module(n["psym"], device="cpu")
            it = NDArrayIter(torch.from_numpy(x), torch.from_numpy(y), batch_size=n["batch"])
            metric, sched, args = tmetric.Accuracy(), tlrs.MultiFactorScheduler([2], 0.1), \
                n["args"]
        mod.fit(it, eval_metric=metric, batch_end_callback=cb, optimizer="sgd",
                optimizer_params=dict(SGD, lr_scheduler=sched), arg_params=args, num_epoch=1)
        score = mod.score(it, "acc")
        res.append((seen, {k: _np(v) for k, v in mod.get_params()[0].items()}, score,
                    mod._optimizer._get_lr(0)))
    (jseen, jparams, jscore, jlr), (pseen, pparams, pscore, plr) = res
    assert len(pseen) == 3 and pseen == jseen and plr == jlr == pytest.approx(0.005)
    assert pscore == jscore
    for k, r in jparams.items():
        np.testing.assert_allclose(pparams[k], r, rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_in_the_other_package(nets, tmp_path, writer):
    """One package trains a step and saves prefix-symbol.json,
    prefix-0001.params and the optimizer states; the other loads them with
    Module.load and takes the second step, which must equal the writer's own
    second step."""
    n = nets["mlp"]
    prefix = str(tmp_path / "mlp")
    (x0, y0), (x1, y1) = n["batches"][:2]
    jb = [JaxBatch(data=[mx.nd.array(x)], label=[mx.nd.array(y)]) for x, y in ((x0, y0), (x1, y1))]
    pb = [DataBatch([torch.from_numpy(x)], [torch.from_numpy(y)]) for x, y in ((x0, y0), (x1, y1))]
    first, batches = (_jax_module(n), jb) if writer == "jax" else (_port_module(n), pb)
    first.forward_backward(batches[0])
    first.update()
    first.save_checkpoint(prefix, 1, save_optimizer_states=True)
    first.forward_backward(batches[1])
    first.update()
    if writer == "jax":
        other = Module.load(prefix, 1, load_optimizer_states=True, device="cpu")
        other.bind(data_shapes=[("data", n["shape"])],
                   label_shapes=[("softmax_label", (n["batch"],))])
        batch = pb[1]
    else:
        other = jmodule.Module.load(prefix, 1, load_optimizer_states=True, context=mx.cpu())
        other.bind(data_shapes=[("data", n["shape"])],
                   label_shapes=[("softmax_label", (n["batch"],))])
        batch = jb[1]
    other.init_params()
    other.init_optimizer(optimizer="sgd", optimizer_params=dict(SGD))
    other.forward_backward(batch)
    other.update()
    want = {k: _np(v) for k, v in first.get_params()[0].items()}
    got = {k: _np(v) for k, v in other.get_params()[0].items()}
    assert sorted(got) == sorted(want)
    for k, r in want.items():
        np.testing.assert_allclose(got[k], r, rtol=1e-4, atol=1e-6, err_msg=k)
    with open(prefix + "-0001.states", "rb") as f:
        states = pickle.load(f)
    assert sorted(states) == list(range(6)) and all(isinstance(v, np.ndarray)
                                                    for v in states.values())


def test_predict_input_grads_and_params_files_match_jax(nets, tmp_path):
    """``predict`` over 20 samples in batches of 8 (the last padded by 4,
    cut off), the data gradient of ``bind(inputs_need_grad=True)``, and a
    ``save_params`` file of the port loaded by the JAX Module."""
    n = nets["mlp"]
    x = np.concatenate([b[0] for b in n["batches"]])[:20]
    y = np.concatenate([b[1] for b in n["batches"]])[:20]
    shapes = dict(data_shapes=[("data", n["shape"])],
                  label_shapes=[("softmax_label", (n["batch"],))], inputs_need_grad=True)
    jm = jmodule.Module(n["jsym"], context=mx.cpu())
    jm.bind(**shapes)
    jm.init_params(arg_params={k: mx.nd.array(v) for k, v in n["args"].items()})
    pm = Module(n["psym"], device="cpu")
    pm.bind(**shapes)
    pm.init_params(arg_params=n["args"])
    jpred = jm.predict(JaxIter(x, y, batch_size=8)).asnumpy()
    ppred = pm.predict(NDArrayIter(torch.from_numpy(x), torch.from_numpy(y), batch_size=8))
    assert ppred.shape == jpred.shape == (20, 10)
    np.testing.assert_allclose(ppred.numpy(), jpred, rtol=1e-5, atol=1e-7)
    bx, by = n["batches"][1]
    jm.forward_backward(JaxBatch(data=[mx.nd.array(bx)], label=[mx.nd.array(by)]))
    pm.forward_backward(DataBatch([torch.from_numpy(bx)], [torch.from_numpy(by)]))
    jgrad, pgrad = _np(jm.get_input_grads()[0]), _np(pm.get_input_grads()[0])
    assert np.abs(jgrad).max() > 0
    np.testing.assert_allclose(pgrad, jgrad, rtol=1e-4, atol=1e-7)
    pm.save_params(str(tmp_path / "mlp.params"))
    back = jmodule.Module(n["jsym"], context=mx.cpu())
    back.bind(data_shapes=[("data", n["shape"])], label_shapes=[("softmax_label", (8,))])
    back.load_params(str(tmp_path / "mlp.params"))
    for k, v in back.get_params()[0].items():
        np.testing.assert_array_equal(_np(v), n["args"][k])


def test_module_refuses_what_is_not_ported(nets):
    n = nets["mlp"]
    with pytest.raises(NotImplementedError, match="A10"):
        Module(n["psym"], device="cpu", mesh=object())
    mod = Module(n["psym"], device="cpu")
    mod.bind(data_shapes=[("data", n["shape"])], label_shapes=[("softmax_label", (8,))])
    mod.init_params(arg_params=n["args"])
    with pytest.raises(NotImplementedError, match="A10"):
        mod.init_optimizer(kvstore="dist_sync")
    with pytest.raises(NotImplementedError, match="A10"):
        mod.init_optimizer(kvstore="nccl")
    with pytest.warns(UserWarning, match="rescale_grad"):
        mod.init_optimizer(optimizer=topt.SGD(learning_rate=0.1))
