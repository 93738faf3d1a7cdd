"""The port's SequentialModule / PythonLossModule and its copy of
``examples/image-classification`` against the JAX package on the CPU.

* the python-loss chain (the MLP Module, then the numpy hinge loss), batch
  8, two SGD steps, against the JAX modules: outputs and parameters within
  rtol 1e-5;
* AlexNet at 3x99x99 (fc1 then sees 256x2x2, 1,024 wide), 10 classes,
  batch 2, and LeNet with its spatial transformer at batch 4: one step of
  ``Module`` with the fit harness's SGD through a ``device`` KVStore,
  against the JAX Module from the same weights: the softmax and the loss
  within rtol 1e-5, and each parameter's update as a whole,
  ‖Δ_port − Δ_jax‖ ≤ 1e-5·‖Δ_jax‖ (a step of lr 0.1 moves weights far
  beyond their start, and elementwise tolerances would read the rounding
  of the large entries in the small ones).  Both packages' Dropout ops take the same
  keep masks, drawn once (each package's own draw cannot repeat the
  other's bits); dropout stays on;
* the port's ``fit.fit`` trains ``train_mnist.py``'s MLP for one short
  epoch on the CPU, its cross-entropy falling.
"""
import argparse
import contextlib
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.examples.image_classification import train_mnist
from mxnet_tpu_torch.examples.image_classification.common import data as tdata, fit as tfit
from mxnet_tpu_torch.examples.image_classification.symbols import alexnet as talexnet
from mxnet_tpu_torch.examples.image_classification.symbols import lenet as tlenet
from mxnet_tpu_torch.examples.image_classification.symbols import mlp as tmlp
from mxnet_tpu_torch.examples.module import python_loss as tpython_loss

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_symbols(name):
    sys.path.insert(0, str(ROOT / "examples" / "image-classification"))
    try:
        return _load("jax_ic_" + name, ROOT / "examples" / "image-classification" / "symbols"
                     / (name + ".py"))
    finally:
        sys.path.pop(0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def same_dropout_masks(masks):
    """Both packages' Dropout ops take ``masks[k % len(masks)]`` at their
    k-th call: each forward meets the Dropout nodes in the same order."""
    jdef, tdef = jreg.get("Dropout"), treg.get("Dropout")
    jfn, tfn = jdef.fn, tdef.fn
    calls = {"j": 0, "t": 0}

    def jdrop(data, *, p=0.5, mode="training", axes=(), training=False, key=None):
        if not training:
            return data
        keep = jnp.asarray(masks[calls["j"] % len(masks)])
        calls["j"] += 1
        return jnp.where(keep, data / (1.0 - p), jnp.zeros_like(data))

    def tdrop(data, *, p=0.5, axes=(), training=False, keep=None, generator=None):
        if not training:
            return data
        keep = torch.from_numpy(masks[calls["t"] % len(masks)]).to(data.device)
        calls["t"] += 1
        return tfn(data, p=p, axes=axes, training=True, keep=keep)

    jdef.fn, tdef.fn = jdrop, tdrop
    try:
        yield calls
    finally:
        jdef.fn, tdef.fn = jfn, tfn


def _modules(jsym, tsym, shapes, seed, optimizer_params, he=False):
    """A JAX and a port Module of the same symbol, bound for training at
    ``shapes``, from the same N(0, 0.05²) weights (with ``he``, N(0, 2/fan
    in) for every weight, so that a deep net's softmax does not saturate),
    each with the fit harness's optimizer through a ``device`` KVStore."""
    data_shape, label_shape = shapes
    jmod = jmx.mod.Module(jsym, context=jmx.cpu())
    tmod = tmx.mod.Module(tsym, device="cpu")
    for mod in (jmod, tmod):
        mod.bind(data_shapes=[("data", data_shape)],
                 label_shapes=[("softmax_label", label_shape)])
    rng = np.random.RandomState(seed)
    arg_shapes, _, _ = tsym.infer_shape(data=data_shape)
    params = {n: (rng.standard_normal(s) * (np.sqrt(2.0 / np.prod(s[1:]))
                                            if he and len(s) > 1 else 0.05)).astype(np.float32)
              for n, s in zip(tsym.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    if "stn_loc_bias" in params:  # the identity transform, a little disturbed
        params["stn_loc_bias"] += np.array(tlenet.IDENTITY, np.float32)
        params["stn_loc_weight"] *= 0.01
    jmod.init_params(arg_params={k: jmx.nd.array(v) for k, v in params.items()})
    tmod.init_params(arg_params={k: torch.from_numpy(v) for k, v in params.items()})
    jmod.init_optimizer(kvstore=jmx.kvstore.create("device"), optimizer="sgd",
                        optimizer_params=dict(optimizer_params))
    tmod.init_optimizer(kvstore=tmx.kvstore.create("device"), optimizer="sgd",
                        optimizer_params=dict(optimizer_params))
    return jmod, tmod, params


def _step_and_compare(jmod, tmod, x, y, what, params):
    jb = jmx.io.DataBatch([jmx.nd.array(x)], [jmx.nd.array(y)])
    tb = tmx.io.DataBatch([torch.from_numpy(x)], [torch.from_numpy(y)])
    for mod, b in ((jmod, jb), (tmod, tb)):
        mod.forward(b, is_train=True)
        mod.backward()
    jp = jmod.get_outputs()[0].asnumpy()
    tp = tmod.get_outputs()[0].numpy()
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-7, err_msg=what + " softmax")
    rows = np.arange(len(y))
    jloss = -np.log(jp[rows, y.astype(int)]).mean()
    tloss = -np.log(tp[rows, y.astype(int)]).mean()
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5, err_msg=what + " loss")
    jmod.update()
    tmod.update()
    jargs, tparams = jmod.get_params()[0], tmod.get_params()[0]
    for name, v in tparams.items():
        dj = jargs[name].asnumpy() - params[name]
        dt = v.numpy() - params[name]
        assert np.linalg.norm(dj) > 0, (what, name)
        assert np.linalg.norm(dt - dj) <= 1e-5 * np.linalg.norm(dj), (
            what, name, np.linalg.norm(dt - dj) / np.linalg.norm(dj))
    return tloss


FIT_SGD = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)


def test_alexnet_step_against_jax():
    tsym = talexnet.get_symbol(num_classes=10)
    jsym = _jax_symbols("alexnet").get_symbol(num_classes=10)
    assert tsym.list_arguments() == jsym.list_arguments()
    jmod, tmod, params = _modules(jsym, tsym, ((2, 3, 99, 99), (2,)), 11, FIT_SGD, he=True)
    assert params["fc1_weight"].shape == (4096, 1024)
    rng = np.random.RandomState(12)
    masks = [rng.uniform(size=(2, 4096)) < 0.5 for _ in range(2)]
    x = rng.uniform(-1, 1, (2, 3, 99, 99)).astype(np.float32)
    y = np.array([3, 7], np.float32)
    with same_dropout_masks(masks) as calls:
        loss = _step_and_compare(jmod, tmod, x, y, "alexnet", params)
    assert calls["t"] >= 2 and calls["j"] >= 2
    assert np.isfinite(loss) and loss > 0.1, loss


def test_lenet_stn_step_against_jax():
    tsym = tlenet.get_symbol(num_classes=10, add_stn=True)
    # the JAX copy's add_stn symbol does not build (its SpatialTransformer
    # gets no target_shape); the same graph from the JAX package's ops
    sym = jmx.sym
    data = sym.Variable("data")
    lr_mult = {"__lr_mult__": "0.01"}
    loc = sym.FullyConnected(sym.Flatten(data), num_hidden=6, name="stn_loc",
                             weight=sym.Variable("stn_loc_weight", attr=lr_mult),
                             bias=sym.Variable("stn_loc_bias", attr=lr_mult))
    stn = sym.SpatialTransformer(data, loc, target_shape=(28, 28), transform_type="affine",
                                 name="stn")
    jsym = _lenet_tail(sym, stn)
    assert tsym.list_arguments() == jsym.list_arguments()
    jmod, tmod, params = _modules(jsym, tsym, ((4, 1, 28, 28), (4,)), 21,
                                  dict(learning_rate=0.05, momentum=0.9, wd=1e-4))
    rng = np.random.RandomState(22)
    x = rng.standard_normal((4, 1, 28, 28)).astype(np.float32)
    y = np.array([1, 0, 9, 4], np.float32)
    _step_and_compare(jmod, tmod, x, y, "lenet-stn", params)


def _lenet_tail(sym, data):
    conv1 = sym.Convolution(data, kernel=(5, 5), num_filter=20, name="conv1")
    tanh1 = sym.Activation(conv1, act_type="tanh")
    pool1 = sym.Pooling(tanh1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    conv2 = sym.Convolution(pool1, kernel=(5, 5), num_filter=50, name="conv2")
    tanh2 = sym.Activation(conv2, act_type="tanh")
    pool2 = sym.Pooling(tanh2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    fc1 = sym.FullyConnected(sym.Flatten(pool2), num_hidden=500, name="fc1")
    fc2 = sym.FullyConnected(sym.Activation(fc1, act_type="tanh"), num_hidden=10, name="fc2")
    return sym.SoftmaxOutput(fc2, name="softmax")


def test_python_loss_sequential_module_against_jax():
    jex = _load("jax_python_loss", ROOT / "examples" / "module" / "python_loss.py")
    x, y = tpython_loss.data()
    x, y = x[:16], y[:16]

    def jbuild():
        d = jmx.sym.Variable("data")
        net = jmx.sym.FullyConnected(d, name="fc1", num_hidden=64)
        net = jmx.sym.Activation(net, name="relu1", act_type="relu")
        net = jmx.sym.FullyConnected(net, name="fc2", num_hidden=5)
        mlp = jmx.mod.Module(net, label_names=(), context=jmx.cpu())
        loss = jmx.mod.PythonLossModule(grad_func=jex.mc_hinge_grad)
        return jmx.mod.SequentialModule().add(mlp).add(loss, take_labels=True,
                                                       auto_wiring=True)

    jmod = jbuild()
    with tmx.cpu():
        tmod = tpython_loss.build()
    rng = np.random.RandomState(31)
    params = {"fc1_weight": rng.standard_normal((64, 24)) * 0.1, "fc1_bias": np.zeros(64),
              "fc2_weight": rng.standard_normal((5, 64)) * 0.1, "fc2_bias": np.zeros(5)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    for mod, arr in ((jmod, jmx.nd.array), (tmod, torch.from_numpy)):
        mod.bind(data_shapes=[("data", (8, 24))], label_shapes=[("softmax_label", (8,))])
        mod.init_params(arg_params={k: arr(v) for k, v in params.items()})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.2, "momentum": 0.9})
    assert tmod.output_shapes == [("pyloss_output", (8, 5))]
    for step in range(2):
        xs, ys = x[8 * step:8 * step + 8], y[8 * step:8 * step + 8]
        jmod.forward(jmx.io.DataBatch([jmx.nd.array(xs)], [jmx.nd.array(ys)]), is_train=True)
        tmod.forward(tmx.io.DataBatch([torch.from_numpy(xs)], [torch.from_numpy(ys)]),
                     is_train=True)
        np.testing.assert_allclose(tmod.get_outputs()[0].numpy(),
                                   jmod.get_outputs()[0].asnumpy(), rtol=1e-5, atol=1e-6)
        for mod in (jmod, tmod):
            mod.backward()
            mod.update()
        jargs, targs = jmod.get_params()[0], tmod.get_params()[0]
        assert sorted(targs) == sorted(jargs)
        for name, v in targs.items():
            np.testing.assert_allclose(v.numpy(), jargs[name].asnumpy(), rtol=1e-5, atol=1e-6,
                                       err_msg="%s after step %d" % (name, step))


def _cross_entropy(mod, it):
    return dict(mod.score(it, "ce"))["cross-entropy"]


def test_fit_trains_the_mnist_mlp_on_the_cpu():
    args = train_mnist.make_parser().parse_args(
        ["--num-epochs", "1", "--num-examples", "640", "--ctx", "cpu", "--disp-batches", "5"])
    with tmx.cpu():
        train, _ = train_mnist.get_mnist_iter(args, None)
        start = tmx.mod.Module(tmlp.get_symbol(), device="cpu")
        start.bind(data_shapes=train.provide_data, label_shapes=train.provide_label)
        start.init_params(tfit.make_initializer("default"))
        before = _cross_entropy(start, train)
    model = train_mnist.main(["--num-epochs", "1", "--num-examples", "640", "--ctx", "cpu",
                              "--disp-batches", "5"])
    with tmx.cpu():
        after = _cross_entropy(model, train)
    assert after < 0.5 * before, (before, after)


def test_what_is_not_ported_raises_naming_its_item():
    parser = argparse.ArgumentParser()
    tfit.add_fit_args(parser)
    tdata.add_data_args(parser)
    a = parser.parse_args(["--image-shape", "3,8,8", "--num-classes", "2"])
    with pytest.raises(NotImplementedError, match="A11"):
        tdata.get_rec_iter(a)
    a.monitor = 2
    with pytest.raises(NotImplementedError, match="A10"):
        tfit.fit(a, talexnet.get_symbol(num_classes=2), tdata.get_rec_iter)
    with pytest.raises(NotImplementedError, match="A8.3"):
        tmx.mod.BucketingModule(lambda k: None, default_bucket_key=1, state_names=["s"],
                                device="cpu")


def _deconv_prelu(sym):
    h = sym.Deconvolution(sym.Variable("data"), kernel=(4, 4), stride=(2, 2), num_filter=6,
                          num_group=2, no_bias=False, name="up")
    return sym.LeakyReLU(h, act_type="prelu", name="act")


@pytest.mark.parametrize("net", ["alexnet", "lenet_stn", "python_loss_mlp", "deconv_prelu"])
def test_symbol_params_from_jax_carries_the_recipes_weights(net):
    """``symbol_params_from_jax`` takes the JAX side's ``arg_params`` of each
    recipe's symbol (and of Deconvolution's grouped weight and LeakyReLU's
    prelu ``gamma``) to the port's symbol, value for value."""
    from mxnet_tpu_torch.gluon.model_zoo.convert import symbol_params_from_jax

    shape = {"alexnet": (2, 3, 99, 99), "lenet_stn": (2, 1, 28, 28),
             "python_loss_mlp": (2, 24), "deconv_prelu": (1, 4, 5, 5)}[net]
    if net == "alexnet":
        jsym = _jax_symbols("alexnet").get_symbol(num_classes=10)
        tsym = talexnet.get_symbol(num_classes=10)
    elif net == "lenet_stn":
        tsym = tlenet.get_symbol(add_stn=True)
        jsym = None
    elif net == "python_loss_mlp":
        with tmx.cpu():
            tsym = tpython_loss.build()._modules[0].symbol
        jsym = None
    else:
        jsym, tsym = _deconv_prelu(jmx.sym), _deconv_prelu(tmx.sym)
    names = tsym.list_arguments()
    if jsym is not None:
        assert jsym.list_arguments() == names
    arg_shapes = tsym.infer_shape(data=shape)[0]
    given = {n: ((np.arange(np.prod(s)) * 7 + i) % 251).astype(np.float32).reshape(s)
             for i, (n, s) in enumerate(zip(names, arg_shapes))
             if n not in ("data", "softmax_label")}
    args, aux = symbol_params_from_jax(tsym, given, {}, device="cpu", data=shape)
    assert sorted(args) == sorted(given) and not aux
    for n, v in given.items():
        assert np.array_equal(args[n].numpy(), v), n
