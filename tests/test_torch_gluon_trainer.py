"""The port's Gluon Parameter / ParameterDict / Trainer and its blocks on
NDArrays (deferred shapes, ``collect_params``' names, the training flag)
against mxnet_tpu.gluon, on the CPU.  Losses and weights within rtol 1e-5
(fp32 sums in another order, through a few BatchNorm steps)."""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.examples.deformable_rfcn.deformable_rfcn import DeformableRFCN
from mxnet_tpu_torch.gluon.model_zoo import load_jax_params

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
EXDIR = os.path.join(ROOT, "examples", "deformable_rfcn")


def _jax_example():
    from conftest import load_example_module

    return load_example_module("dfrfcn_model_for_port", os.path.join(EXDIR, "deformable_rfcn.py"))


@pytest.fixture(scope="module", autouse=True)
def _cpu_context():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with tmx.cpu():
        yield
    torch.set_num_threads(n)


def _jax_names(jnet):
    return {k[len(jnet.prefix):]: p for k, p in jnet.collect_params().items()}


def test_example_names_and_deferred_shapes():
    """The example's net: the same Gluon names and (deferred) shapes as the
    JAX net's, each 0 completed at the first forward (the JAX net's
    completed shapes are checked where its weights cross,
    ``test_torch_imperative_rfcn.py``)."""
    jnet = _jax_example().DeformableRFCN(num_classes=2)
    jnet.initialize()
    tnet = DeformableRFCN(num_classes=2)
    tnet.initialize()
    tparams = tnet.collect_params()
    assert {k: p.shape for k, p in tparams.items()} == {
        k: p.shape for k, p in _jax_names(jnet).items()}
    assert tparams["backbone_down0_weight"].shape == (16, 0, 3, 3)
    assert tnet.backbone.body[0].weight is None
    with pytest.raises(tmx.gluon.DeferredInitializationError):
        tparams["backbone_down0_weight"].data()
    x = np.random.RandomState(0).rand(1, 3, 64, 64).astype(np.float32)
    info = np.array([[64, 64, 1.0]], np.float32)
    tnet(tmx.nd.array(x), tmx.nd.array(info))
    shapes = {k: p.shape for k, p in tnet.collect_params().items()}
    assert not [k for k, s in shapes.items() if 0 in s]
    assert shapes["backbone_down0_weight"] == (16, 3, 3, 3)
    assert shapes["backbone_batchnorm2_running_var"] == (64,)
    assert shapes["rpn_conv_weight"] == (64, 64, 3, 3)
    assert shapes["pscls_weight"] == (27, 64, 1, 1)
    assert all(p.grad_req == ("null" if "running" in k else "write")
               for k, p in tnet.collect_params().items())
    assert sorted(tnet.collect_params("backbone_down.*_weight").keys()) == [
        "backbone_down%d_weight" % i for i in range(3)]


def _tiny(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="tiny_")
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(), nn.Activation("relu"),
                nn.Dense(8, activation="relu"), nn.Dense(5))
    return net


def _batches():
    rng = np.random.RandomState(3)
    return [(rng.randn(6, 2, 5, 5).astype(np.float32),
             rng.randint(0, 5, (6,)).astype(np.float32)) for _ in range(3)]


def _train(mx, net, trainer, batches):
    ctx = tmx.cpu() if mx is tmx else None
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for x, y in batches:
        with mx.autograd.record():
            loss = loss_fn(net(mx.nd.array(x, ctx=ctx)), mx.nd.array(y, ctx=ctx))
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(loss.mean().asscalar()))
    return losses


def _copy_jax_weights(jnet, tnet, x):
    tnet(tmx.nd.array(x))  # complete the deferred shapes
    load_jax_params(tnet, {k: p.data().asnumpy() for k, p in _jax_names(jnet).items()})


SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-3}


def test_trainer_sgd_momentum_steps_against_jax():
    batches = _batches()
    jnet, tnet = _tiny(jmx), _tiny(tmx)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(batches[0][0]))
    tnet.initialize()
    _copy_jax_weights(jnet, tnet, batches[0][0])
    for net in (jnet, tnet):
        net.collect_params()["tiny_dense1_weight"].lr_mult = 0.5
    jtr = jmx.gluon.Trainer(jnet.collect_params(), "sgd", dict(SGD))
    ttr = tmx.gluon.Trainer(tnet.collect_params(), "sgd", dict(SGD))
    jl, tl = _train(jmx, jnet, jtr, batches), _train(tmx, tnet, ttr, batches)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jp = jnet.collect_params()  # both roots are prefixed "tiny_"
    for k, p in tnet.collect_params().items():
        np.testing.assert_allclose(p.data().asnumpy(), jp[k].data().asnumpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    # the running statistics moved in training mode, and predict mode
    # leaves them as they are
    rm = tnet.collect_params()["tiny_batchnorm0_running_mean"].data().asnumpy()
    assert np.abs(rm).max() > 0
    tnet(tmx.nd.array(batches[0][0]))
    np.testing.assert_array_equal(
        tnet.collect_params()["tiny_batchnorm0_running_mean"].data().asnumpy(), rm)


def test_save_and_load_states_round_trip(tmp_path):
    batches = _batches()
    nets, trainers = [], []
    for _ in range(2):
        tmx.random.seed(11)
        net = _tiny(tmx)
        net.initialize(tmx.init.Xavier())
        net(tmx.nd.array(batches[0][0]))
        nets.append(net)
        trainers.append(tmx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD)))
    _train(tmx, nets[0], trainers[0], batches[:2])
    trainers[0].save_states(str(tmp_path / "t.states"))
    nets[0].save_parameters(str(tmp_path / "t.params"))
    nets[1].load_parameters(str(tmp_path / "t.params"))
    trainers[1].load_states(str(tmp_path / "t.states"))
    la = _train(tmx, nets[0], trainers[0], batches[2:])
    lb = _train(tmx, nets[1], trainers[1], batches[2:])
    assert la == lb
    for (k, a), b in zip(nets[0].collect_params().items(), nets[1].collect_params().values()):
        np.testing.assert_array_equal(a.data().asnumpy(), b.data().asnumpy(), err_msg=k)


def test_parameter_dict_save_load_and_parameter_api(tmp_path):
    net = _tiny(tmx)
    net.initialize()
    net(tmx.nd.array(_batches()[0][0]))
    params = net.collect_params()
    params.save(str(tmp_path / "p.params"), strip_prefix="tiny_")
    other = _tiny(tmx)
    other.initialize()
    other.collect_params().load(str(tmp_path / "p.params"), restore_prefix="tiny_")
    for k, p in other.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(), params[k].data().asnumpy())
    w = params["tiny_dense0_weight"]
    assert w.grad().asnumpy().sum() == 0 and w.list_ctx() == [tmx.cpu()]
    w.set_data(tmx.nd.ones(w.shape))
    assert w.data().asnumpy().min() == 1.0
    w.grad_req = "null"
    with pytest.raises(RuntimeError, match="grad_req='null'"):
        w.grad()
    c = tmx.gluon.ParameterDict("x_").get_constant("c", np.arange(3, dtype=np.float32))
    c.initialize(ctx=tmx.cpu())
    assert c.name == "x_c" and c.grad_req == "null"
    assert c.data().asnumpy().tolist() == [0.0, 1.0, 2.0]


def test_unported_paths_raise_with_their_roadmap_item():
    net = _tiny(tmx)
    with pytest.raises(NotImplementedError, match="A4.1"):
        net.hybridize()
    net.initialize()
    with pytest.raises(NotImplementedError, match="A10"):
        tmx.gluon.Trainer(net.collect_params(), "sgd", kvstore="dist_sync")
    tmx.gluon.Trainer(net.collect_params(), "sgd", kvstore=None)
    tmx.gluon.Trainer(net.collect_params(), "sgd", kvstore="local")


def test_initialize_and_nd_array_need_the_card_without_a_cpu_context():
    """No silent CPU path: without ``with mx.cpu():`` the default context
    is the card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with tmx.gpu(0):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmx.nd.array([1.0])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _tiny(tmx).initialize()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmx.gluon.nn.Dense(3, in_units=2)
