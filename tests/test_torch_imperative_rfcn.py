"""The port's copy of examples/deformable_rfcn (``mxnet_tpu_torch.examples.
deformable_rfcn``: the model, its losses and ``train.py``'s step through
``mx.nd``, ``autograd.record`` and ``gluon.Trainer``) against the JAX
example, on the CPU at 3×64×64, batch 2: the JAX net's weights carried
across with ``load_jax_params``, the same batches and one anchor-sampling
``RandomState`` a package, two train steps.  The four losses of each step
within rtol 1e-5 and the parameters after both within rtol 1e-4, atol
1e-6 (fp32 sums in another order, through two BatchNorm steps).

Parity trap: MultiProposal sorts its scores, and a ~1e-6 tie between the
packages would reorder the rois and every target after it; ``SEED`` was
checked tie-free (the rois of both steps equal)."""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.examples.deformable_rfcn import train as texample
from mxnet_tpu_torch.gluon.model_zoo import load_jax_params
from xdist_shared import shared

EXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples",
                     "deformable_rfcn")
SEED = 0
LR = 0.02


def _jax_example():
    from conftest import load_example_module

    return load_example_module("dfrfcn_model_for_port", os.path.join(EXDIR, "deformable_rfcn.py"))


def _batches(mx, ctx=None):
    """The example's synthetic batches (numpy, seeded), as ``mx``'s arrays."""
    out = []
    for d, i, l in texample.synthetic_batches(2, (3, 64, 64), 2, 2, seed=SEED, ctx=tmx.cpu()):
        out.append(tuple(mx.nd.array(a.asnumpy(), ctx=ctx) if ctx else mx.nd.array(a.asnumpy())
                         for a in (d, i, l)))
    return out


def _jax_steps(ex, batches):
    """The JAX example's two train steps (its ``train_step``) from its own
    initial weights -> (the weights before the first update, [(loss,
    parts)], the weights after).  The deferred shapes complete inside the
    first step, so the weights are read between its backward and its
    update; the running statistics, which that forward has already
    folded, are taken at their initial 0 and 1."""
    jmx.random.seed(SEED)
    net = ex.DeformableRFCN(num_classes=2)
    net.initialize()
    trainer = jmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": LR, "momentum": 0.9})
    anchor_rng = np.random.RandomState(SEED)
    params = lambda: {k[len(net.prefix):]: p.data().asnumpy()  # noqa: E731
                      for k, p in net.collect_params().items()}
    out, start = [], None
    for data, im_info, labels in batches:
        with jmx.autograd.record():
            rois, cls_score, bbox_pred, rpn_cls, rpn_bbox = net(data, im_info)
            cl, bl = ex.rfcn_losses(rois, cls_score, bbox_pred, labels, 2)
            rcl, rbl = ex.rpn_losses(net, rpn_cls, rpn_bbox, labels, im_info,
                                     anchor_rng=anchor_rng)
            loss = cl + bl + rcl + rbl
        loss.backward()
        if start is None:
            start = {k: np.zeros_like(v) if k.endswith("running_mean") else
                     np.ones_like(v) if k.endswith("running_var") else v
                     for k, v in params().items()}
        trainer.step(2)
        out.append((float(loss.asnumpy()), [float(p.asnumpy()) for p in (cl, bl, rcl, rbl)]))
    return start, out, params()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' two steps; the JAX side computed once per test run
    (``xdist_shared``)."""
    jparams, jout, jafter = shared(tmp_path_factory, "torch_imperative_rfcn_jax",
                                   lambda: _jax_steps(_jax_example(), _batches(jmx)))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with tmx.cpu():
            tnet, ttrainer = texample.build(2, LR, tmx.cpu())
            load_jax_params(tnet, jparams)  # makes the deferred-shape tensors
            tstep = texample.make_train_step(tnet, ttrainer, 2, 2,
                                             anchor_rng=np.random.RandomState(SEED))
            tout = [tstep(*b) for b in _batches(tmx, tmx.cpu())]
            tparams = {k: p.data().asnumpy() for k, p in tnet.collect_params().items()}
        return dict(jout=jout, tout=tout, jparams=jparams, jafter=jafter, tparams=tparams,
                    tnet=tnet)
    finally:
        torch.set_num_threads(n)


def test_weights_carry_across_with_the_jax_names(runs):
    """``load_jax_params`` fills every parameter of the port's net (its
    deferred shapes completed from the JAX values): the names and shapes
    are the JAX example's."""
    names = sorted(runs["tnet"].collect_params().keys())
    assert names == sorted(runs["jparams"]) == sorted(runs["tparams"])
    assert runs["tnet"].collect_params()["backbone_down0_weight"].shape == (16, 3, 3, 3)


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_losses_against_jax(runs, step):
    (jl, jparts), (tl, tparts) = runs["jout"][step], runs["tout"][step]
    np.testing.assert_allclose(tparts, jparts, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def test_parameters_after_two_steps_against_jax(runs):
    moved = 0
    for k, v in runs["jafter"].items():
        np.testing.assert_allclose(runs["tparams"][k], v, rtol=1e-4, atol=1e-6, err_msg=k)
        moved += not np.array_equal(v, runs["jparams"][k])
    assert moved > 20  # the steps trained every branch
