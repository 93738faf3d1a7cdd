"""A loss written in Python through SequentialModule (the port's copy of
``examples/module/python_loss.py``; reference example/module/python_loss.py):
a feature MLP Module chained with a ``PythonLossModule`` whose gradient is
a numpy multiclass hinge, wired by ``SequentialModule.add(...,
take_labels=True, auto_wiring=True)``::

    python -m mxnet_tpu_torch.examples.module.python_loss [--ctx cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

import mxnet_tpu_torch as mx


def mc_hinge_grad(scores, labels):
    """Crammer-Singer multiclass hinge subgradient: push down the most
    violating class, pull up the true class; scores and labels are tensors,
    the gradient an array."""
    scores = scores.detach().cpu().numpy()
    labels = labels.detach().cpu().numpy().astype(int)
    n, _ = scores.shape
    grad = np.zeros_like(scores)
    for i in range(n):
        viol = 1.0 + scores[i] - scores[i, labels[i]]
        viol[labels[i]] = 0.0
        j = int(viol.argmax())
        if viol[j] > 0:
            grad[i, labels[i]] -= 1.0
            grad[i, j] += 1.0
    return grad / n


def data(classes=5, dim=24):
    """1,200 points around ``classes`` Gaussian centres (``RandomState(3)``)."""
    rng = np.random.RandomState(3)
    centers = rng.randn(classes, dim) * 3
    y = rng.randint(0, classes, 1200)
    x = (centers[y] + rng.randn(1200, dim)).astype(np.float32)
    return x, y.astype(np.float32)


def build(classes=5):
    """The SequentialModule: the MLP Module, then the hinge loss."""
    data_ = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data_, name="fc1", num_hidden=64)
    net = mx.sym.Activation(net, name="relu1", act_type="relu")
    net = mx.sym.FullyConnected(net, name="fc2", num_hidden=classes)
    mlp = mx.mod.Module(net, label_names=(), context=mx.current_context())
    loss = mx.mod.PythonLossModule(grad_func=mc_hinge_grad)
    return mx.mod.SequentialModule().add(mlp).add(loss, take_labels=True, auto_wiring=True)


def train(epochs=10, batch=64, classes=5, dim=24):
    """Fit on the current context -> (module, iterator)."""
    x, y = data(classes, dim)
    mod = build(classes)
    it = mx.io.NDArrayIter(x, y, batch, shuffle=True)
    mod.fit(it, num_epoch=epochs, optimizer="sgd",
            optimizer_params={"learning_rate": 0.2, "momentum": 0.9})
    return mod, it


def accuracy(mod, it):
    """Accuracy of the argmax of the feature module's scores over ``it``."""
    it.reset()
    correct = total = 0
    for b in it:
        mod.forward(b, is_train=False)
        pred = mod.get_outputs()[0].argmax(dim=1).cpu().numpy()
        lab = b.label[0].cpu().numpy().astype(int)
        correct += int((pred == lab).sum())
        total += lab.shape[0]
    return correct / total


def main(epochs=10, batch=64, classes=5, dim=24):
    mod, it = train(epochs, batch, classes, dim)
    acc = accuracy(mod, it)
    print("python hinge-loss module train acc %.3f" % acc)
    return acc


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="a Python hinge loss through SequentialModule")
    p.add_argument("--ctx", choices=("gpu", "cpu"), default="gpu")
    ctx = mx.gpu(0) if p.parse_args().ctx == "gpu" else mx.cpu()
    ctx.device  # raises here without a card, unless --ctx cpu
    with ctx, mx.full_fp32():
        main()
