"""The port's imperative autograd (mxnet_tpu_torch.autograd over
torch.autograd) against mxnet_tpu.autograd on the same composite, on the
CPU: the recording and training flags, ``backward`` of scalar and vector
heads, ``grad_req`` "write" against "add", ``grad`` (and a second
derivative), ``mark_variables`` and ``Function``.  Gradients within rtol
1e-6, atol 1e-6 (the same fp32 arithmetic in another order)."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

X = np.random.RandomState(0).uniform(-1.5, 1.5, (3, 4)).astype(np.float32)
W = np.random.RandomState(1).uniform(-1.0, 1.0, (4, 2)).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-6, atol=1e-6)


def _composite(mx, x, w):
    """tanh(x·w) weighted by the rows' squared norms, with a comparison
    mask and a reduction: a scalar and a (3,) head."""
    h = mx.nd.tanh(mx.nd.dot(x, w))
    r = (x * x).sum(axis=1, keepdims=True)
    y = h * r * (h > 0) + 0.5 * mx.nd.sigmoid(h)
    return y.sum(), y.sum(axis=1)


def _vars(mx, grad_req="write"):
    ctx = tmx.cpu() if mx is tmx else None
    x, w = mx.nd.array(X, ctx=ctx), mx.nd.array(W, ctx=ctx)
    x.attach_grad(grad_req)
    w.attach_grad(grad_req)
    return x, w


@pytest.fixture(scope="module", autouse=True)
def _cpu_context():
    with tmx.cpu():
        yield


def test_recording_and_training_flags():
    for mx in (jmx, tmx):
        ag = mx.autograd
        assert not ag.is_recording() and not ag.is_training()
        with ag.record():
            assert ag.is_recording() and ag.is_training()
            with ag.pause():
                assert not ag.is_recording() and not ag.is_training()
            with ag.predict_mode():
                assert ag.is_recording() and not ag.is_training()
        with ag.record(train_mode=False):
            assert ag.is_recording() and not ag.is_training()
        with ag.train_mode():
            assert not ag.is_recording() and ag.is_training()
        assert not ag.is_recording() and not ag.is_training()
        assert ag.set_training(True) is False and ag.set_training(False) is True


def test_no_graph_outside_record():
    x, w = _vars(tmx)
    y, _ = _composite(tmx, x, w)
    assert not y._data.requires_grad
    with tmx.autograd.record():
        y, _ = _composite(tmx, x, w)
        with tmx.autograd.pause():
            z = x * 2
    assert y._data.requires_grad and not z._data.requires_grad


@pytest.mark.parametrize("head", ["scalar", "vector", "vector_out_grad"])
def test_backward_against_jax(head):
    got = []
    for mx in (jmx, tmx):
        x, w = _vars(mx)
        with mx.autograd.record():
            s, v = _composite(mx, x, w)
        if head == "scalar":
            s.backward()
        elif head == "vector":
            v.backward()  # a vector head: the gradient of its sum
        else:
            ctx = tmx.cpu() if mx is tmx else None
            v.backward(mx.nd.array(np.array([1.0, -2.0, 0.5], np.float32), ctx=ctx))
        got.append((x.grad, w.grad))
    (jx, jw), (tx, tw) = got
    _close(tx, jx)
    _close(tw, jw)


def test_grad_req_write_against_add():
    got = {}
    for mx in (jmx, tmx):
        for req in ("write", "add"):
            x, w = _vars(mx, req)
            for _ in range(2):
                with mx.autograd.record():
                    s, _ = _composite(mx, x, w)
                s.backward()
            got[mx, req] = (x.grad, w.grad)
    for req in ("write", "add"):
        _close(got[tmx, req][0], got[jmx, req][0])
        _close(got[tmx, req][1], got[jmx, req][1])
    np.testing.assert_allclose(got[tmx, "add"][1].asnumpy(), 2 * got[tmx, "write"][1].asnumpy(),
                               rtol=1e-6)


def test_grad_and_second_derivative():
    out = []
    for mx in (jmx, tmx):
        x, w = _vars(mx)
        with mx.autograd.record():
            s, _ = _composite(mx, x, w)
        gx, gw = mx.autograd.grad(s, [x, w])
        x2, _ = _vars(mx)
        with mx.autograd.record():
            y = (x2 * x2 * x2).sum()
            (g,) = mx.autograd.grad(y, [x2], create_graph=True)
            z = (g * g).sum()
        z.backward()  # d/dx Σ (3x²)² = 36 x³
        out.append((gx, gw, g, x2.grad))
    for t, j in zip(out[1], out[0]):
        _close(t, j)
    np.testing.assert_allclose(out[1][3].asnumpy(), 36 * X ** 3, rtol=1e-5)


def test_mark_variables_writes_the_given_buffers():
    out = []
    for mx in (jmx, tmx):
        ctx = tmx.cpu() if mx is tmx else None
        x, w = mx.nd.array(X, ctx=ctx), mx.nd.array(W, ctx=ctx)
        gx, gw = mx.nd.zeros(X.shape, ctx=ctx), mx.nd.ones(W.shape, ctx=ctx)
        mx.autograd.mark_variables([x, w], [gx, gw], grad_reqs=["write", "add"])
        with mx.autograd.record():
            s, _ = _composite(mx, x, w)
        s.backward()
        assert x.grad is gx and w.grad is gw
        out.append((gx, gw))
    _close(out[1][0], out[0][0])
    _close(out[1][1], out[0][1])  # "add": 1 + the gradient


def test_inplace_write_to_a_variable():
    """Writing into an array that takes a gradient: the JAX package rebinds,
    the port writes the leaf in place; the next graph sees the new values
    either way."""
    out = []
    for mx in (jmx, tmx):
        x, w = _vars(mx)
        x[0] = 0.25
        x += 1.0
        with mx.autograd.record():
            s, _ = _composite(mx, x, w)
        s.backward()
        out.append((x, x.grad, w.grad))
    for t, j in zip(out[1], out[0]):
        _close(t, j)


def _sigmoid_function(mx):
    class Sigmoid(mx.autograd.Function):
        def forward(self, x):
            y = 1 / (1 + mx.nd.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y)

    return Sigmoid()


def test_function_against_jax():
    out = []
    for mx in (jmx, tmx):
        x, w = _vars(mx)
        f = _sigmoid_function(mx)
        with mx.autograd.record():
            y = f(mx.nd.dot(x, w)) * 3.0
            s = y.sum()
        s.backward()
        out.append((y, x.grad, w.grad))
    for t, j in zip(out[1], out[0]):
        _close(t, j)
