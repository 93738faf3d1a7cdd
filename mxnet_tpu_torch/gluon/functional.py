"""A Gluon block's SGD train step with explicit state (counterpart of
``mxnet_tpu/gluon/functional.py``).

The JAX package turns a block into a pure function of its parameter values
(``functionalize``) and jits one train step over it.  The port keeps the
step's contract — sorted Gluon names, learnables split from auxiliary
state, ``step(state, x, y) -> (state, loss)`` — and runs the step eagerly:
the block is called on the state's tensors through
``torch.func.functional_call``, autograd gives the gradients, and
multi-tensor SGD updates the state in place.
"""
from __future__ import annotations

import torch

from ..context import full_fp32

__all__ = ["make_train_step"]


def make_train_step(net, loss_fn, learning_rate=0.01, momentum=0.0,
                    compute_dtype=None, mesh=None, shard_optimizer_states=False):
    """-> ``(step, state, (names, learn_idx, aux_idx))``: momentum SGD on
    ``net`` under ``loss_fn`` (a loss block, e.g.
    ``SoftmaxCrossEntropyLoss()``).

    ``names`` are ``net``'s sorted Gluon names; ``learn_idx`` indexes the
    parameters that take a gradient and ``aux_idx`` the rest (running
    statistics, γ/β without a gradient).  ``state = (learn, momentum,
    aux)``, lists of tensors in that order: ``learn`` and ``aux`` are the
    block's own tensors (detached, sharing its storage), so the block sees
    every update; ``momentum`` is zeros, or empty when ``momentum`` is 0.

    ``step(state, x, y, key=None) -> (state, loss)`` runs ``net`` on
    ``state``'s values in training mode (BatchNorm on batch statistics,
    folding them into ``aux`` in place), ``loss = mean(loss_fn(out, y))``,
    the backward, and ``m = momentum·m + g; p = p − lr·m`` (with momentum
    0: ``p = p − lr·g``) in place; it returns the same state and the loss.
    The forward and backward run in full fp32 (``full_fp32``).  ``key`` is
    taken for the JAX signature: no ported layer draws random numbers.
    The net's mode is restored after the step.

    ``compute_dtype="bfloat16"``: the fp32 masters are cast to bf16 for
    each step (the gradient flows back through the cast), the running
    statistics stay fp32 and are updated in fp32, float inputs are cast to
    bf16 (integer ones stay), and the outputs are upcast to fp32 before the
    loss; gradients and momentum are fp32.

    ``mesh`` and ``shard_optimizer_states`` (data parallelism and ZeRO)
    are ROADMAP A10 and raise.
    """
    if mesh is not None or shard_optimizer_states:
        raise NotImplementedError(
            "make_train_step: mesh / shard_optimizer_states (data parallelism "
            "and ZeRO sharding) are not ported; they are ROADMAP.md item A10")
    if isinstance(compute_dtype, str):
        compute_dtype = getattr(torch, compute_dtype)
    named = sorted(net.gluon_named_tensors().items())
    names = [n for n, _ in named]
    learn_idx = [i for i, (_, t) in enumerate(named)
                 if isinstance(t, torch.nn.Parameter) and t.requires_grad]
    aux_idx = sorted(set(range(len(named))) - set(learn_idx))
    # functional_call takes module attribute paths, not Gluon names
    by_id = {id(t): k for k, t in list(net.named_parameters()) + list(net.named_buffers())}
    learn_paths = [by_id[id(named[i][1])] for i in learn_idx]
    aux_paths = [by_id[id(named[i][1])] for i in aux_idx]

    def cast_input(a):
        if compute_dtype is not None and a.is_floating_point():
            return a.to(compute_dtype)
        return a

    def forward(leaves, aux, x):  # -> net's output, fp32
        cast = [v.to(compute_dtype) for v in leaves] if compute_dtype else leaves
        tensors = dict(zip(learn_paths, cast))
        tensors.update(zip(aux_paths, aux))
        xs = x if isinstance(x, (list, tuple)) else (x,)
        out = torch.func.functional_call(net, tensors, tuple(cast_input(a) for a in xs))
        if compute_dtype is not None:
            out = out.to(torch.float32)
        return out

    def step(state, x, y, key=None):
        learn, mom, aux = state
        leaves = [p.detach().requires_grad_() for p in learn]
        was_training = net.training
        net.train()
        try:
            with full_fp32():
                loss = torch.mean(loss_fn(forward(leaves, aux, x), y))
                # a parameter the loss does not reach gets a zero gradient
                grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        finally:
            net.train(was_training)
        with torch.no_grad():
            # multi-tensor updates: a few launches per step, not a few per tensor
            if momentum:
                torch._foreach_mul_(mom, momentum)
                torch._foreach_add_(mom, grads)
                upd = mom
            else:
                upd = grads
            torch._foreach_sub_(learn, torch._foreach_mul(upd, learning_rate))
        return state, loss.detach()

    # detached: the state shares the block's storage
    learn = [named[i][1].detach() for i in learn_idx]
    aux = [named[i][1].detach() for i in aux_idx]
    mom = [torch.zeros_like(v) for v in learn] if momentum else []
    return step, (learn, mom, aux), (names, learn_idx, aux_idx)
