"""Checkpoints (counterpart of ``mxnet_tpu/model.py``: ``save_checkpoint``,
``load_checkpoint``, ``BatchEndParam``; reference python/mxnet/model.py
:384, :414).  A checkpoint is ``prefix-symbol.json`` (``Symbol.tojson``) and
``prefix-%04d.params`` (``ndarray.save`` of ``arg:<name>`` / ``aux:<name>``
entries), the JAX package's files: either package resumes the other's."""
from __future__ import annotations

import collections
import logging
import os

from . import ndarray as nd
from . import symbol as sym_mod

__all__ = ["save_checkpoint", "load_checkpoint", "BatchEndParam"]

BatchEndParam = collections.namedtuple("BatchEndParams",
                                       ["epoch", "nbatch", "eval_metric", "locals"])


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``prefix-symbol.json`` (when ``symbol`` is given) and
    ``prefix-%04d.params``."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {"arg:%s" % k: v for k, v in arg_params.items()}
    save_dict.update({"aux:%s" % k: v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict)
    logging.info('Saved checkpoint to "%s"', param_name)


def load_checkpoint(prefix, epoch):
    """-> (symbol or None, arg_params, aux_params), the parameters as CPU
    tensors by name."""
    symbol = None
    if os.path.exists("%s-symbol.json" % prefix):
        symbol = sym_mod.load("%s-symbol.json" % prefix)
    arg_params, aux_params = {}, {}
    for k, v in nd.load("%s-%04d.params" % (prefix, epoch)).items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params
