"""RNN checkpoint helpers (counterpart of ``mxnet_tpu/rnn/rnn.py``;
reference python/mxnet/rnn/rnn.py)."""
from __future__ import annotations

from .. import model

__all__ = ["rnn_unroll", "save_rnn_checkpoint", "load_rnn_checkpoint", "do_rnn_checkpoint"]


def rnn_unroll(cell, length, inputs=None, begin_state=None, input_prefix="", layout="NTC"):
    """Deprecated alias for cell.unroll (reference rnn.py:26); with
    inputs=None, per-step input Variables are auto-created as in the
    reference."""
    if inputs is None:
        from .. import symbol

        inputs = [symbol.Variable("%st%d_data" % (input_prefix, i)) for i in range(length)]
    return cell.unroll(length, inputs=inputs, begin_state=begin_state, layout=layout)


def _normalize_cells(cells):
    if not isinstance(cells, (list, tuple)):
        cells = [cells]
    return cells


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """Saves checkpoint with fused weights unpacked (reference rnn.py:32)."""
    for cell in _normalize_cells(cells):
        arg_params = cell.unpack_weights(arg_params)
    model.save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """Loads checkpoint, re-packing weights for the cells (reference rnn.py:62)."""
    sym, arg, aux = model.load_checkpoint(prefix, epoch)
    for cell in _normalize_cells(cells):
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end checkpoint callback (reference rnn.py:97)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)

    return _callback
