"""RNN checkpoint helpers (parity: mxnet_tpu/rnn/rnn.py; the
reference's python/mxnet/rnn/rnn.py).

The reference's fused-cell checkpoints repack weights; these cells keep
plain named variables, so the checkpoints are ordinary model
checkpoints (``model.save_checkpoint``), in the format both packages
read.
"""
from __future__ import annotations

from .. import model as _model

__all__ = ["save_rnn_checkpoint", "load_rnn_checkpoint",
           "do_rnn_checkpoint"]


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params,
                        aux_params):
    _model.save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    return _model.load_checkpoint(prefix, epoch)


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback saving symbol+params every `period` epochs."""
    period = max(1, int(period))

    def callback(epoch, symbol, arg_params, aux_params):
        if (epoch + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params,
                                aux_params)

    return callback
