"""``mx.rnn``: the symbolic RNN cells, bucketed sentence IO and RNN
checkpoints (parity: mxnet_tpu/rnn/; the reference's
python/mxnet/rnn/{rnn_cell,rnn,io}.py)."""
from .rnn_cell import (RNNParams, BaseRNNCell, RNNCell, LSTMCell, GRUCell,
                       SequentialRNNCell, DropoutCell, ResidualCell,
                       BidirectionalCell)
from .rnn import (save_rnn_checkpoint, load_rnn_checkpoint,
                  do_rnn_checkpoint)
from .io import encode_sentences, BucketSentenceIter

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "ResidualCell",
           "BidirectionalCell", "save_rnn_checkpoint",
           "load_rnn_checkpoint", "do_rnn_checkpoint",
           "encode_sentences", "BucketSentenceIter"]
