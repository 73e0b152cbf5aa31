"""The fused recurrent layers RNN, LSTM and GRU (parity:
mxnet_tpu/gluon/rnn/rnn_layer.py; the reference's
python/mxnet/gluon/rnn/rnn_layer.py:32,144), over the fused ``RNN`` op
(``ops/nn.py``: cuDNN's RNN a layer on the card), with ``_unfuse()`` to
the equivalent stack of cells.  The parameters keep the reference's
names (``l0_i2h_weight``, ``r0_h2h_bias``, ...); ``_flat_params``
concatenates them, each call, into the op's flat vector (all weights,
then all biases).  Inside a compiled forward the parameters read as the
compiled function's tensors (``block._param_data``)."""
from __future__ import annotations

from ... import ndarray
from ...ndarray.ndarray import NDArray
from ..block import HybridBlock, _is_tracing, _param_data
from . import rnn_cell

__all__ = ["RNN", "LSTM", "GRU"]


def _init_by_name(init):
    from ... import initializer

    if isinstance(init, str):
        return initializer.create(init)
    return init


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, projection_size=None, **kwargs):
        self._mode = mode  # _alias() needs it during Block.__init__
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            "Invalid layout %s; must be one of ['TNC' or 'NTC']" % layout
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._h2h_weight_initializer = h2h_weight_initializer
        self._i2h_bias_initializer = i2h_bias_initializer
        self._h2h_bias_initializer = h2h_bias_initializer
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in ["l", "r"][:self._dir]:
                self._register_param("%s%d_i2h_weight" % (j, i),
                                     shape=(ng * nh, ni),
                                     init=i2h_weight_initializer)
                self._register_param("%s%d_h2h_weight" % (j, i),
                                     shape=(ng * nh, nh),
                                     init=h2h_weight_initializer)
                self._register_param("%s%d_i2h_bias" % (j, i),
                                     shape=(ng * nh,),
                                     init=_init_by_name(i2h_bias_initializer))
                self._register_param("%s%d_h2h_bias" % (j, i),
                                     shape=(ng * nh,),
                                     init=_init_by_name(h2h_bias_initializer))
            ni = nh * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        setattr(self, name, p)
        return p

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        shape = self.l0_i2h_weight.shape
        mapping = "{0} -> {1}".format(shape[1] if shape[1] else None,
                                      shape[0] // self._gates)
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def _alias(self):
        return self._mode

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def _infer_param_shapes(self, inputs, *args):
        ni = inputs.shape[2] if self._layout == "TNC" else inputs.shape[-1]
        ng, nh = self._gates, self._hidden_size
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                getattr(self, "%s%d_i2h_weight" % (j, i)).shape = (ng * nh, ni)
            ni = nh * self._dir

    def begin_state(self, batch_size=0, func=ndarray.zeros, **kwargs):
        states = []
        for i, info in enumerate(self.state_info(batch_size)):
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            states.append(func(**{k: v for k, v in info.items()
                                  if k != "__layout__"}))
        return states

    def _unfuse(self):
        """Fallback to stacked cells (parity :144)."""
        get_cell = {
            "rnn_relu": lambda **kw: rnn_cell.RNNCell(
                self._hidden_size, activation="relu", **kw),
            "rnn_tanh": lambda **kw: rnn_cell.RNNCell(
                self._hidden_size, activation="tanh", **kw),
            "lstm": lambda **kw: rnn_cell.LSTMCell(self._hidden_size, **kw),
            "gru": lambda **kw: rnn_cell.GRUCell(self._hidden_size, **kw),
        }[self._mode]
        stack = rnn_cell.SequentialRNNCell(prefix=self.prefix,
                                           params=self.params)
        with stack.name_scope():
            ni = self._input_size
            for i in range(self._num_layers):
                kwargs = {
                    "input_size": ni,
                    "i2h_weight_initializer": self._i2h_weight_initializer,
                    "h2h_weight_initializer": self._h2h_weight_initializer,
                    "i2h_bias_initializer": self._i2h_bias_initializer,
                    "h2h_bias_initializer": self._h2h_bias_initializer}
                if self._dir == 2:
                    stack.add(rnn_cell.BidirectionalCell(
                        get_cell(prefix="l%d_" % i, **kwargs),
                        get_cell(prefix="r%d_" % i, **kwargs)))
                else:
                    stack.add(get_cell(prefix="l%d_" % i, **kwargs))
                if self._dropout > 0 and i != self._num_layers - 1:
                    stack.add(rnn_cell.DropoutCell(self._dropout))
                ni = self._hidden_size * self._dir
        return stack

    def _flat_params(self):
        """Concatenate params into the fused cuDNN-layout vector
        (ops/nn.py RNN expects the same order as rnn-inl.h)."""
        def data(name):
            return _param_data(getattr(self, name))

        ws = []
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                ws.append(data("%s%d_i2h_weight" % (j, i)).reshape(-1))
                ws.append(data("%s%d_h2h_weight" % (j, i)).reshape(-1))
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                ws.append(data("%s%d_i2h_bias" % (j, i)))
                ws.append(data("%s%d_h2h_bias" % (j, i)))
        return ndarray.concat(*ws, dim=0)

    def forward(self, inputs, states=None):
        if isinstance(inputs, NDArray) and not _is_tracing():
            self._ensure_initialized(inputs)
        batch_size = inputs.shape[self._layout.find("N")]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size, ctx=inputs.context)
        if isinstance(states, NDArray):
            states = [states]
        for state, info in zip(states, self.state_info(batch_size)):
            if state.shape != info["shape"]:
                raise ValueError(
                    "Invalid recurrent state shape. Expecting %s, got %s." % (
                        str(info["shape"]), str(state.shape)))
        out = self._forward_kernel(inputs, states)
        return out[0] if skip_states else out

    def _forward_kernel(self, inputs, states):
        if self._layout == "NTC":
            inputs = inputs.swapaxes(0, 1)
        params = self._flat_params()
        args = [inputs, params] + list(states)
        rnn_args = ndarray.RNN(
            *args, state_size=self._hidden_size,
            num_layers=self._num_layers, bidirectional=self._dir == 2,
            p=self._dropout, state_outputs=True, mode=self._mode)
        if self._mode == "lstm":
            outputs, states = rnn_args[0], [rnn_args[1], rnn_args[2]]
        else:
            outputs, states = rnn_args[0], [rnn_args[1]]
        if self._layout == "NTC":
            outputs = outputs.swapaxes(0, 1)
        return outputs, states


class RNN(_RNNLayer):
    """Elman RNN (relu/tanh), fused (parity: rnn_layer.py RNN)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 projection_size=None, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm",
                         projection_size=projection_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"},
                {"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class GRU(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
