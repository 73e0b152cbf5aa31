"""Gluon contrib recurrent cells (parity: mxnet_tpu/gluon/contrib/rnn.py;
the reference's python/mxnet/gluon/contrib/rnn/conv_rnn_cell.py — the
nine Conv{1,2,3}D{RNN,LSTM,GRU}Cell classes — and rnn_cell.py —
VariationalDropoutCell, LSTMPCell, dynamic_unroll).

The convolutional cells share one base that computes the stacked-gate
input and recurrent convolutions; each family's gate math is one
``_step`` hook, and the 1D/2D/3D classes are generated from (family x
dims).  ``dynamic_unroll`` steps a cell over a merged sequence in
Python, which a compiled consumer unrolls."""
from __future__ import annotations

from ..rnn.rnn_cell import (HybridRecurrentCell, ModifierCell,
                            BidirectionalCell, _SeqView,
                            _states_at_valid_length)
from ... import ndarray

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell",
           "VariationalDropoutCell", "LSTMPCell", "dynamic_unroll"]


def _tuple_of(spec, dims, what):
    if isinstance(spec, (int, float)):
        return (int(spec),) * dims
    spec = tuple(int(s) for s in spec)
    assert len(spec) == dims, \
        "%s must be an int or a length-%d tuple, got %s" % (what, dims, spec)
    return spec


class _ConvCellBase(HybridRecurrentCell):
    """Shared machinery for convolutional recurrent cells.

    Subclasses define ``_gates`` (stack multiplier) and ``_step(F, i2h,
    h2h, states)`` returning (output, new_states).  The recurrent
    convolution pads to "same" (odd kernels only) so the state keeps its
    spatial shape across steps."""

    _gates = 1

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad, i2h_dilate, h2h_dilate, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, dims, conv_layout, activation,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if conv_layout.find("C") != 1:
            raise NotImplementedError(
                "the conv cells use channel-first layouts (NCW/NCHW/"
                "NCDHW); got %r" % conv_layout)
        self._dims = dims
        self._conv_layout = conv_layout
        self._activation = activation
        self._hidden_channels = hidden_channels
        self._input_shape = tuple(input_shape)   # (C, *spatial)
        self._i2h_kernel = _tuple_of(i2h_kernel, dims, "i2h_kernel")
        self._i2h_pad = _tuple_of(i2h_pad, dims, "i2h_pad")
        self._i2h_dilate = _tuple_of(i2h_dilate, dims, "i2h_dilate")
        self._h2h_kernel = _tuple_of(h2h_kernel, dims, "h2h_kernel")
        assert all(k % 2 == 1 for k in self._h2h_kernel), \
            "h2h_kernel must be odd so the state keeps its spatial " \
            "shape, got %s" % (self._h2h_kernel,)
        self._h2h_dilate = _tuple_of(h2h_dilate, dims, "h2h_dilate")
        self._h2h_pad = tuple(d * (k - 1) // 2 for d, k in
                              zip(self._h2h_dilate, self._h2h_kernel))

        in_channels = self._input_shape[0]
        spatial = self._input_shape[1:]
        out_spatial = tuple(
            (s + 2 * p - d * (k - 1) - 1) + 1
            for s, p, d, k in zip(spatial, self._i2h_pad, self._i2h_dilate,
                                  self._i2h_kernel))
        self._state_shape = (hidden_channels,) + out_spatial

        stacked = hidden_channels * self._gates
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(stacked, in_channels) + self._i2h_kernel,
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(stacked, hidden_channels) + self._h2h_kernel,
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(stacked,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(stacked,), init=h2h_bias_initializer,
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size,) + self._state_shape,
                 "__layout__": self._conv_layout}
                for _ in range(self._num_states)]

    _num_states = 1

    def _act(self, F, x):
        if callable(self._activation) and not isinstance(self._activation,
                                                         str):
            return self._activation(x)
        return F.Activation(x, act_type=self._activation)

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        stacked = self._hidden_channels * self._gates
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, stride=(1,) * self._dims,
                            pad=self._i2h_pad, dilate=self._i2h_dilate,
                            num_filter=stacked)
        h2h = F.Convolution(states[0], h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, stride=(1,) * self._dims,
                            pad=self._h2h_pad, dilate=self._h2h_dilate,
                            num_filter=stacked)
        return self._step(F, i2h, h2h, states)

    def __repr__(self):
        return "%s(%s -> %s, %s)" % (
            self.__class__.__name__, self._input_shape[0],
            self._hidden_channels * self._gates, self._conv_layout)


class _ConvRNNStep(_ConvCellBase):
    _gates = 1
    _num_states = 1

    def _alias(self):
        return "conv_rnn"

    def _step(self, F, i2h, h2h, states):
        out = self._act(F, i2h + h2h)
        return out, [out]


class _ConvLSTMStep(_ConvCellBase):
    _gates = 4
    _num_states = 2

    def _alias(self):
        return "conv_lstm"

    def _step(self, F, i2h, h2h, states):
        gi, gf, gc, go = F.SliceChannel(i2h + h2h, num_outputs=4, axis=1)
        i = F.sigmoid(gi)
        f = F.sigmoid(gf)
        c_tilde = self._act(F, gc)
        o = F.sigmoid(go)
        next_c = f * states[1] + i * c_tilde
        next_h = o * self._act(F, next_c)
        return next_h, [next_h, next_c]


class _ConvGRUStep(_ConvCellBase):
    _gates = 3
    _num_states = 1

    def _alias(self):
        return "conv_gru"

    def _step(self, F, i2h, h2h, states):
        ir, iz, ic = F.SliceChannel(i2h, num_outputs=3, axis=1)
        hr, hz, hc = F.SliceChannel(h2h, num_outputs=3, axis=1)
        reset = F.sigmoid(ir + hr)
        update = F.sigmoid(iz + hz)
        cand = self._act(F, ic + reset * hc)
        next_h = (1.0 - update) * cand + update * states[0]
        return next_h, [next_h]


def _make_conv_cell(family_base, dims, layout, family_name):
    """Generate a public Conv{dims}D{family}Cell class with the
    reference's constructor signature."""

    class _Cell(family_base):
        def __init__(self, input_shape, hidden_channels, i2h_kernel,
                     h2h_kernel, i2h_pad=(0,) * dims,
                     i2h_dilate=(1,) * dims, h2h_dilate=(1,) * dims,
                     i2h_weight_initializer=None,
                     h2h_weight_initializer=None,
                     i2h_bias_initializer="zeros",
                     h2h_bias_initializer="zeros", conv_layout=layout,
                     activation="tanh", prefix=None, params=None):
            super().__init__(
                input_shape=input_shape, hidden_channels=hidden_channels,
                i2h_kernel=i2h_kernel, h2h_kernel=h2h_kernel,
                i2h_pad=i2h_pad, i2h_dilate=i2h_dilate,
                h2h_dilate=h2h_dilate,
                i2h_weight_initializer=i2h_weight_initializer,
                h2h_weight_initializer=h2h_weight_initializer,
                i2h_bias_initializer=i2h_bias_initializer,
                h2h_bias_initializer=h2h_bias_initializer, dims=dims,
                conv_layout=conv_layout, activation=activation,
                prefix=prefix, params=params)

    _Cell.__name__ = "Conv%dD%sCell" % (dims, family_name)
    _Cell.__qualname__ = _Cell.__name__
    _Cell.__doc__ = (
        "%dD convolutional %s cell: gates are computed with "
        "convolutions over the spatial dims (reference: "
        "gluon/contrib/rnn/conv_rnn_cell.py).  `input_shape` is the "
        "per-step sample shape (C, %s) for layout %s." % (
            dims, family_name,
            ", ".join("SWHD"[1:dims + 1][::-1]), layout))
    return _Cell


Conv1DRNNCell = _make_conv_cell(_ConvRNNStep, 1, "NCW", "RNN")
Conv2DRNNCell = _make_conv_cell(_ConvRNNStep, 2, "NCHW", "RNN")
Conv3DRNNCell = _make_conv_cell(_ConvRNNStep, 3, "NCDHW", "RNN")
Conv1DLSTMCell = _make_conv_cell(_ConvLSTMStep, 1, "NCW", "LSTM")
Conv2DLSTMCell = _make_conv_cell(_ConvLSTMStep, 2, "NCHW", "LSTM")
Conv3DLSTMCell = _make_conv_cell(_ConvLSTMStep, 3, "NCDHW", "LSTM")
Conv1DGRUCell = _make_conv_cell(_ConvGRUStep, 1, "NCW", "GRU")
Conv2DGRUCell = _make_conv_cell(_ConvGRUStep, 2, "NCHW", "GRU")
Conv3DGRUCell = _make_conv_cell(_ConvGRUStep, 3, "NCDHW", "GRU")


class VariationalDropoutCell(ModifierCell):
    """Variational (time-locked) dropout around a base cell
    (reference: gluon/contrib/rnn/rnn_cell.py:27, arXiv:1512.05287).

    One dropout mask per sequence for each of inputs / first state /
    outputs, sampled on the first step after ``reset()``."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        assert not drop_states or not isinstance(base_cell,
                                                 BidirectionalCell), \
            "Apply VariationalDropoutCell inside the directions of a " \
            "BidirectionalCell instead"
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self._masks = {}

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self._masks = {}

    def _mask(self, F, key, rate, like):
        from ... import autograd

        # dropout is a train-time regularizer: outside training the cell
        # must be the identity wrapper (reference F.Dropout semantics)
        if not rate or not autograd.is_training():
            return None
        if key not in self._masks:
            self._masks[key] = F.Dropout(F.ones_like(like), p=rate,
                                         mode="always")
        return self._masks.get(key)

    def hybrid_forward(self, F, inputs, states):
        m = self._mask(F, "states", self.drop_states, states[0])
        if m is not None:
            states = [states[0] * m] + list(states[1:])
        m = self._mask(F, "inputs", self.drop_inputs, inputs)
        if m is not None:
            inputs = inputs * m
        output, next_states = self.base_cell(inputs, states)
        m = self._mask(F, "outputs", self.drop_outputs, output)
        if m is not None:
            output = output * m
        return output, next_states

    def __repr__(self):
        return "%s(p_out = %s, p_state = %s)" % (
            self.__class__.__name__, self.drop_outputs, self.drop_states)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        # masks are per-sequence: resample at the start of every unroll
        self.reset()
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs,
                              valid_length=valid_length)


class LSTMPCell(HybridRecurrentCell):
    """LSTM with a learned projection of the recurrent state
    (reference: gluon/contrib/rnn/rnn_cell.py:198, arXiv:1402.1128).

    States are [projected (N, P), cell (N, H)]; the projection is the
    cell's output."""

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        from ..rnn.rnn_layer import _init_by_name

        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, projection_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.h2r_weight = self.params.get(
            "h2r_weight", shape=(projection_size, hidden_size),
            init=h2r_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,),
            init=_init_by_name(i2h_bias_initializer),
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,),
            init=_init_by_name(h2h_bias_initializer),
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstmp"

    def _infer_param_shapes(self, inputs, states, *args):
        self.i2h_weight.shape = (4 * self._hidden_size, inputs.shape[-1])

    def __repr__(self):
        return "%s(%s -> %d -> %d)" % (
            self.__class__.__name__, self.i2h_weight.shape[1] or None,
            self.i2h_weight.shape[0], self._projection_size)

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gi, gf, gc, go = F.SliceChannel(i2h + h2h, num_outputs=4, axis=1)
        i = F.sigmoid(gi)
        f = F.sigmoid(gf)
        c_tilde = F.Activation(gc, act_type="tanh")
        o = F.sigmoid(go)
        next_c = f * states[1] + i * c_tilde
        hidden = o * F.Activation(next_c, act_type="tanh")
        next_r = F.FullyConnected(hidden, h2r_weight, None, no_bias=True,
                                  num_hidden=self._projection_size)
        return next_r, [next_r, next_c]


def dynamic_unroll(cell, inputs, begin_state, drop_inputs=0, drop_outputs=0,
                   layout="TNC", valid_length=None):
    """Unroll `cell` over a merged sequence tensor (reference:
    gluon/contrib/rnn/rnn_cell.py:326).  Returns (outputs, states) with
    outputs merged in `layout`."""
    cell.reset()
    axis = layout.find("T")
    length = inputs.shape[axis]
    if drop_inputs:
        inputs = ndarray.Dropout(inputs, p=drop_inputs,
                                 axes=(axis,))
    view = _SeqView(inputs, layout)
    states = begin_state
    outputs = []
    step_states = []   # per step, per state slot (for valid_length)
    for t in range(length):
        out, states = cell(view.steps[t], states)
        outputs.append(out)
        if valid_length is not None:
            step_states.append(states)
    outputs = ndarray.stack(*outputs, axis=axis)
    if valid_length is not None:
        outputs = ndarray.SequenceMask(outputs, sequence_length=valid_length,
                                       use_sequence_length=True, axis=axis)
        # return each sample's state at its last valid step, not at the
        # last padded step
        states = _states_at_valid_length(step_states, len(states),
                                         valid_length)
    if drop_outputs:
        outputs = ndarray.Dropout(outputs, p=drop_outputs, axes=(axis,))
    return outputs, states
