"""Gluon's recurrent cells (parity: mxnet_tpu/gluon/rnn/rnn_cell.py; the
reference's python/mxnet/gluon/rnn/rnn_cell.py): RNNCell, LSTMCell,
GRUCell, SequentialRNNCell, DropoutCell and the modifier cells
ZoneoutCell, ResidualCell and BidirectionalCell.  A cell is one time
step written against ``F``; ``unroll`` runs it over a sequence in
Python (taped ops eagerly, an unrolled graph when compiled), with
``valid_length`` masking each row's padding and returning each row's
state at its last valid step.  Begin states are made on the input's
context."""
from __future__ import annotations

from ..block import Block, HybridBlock
from ..parameter import Parameter
from ... import ndarray

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ZoneoutCell",
           "ResidualCell", "BidirectionalCell"]


def _states_at_valid_length(step_states, n_states, valid_length):
    """Reduce per-step states to each row's state at its last *valid*
    step (reference rnn_cell.py:259): stack each state slot time-major
    and take SequenceLast with the row's valid length."""
    return [ndarray.SequenceLast(
                ndarray.stack(*[s[i] for s in step_states], axis=0),
                sequence_length=valid_length,
                use_sequence_length=True)
            for i in range(n_states)]


class _SeqView:
    """A sequence input normalized to per-step arrays.

    Accepts either a merged (layout-ordered) array or an already-split
    list of per-step arrays; exposes `.steps` for cell-by-cell unrolling
    plus the layout facts (`time_axis`, `batch_size`) and the inverse
    operation (`merge`).  Cells only ever deal in steps — how the user
    packed the sequence is this view's problem."""

    def __init__(self, inputs, layout):
        assert inputs is not None
        self.time_axis = layout.find("T")
        if isinstance(inputs, (list, tuple)):
            self.steps = list(inputs)
            first = self.steps[0]
            self.batch_size = first.shape[0] if first.ndim > 0 else 0
            self.context = first.context
        else:
            t = inputs.shape[self.time_axis]
            self.steps = [
                inputs.slice_axis(self.time_axis, i, i + 1)
                .squeeze(axis=self.time_axis) for i in range(t)]
            self.batch_size = inputs.shape[layout.find("N")]
            self.context = inputs.context

    def merge(self, steps):
        """Per-step outputs -> one layout-ordered array."""
        return ndarray.stack(*steps, axis=self.time_axis)

    def split(self, merged):
        """Inverse of merge (used after sequence-level ops like
        SequenceMask that want the whole tensor at once).  Uses the
        MERGED tensor's own time size: an unroll may cover fewer steps
        than the view holds."""
        return [merged.slice_axis(self.time_axis, i, i + 1)
                .squeeze(axis=self.time_axis)
                for i in range(merged.shape[self.time_axis])]

    def reversed_steps(self, valid_length=None):
        """Steps in reverse time order.  With `valid_length`, each
        batch row reverses only its first valid_length steps (padding
        stays in place) — SequenceReverse semantics, which a plain
        python reversal gets wrong for ragged batches."""
        if valid_length is None:
            return self.steps[::-1]
        stacked = ndarray.stack(*self.steps, axis=0)  # time-major
        rev = ndarray.SequenceReverse(stacked,
                                      sequence_length=valid_length,
                                      use_sequence_length=True)
        return [rev[i] for i in range(len(self.steps))]


class RecurrentCell(Block):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if hasattr(cell, "reset"):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError()

    def begin_state(self, batch_size=0, func=ndarray.zeros, **kwargs):
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called "\
            "directly. Call the modifier cell instead."
        states = []
        for info in self.state_info(batch_size):
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            states.append(func(**{k: v for k, v in info.items()
                                  if k != "name"}))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        seq = _SeqView(inputs, layout)
        states = begin_state if begin_state is not None else \
            self.begin_state(func=ndarray.zeros,
                             batch_size=seq.batch_size, ctx=seq.context)
        outputs = []
        step_states = []   # per step, per state slot (for valid_length)
        for x in seq.steps[:length]:
            out, states = self(x, states)
            outputs.append(out)
            if valid_length is not None:
                step_states.append(states)
        if valid_length is not None:
            masked = ndarray.SequenceMask(
                seq.merge(outputs), sequence_length=valid_length,
                use_sequence_length=True, axis=seq.time_axis)
            # each row's state at its last *valid* step, not after the
            # padding steps
            states = _states_at_valid_length(step_states, len(states),
                                             valid_length)
            return (seq.split(masked) if merge_outputs is False
                    else masked), states
        if merge_outputs:
            return seq.merge(outputs), states
        return outputs, states

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, inputs, states):
        self._counter += 1
        return HybridBlock.forward(self, inputs, states)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class RNNCell(HybridRecurrentCell):
    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self.i2h_weight = self.params.get("i2h_weight",
                                          shape=(hidden_size, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get("h2h_weight",
                                          shape=(hidden_size, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        from .rnn_layer import _init_by_name

        self.i2h_bias = self.params.get("i2h_bias", shape=(hidden_size,),
                                        init=_init_by_name(i2h_bias_initializer),
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get("h2h_bias", shape=(hidden_size,),
                                        init=_init_by_name(h2h_bias_initializer),
                                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def _infer_param_shapes(self, inputs, states, *args):
        self.i2h_weight.shape = (self._hidden_size, inputs.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = "t%d_" % self._counter
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        i2h_plus_h2h = i2h + h2h
        output = F.Activation(i2h_plus_h2h, act_type=self._activation)
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        from .rnn_layer import _init_by_name

        self.i2h_weight = self.params.get("i2h_weight",
                                          shape=(4 * hidden_size, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get("h2h_weight",
                                          shape=(4 * hidden_size, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        self.i2h_bias = self.params.get("i2h_bias", shape=(4 * hidden_size,),
                                        init=_init_by_name(i2h_bias_initializer),
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get("h2h_bias", shape=(4 * hidden_size,),
                                        init=_init_by_name(h2h_bias_initializer),
                                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def _infer_param_shapes(self, inputs, states, *args):
        self.i2h_weight.shape = (4 * self._hidden_size, inputs.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        slice_gates = F.SliceChannel(gates, num_outputs=4, axis=1)
        in_gate = F.Activation(slice_gates[0], act_type="sigmoid")
        forget_gate = F.Activation(slice_gates[1], act_type="sigmoid")
        in_transform = F.Activation(slice_gates[2], act_type="tanh")
        out_gate = F.Activation(slice_gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        from .rnn_layer import _init_by_name

        self.i2h_weight = self.params.get("i2h_weight",
                                          shape=(3 * hidden_size, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get("h2h_weight",
                                          shape=(3 * hidden_size, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        self.i2h_bias = self.params.get("i2h_bias", shape=(3 * hidden_size,),
                                        init=_init_by_name(i2h_bias_initializer),
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get("h2h_bias", shape=(3 * hidden_size,),
                                        init=_init_by_name(h2h_bias_initializer),
                                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def _infer_param_shapes(self, inputs, states, *args):
        self.i2h_weight.shape = (3 * self._hidden_size, inputs.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_state_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(prev_state_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        i2h_r, i2h_z, i2h = F.SliceChannel(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h = F.SliceChannel(h2h, num_outputs=3, axis=1)
        reset_gate = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = F.Activation(i2h + reset_gate * h2h, act_type="tanh")
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_state_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return [i for c in self._children.values()
                for i in c.state_info(batch_size)]

    def begin_state(self, **kwargs):
        assert not self._modified
        return [s for c in self._children.values()
                for s in c.begin_state(**kwargs)]

    def __call__(self, inputs, states):
        self._counter += 1
        assert all(not isinstance(cell, BidirectionalCell)
                   for cell in self._children.values())
        next_states = []
        p = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            inputs, cell_next = cell(inputs, states[p:p + n])
            next_states.extend(cell_next)
            p += n
        return inputs, next_states

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def forward(self, *args):
        raise NotImplementedError


class DropoutCell(HybridRecurrentCell):
    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        assert isinstance(rate, float)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified." % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=ndarray.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell)
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return F.Dropout(F.ones_like(like), p=p, mode="always")

        prev_output = self._prev_output
        if prev_output is None:
            prev_output = F.zeros_like(next_output)
        output = (F.where(mask(p_outputs, next_output), next_output,
                          prev_output)
                  if p_outputs != 0.0 else next_output)
        new_states = ([F.where(mask(p_states, new_s), new_s, old_s)
                       for new_s, old_s in zip(next_states, states)]
                      if p_states != 0.0 else next_states)
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    def __init__(self, base_cell):
        super().__init__(base_cell)

    def _alias(self):
        return "residual"

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states


class BidirectionalCell(HybridRecurrentCell):
    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError("Bidirectional cannot be stepped. "
                                  "Please use unroll")

    def state_info(self, batch_size=0):
        return [i for c in self._children.values()
                for i in c.state_info(batch_size)]

    def begin_state(self, **kwargs):
        assert not self._modified
        return [s for c in self._children.values()
                for s in c.begin_state(**kwargs)]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        seq = _SeqView(inputs, layout)
        states = begin_state if begin_state is not None else \
            self.begin_state(func=ndarray.zeros,
                             batch_size=seq.batch_size, ctx=seq.context)
        l_cell, r_cell = self._children.values()
        n_l = len(l_cell.state_info(seq.batch_size))
        l_outputs, l_states = l_cell.unroll(
            length, inputs=seq.steps, begin_state=states[:n_l],
            layout=layout, merge_outputs=False,
            valid_length=valid_length)
        # the right cell consumes time reversed; with valid_length each
        # row reverses within its own valid span (ragged batches keep
        # padding in place — a plain reversed() would feed padding first)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=seq.reversed_steps(valid_length),
            begin_state=states[n_l:], layout=layout,
            merge_outputs=False, valid_length=valid_length)
        r_view = _SeqView(r_outputs, layout)
        r_outputs = r_view.reversed_steps(valid_length)
        outputs = [ndarray.concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, r_outputs)]
        if merge_outputs:
            outputs = seq.merge(outputs)
        return outputs, l_states + r_states
