"""Symbolic RNN cells (parity: mxnet_tpu/rnn/rnn_cell.py; the
reference's python/mxnet/rnn/rnn_cell.py — BaseRNNCell:108, RNNCell:362,
LSTMCell:408, GRUCell:469, SequentialRNNCell:748, the modifier and
bidirectional cells).

A cell is a gate count and an activation recipe over two shared
FullyConnected projections (input to gates, hidden to gates); the base
class owns the weight variables (``RNNParams``), the state bookkeeping
and ``unroll``, and a subclass gives ``state_names`` and ``step``.
Every bucket's unrolled graph takes the same weight variables, so a
BucketingModule's executors, one compiled graph a bucket, share one
parameter set.
"""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "ResidualCell",
           "BidirectionalCell"]


class RNNParams:
    """Shared-by-name weight container (reference RNNParams:78): the
    same logical name always resolves to the same Symbol variable."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._vars = {}

    def get(self, name, **kwargs):
        full = self._prefix + name
        if full not in self._vars:
            self._vars[full] = sym.var(full, **kwargs)
        return self._vars[full]


class BaseRNNCell:
    """Cell protocol: `step(x_t, states) -> (out_t, new_states)` plus
    weight/state bookkeeping; `unroll` drives the time loop."""

    def __init__(self, prefix="", params=None):
        self._prefix = prefix
        self._own_params = params is None
        self.params = params if params is not None else RNNParams(prefix)
        self._counter = 0

    # -- subclass surface -------------------------------------------------
    @property
    def state_names(self):
        raise NotImplementedError("cells declare their state names")

    def step(self, inputs, states):
        raise NotImplementedError("cells implement one time step")

    # -- shared machinery -------------------------------------------------
    @property
    def _num_states(self):
        return len(self.state_names)

    def reset(self):
        self._counter = 0

    def __call__(self, inputs, states):
        self._counter += 1
        return self.step(inputs, states)

    def begin_state(self, func=None, **kwargs):
        """Zero initial states as variables (bound by the executor) or
        via `func` (reference begin_state contract)."""
        out = []
        for name in self.state_names:
            full = "%s%s" % (self._prefix, name)
            out.append(sym.var(full) if func is None
                       else func(name=full, **kwargs))
        return out

    def unroll(self, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC", merge_outputs=None):
        """Unrolled symbol over `length` steps.

        inputs: a (N, T, C) Symbol (split internally), a list of per-step
        Symbols, or None (auto-created t%d vars).  Returns
        (outputs, states): outputs is a list per step, or one (N, T, C)
        Symbol when merge_outputs=True."""
        self.reset()
        if inputs is None:
            steps = [sym.var("%st%d_data" % (input_prefix, t))
                     for t in range(length)]
        elif isinstance(inputs, (list, tuple)):
            if len(inputs) != length:
                raise ValueError("unroll: %d inputs for length %d"
                                 % (len(inputs), length))
            steps = list(inputs)
        else:
            axis = layout.find("T")
            steps = list(sym.SliceChannel(inputs, num_outputs=length,
                                          axis=axis, squeeze_axis=True))
        states = begin_state if begin_state is not None \
            else self.begin_state()
        outs = []
        for t in range(length):
            out, states = self(steps[t], states)
            outs.append(out)
        if merge_outputs:
            taxis = layout.find("T")
            expanded = [sym.expand_dims(o, axis=taxis) for o in outs]
            return sym.Concat(*expanded, dim=taxis), states
        return outs, states

    # gate projection shared across every step of every unroll length
    def _gates(self, x, h, num_gates, num_hidden):
        n = num_gates * num_hidden
        i2h = sym.FullyConnected(
            x, weight=self.params.get("i2h_weight"),
            bias=self.params.get("i2h_bias"), num_hidden=n,
            name="%si2h_t%d" % (self._prefix, self._counter))
        h2h = sym.FullyConnected(
            h, weight=self.params.get("h2h_weight"),
            bias=self.params.get("h2h_bias"), num_hidden=n,
            name="%sh2h_t%d" % (self._prefix, self._counter))
        total = i2h + h2h
        if num_gates == 1:
            return (total,)
        return tuple(sym.SliceChannel(total, num_outputs=num_gates,
                                      axis=1))


class RNNCell(BaseRNNCell):
    """Vanilla tanh/relu cell."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix, params)
        self._nh = num_hidden
        self._act = activation

    @property
    def state_names(self):
        return ("state",)

    def step(self, x, states):
        (g,) = self._gates(x, states[0], 1, self._nh)
        h = sym.Activation(g, act_type=self._act)
        return h, [h]


class LSTMCell(BaseRNNCell):
    """LSTM with i/f/g/o gate order (reference LSTMCell:408).

    forget_bias is applied through the h2h bias INITIALIZER (reference
    behavior: init.LSTMBias bakes it into the learned bias), not added
    at every step — so parameters trained elsewhere load unchanged."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix, params)
        self._nh = num_hidden
        from .. import initializer as _init

        # materialize the bias var now with its init attr attached
        self.params.get("h2h_bias",
                        init=_init.LSTMBias(forget_bias=forget_bias))

    @property
    def state_names(self):
        return ("state", "state_cell")

    def step(self, x, states):
        h_prev, c_prev = states
        gi, gf, gg, go = self._gates(x, h_prev, 4, self._nh)
        i = sym.sigmoid(gi)
        f = sym.sigmoid(gf)
        g = sym.tanh(gg)
        o = sym.sigmoid(go)
        c = f * c_prev + i * g
        h = o * sym.tanh(c)
        return h, [h, c]


class GRUCell(BaseRNNCell):
    """GRU with r/z/h gate order (reference GRUCell:469)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix, params)
        self._nh = num_hidden

    @property
    def state_names(self):
        return ("state",)

    def step(self, x, states):
        h_prev = states[0]
        n = 3 * self._nh
        i2h = sym.FullyConnected(
            x, weight=self.params.get("i2h_weight"),
            bias=self.params.get("i2h_bias"), num_hidden=n,
            name="%si2h_t%d" % (self._prefix, self._counter))
        h2h = sym.FullyConnected(
            h_prev, weight=self.params.get("h2h_weight"),
            bias=self.params.get("h2h_bias"), num_hidden=n,
            name="%sh2h_t%d" % (self._prefix, self._counter))
        ir, iz, ih = sym.SliceChannel(i2h, num_outputs=3, axis=1)
        hr, hz, hh = sym.SliceChannel(h2h, num_outputs=3, axis=1)
        r = sym.sigmoid(ir + hr)
        z = sym.sigmoid(iz + hz)
        cand = sym.tanh(ih + r * hh)
        h = z * h_prev + (1 - z) * cand
        return h, [h]


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells applied in order each step."""

    def __init__(self, params=None):
        super().__init__("", params)
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        return self

    @property
    def state_names(self):
        return tuple("%s%s" % (c._prefix, n)
                     for c in self._cells for n in c.state_names)

    def begin_state(self, func=None, **kwargs):
        out = []
        for c in self._cells:
            out.extend(c.begin_state(func, **kwargs))
        return out

    def reset(self):
        super().reset()
        for c in self._cells:
            c.reset()

    def step(self, x, states):
        new_states = []
        pos = 0
        for c in self._cells:
            n = c._num_states
            x, s = c(x, states[pos:pos + n])
            new_states.extend(s)
            pos += n
        return x, new_states


class DropoutCell(BaseRNNCell):
    """Stateless dropout step (for SequentialRNNCell stacking)."""

    def __init__(self, dropout, prefix="dropout_"):
        super().__init__(prefix, RNNParams(prefix))
        self._p = dropout

    @property
    def state_names(self):
        return ()

    def step(self, x, states):
        return sym.Dropout(x, p=self._p), []


class ResidualCell(BaseRNNCell):
    """Adds the step input to the wrapped cell's output."""

    def __init__(self, base_cell):
        super().__init__(base_cell._prefix, base_cell.params)
        self.base_cell = base_cell

    @property
    def state_names(self):
        return self.base_cell.state_names

    def begin_state(self, func=None, **kwargs):
        return self.base_cell.begin_state(func, **kwargs)

    def reset(self):
        super().reset()
        self.base_cell.reset()

    def step(self, x, states):
        out, states = self.base_cell(x, states)
        return out + x, states


class BidirectionalCell(BaseRNNCell):
    """Forward + backward cells over the sequence; outputs concatenated.
    Only usable through unroll (the backward pass needs the whole
    sequence)."""

    def __init__(self, l_cell, r_cell):
        super().__init__("bi_", None)
        self._l = l_cell
        self._r = r_cell

    @property
    def state_names(self):
        return tuple("%s%s" % (c._prefix, n)
                     for c in (self._l, self._r) for n in c.state_names)

    def step(self, x, states):
        raise NotImplementedError(
            "BidirectionalCell supports unroll() only")

    def unroll(self, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC", merge_outputs=None):
        if inputs is None:
            raise ValueError(
                "BidirectionalCell.unroll requires explicit inputs: the "
                "backward direction must see the same sequence, which "
                "auto-created per-step variables cannot guarantee")
        if isinstance(inputs, (list, tuple)):
            steps = list(inputs)
            if len(steps) != length:
                raise ValueError("unroll: %d inputs for length %d"
                                 % (len(steps), length))
        else:
            axis = layout.find("T")
            steps = list(sym.SliceChannel(inputs, num_outputs=length,
                                          axis=axis, squeeze_axis=True))
        l_begin = r_begin = None
        if begin_state is not None:
            n_l = self._l._num_states
            l_begin = begin_state[:n_l]
            r_begin = begin_state[n_l:]
        fwd, f_states = self._l.unroll(length, inputs=steps,
                                       begin_state=l_begin)
        bwd_rev, b_states = self._r.unroll(length,
                                           inputs=list(reversed(steps)),
                                           begin_state=r_begin)
        bwd = list(reversed(bwd_rev))
        outs = [sym.Concat(f, b, dim=1) for f, b in zip(fwd, bwd)]
        if merge_outputs:
            taxis = layout.find("T")
            expanded = [sym.expand_dims(o, axis=taxis) for o in outs]
            return sym.Concat(*expanded, dim=taxis), f_states + b_states
        return outs, f_states + b_states
