"""Recurrent layers: counterpart of ``paddle_tpu/nn/layer/rnn.py`` (reference:
python/paddle/nn/layer/rnn.py — SimpleRNNCell, LSTMCell, GRUCell, RNN
wrapper, SimpleRNN/LSTM/GRU multi-layer nets).

The cells' step is one ``apply_op`` of torch math in the reference's gate
orders (LSTM i, f, g, o; GRU r, z, c with c = tanh(x_c + r (W_hc h +
b_hc))).  A whole layer and direction runs as ONE dispatched op, as the
reference's ``jax.lax.scan`` does: torch's fused recurrence
(``torch._VF.lstm`` / ``gru`` / ``rnn_tanh`` / ``rnn_relu``, cuDNN on the
card), whose gate orders and GRU candidate are the same functions."""
from __future__ import annotations

import math

import torch

from ...ops import creation as _creation
from ...core.dispatch import apply_op
from ...core.tensor import Tensor
from ..initializer import Uniform as UniformInit
from .layers import Layer

__all__ = ["SimpleRNNCell", "LSTMCell", "GRUCell", "RNN", "BiRNN",
           "SimpleRNN", "LSTM", "GRU"]


def _std_init(hidden_size):
    k = 1.0 / math.sqrt(hidden_size)
    return UniformInit(-k, k)


class RNNCellBase(Layer):
    def get_initial_states(self, batch, hidden_size=None, dtype="float32"):
        h = hidden_size or self.hidden_size
        return _creation.zeros([batch, h], dtype)


class SimpleRNNCell(RNNCellBase):
    """h' = act(x W_ih^T + b_ih + h W_hh^T + b_hh) (reference SimpleRNNCell)."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        init = _std_init(hidden_size)
        self.weight_ih = self.create_parameter([hidden_size, input_size],
                                               attr=weight_ih_attr,
                                               default_initializer=init)
        self.weight_hh = self.create_parameter([hidden_size, hidden_size],
                                               attr=weight_hh_attr,
                                               default_initializer=init)
        self.bias_ih = self.create_parameter([hidden_size], attr=bias_ih_attr,
                                             is_bias=True,
                                             default_initializer=init)
        self.bias_hh = self.create_parameter([hidden_size], attr=bias_hh_attr,
                                             is_bias=True,
                                             default_initializer=init)

    def _step(self, x, h, wih, whh, bih, bhh):
        act = torch.tanh if self.activation == "tanh" else torch.relu
        return act(x @ wih.T + bih + h @ whh.T + bhh)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs.shape[0])
        out = apply_op("simple_rnn_cell", self._step, inputs, states,
                       self.weight_ih, self.weight_hh, self.bias_ih,
                       self.bias_hh)
        return out, out

    @property
    def state_shape(self):
        return (self.hidden_size,)


class LSTMCell(RNNCellBase):
    """Gates i,f,g,o packed in [4H, ...] rows (reference LSTMCell)."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 proj_size=None, name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        init = _std_init(hidden_size)
        self.weight_ih = self.create_parameter([4 * hidden_size, input_size],
                                               attr=weight_ih_attr,
                                               default_initializer=init)
        self.weight_hh = self.create_parameter([4 * hidden_size, hidden_size],
                                               attr=weight_hh_attr,
                                               default_initializer=init)
        self.bias_ih = self.create_parameter([4 * hidden_size],
                                             attr=bias_ih_attr, is_bias=True,
                                             default_initializer=init)
        self.bias_hh = self.create_parameter([4 * hidden_size],
                                             attr=bias_hh_attr, is_bias=True,
                                             default_initializer=init)

    @staticmethod
    def _step(x, h, c, wih, whh, bih, bhh):
        gates = x @ wih.T + bih + h @ whh.T + bhh
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        c2 = f * c + i * g
        return torch.tanh(c2) * o, c2

    def forward(self, inputs, states=None):
        if states is None:
            b = inputs.shape[0]
            states = (self.get_initial_states(b), self.get_initial_states(b))
        h, c = states
        h2, c2 = apply_op("lstm_cell", self._step, inputs, h, c,
                          self.weight_ih, self.weight_hh, self.bias_ih,
                          self.bias_hh)
        return h2, (h2, c2)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(RNNCellBase):
    """Gates r,z,c packed in [3H, ...] rows (reference GRUCell)."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        init = _std_init(hidden_size)
        self.weight_ih = self.create_parameter([3 * hidden_size, input_size],
                                               attr=weight_ih_attr,
                                               default_initializer=init)
        self.weight_hh = self.create_parameter([3 * hidden_size, hidden_size],
                                               attr=weight_hh_attr,
                                               default_initializer=init)
        self.bias_ih = self.create_parameter([3 * hidden_size],
                                             attr=bias_ih_attr, is_bias=True,
                                             default_initializer=init)
        self.bias_hh = self.create_parameter([3 * hidden_size],
                                             attr=bias_hh_attr, is_bias=True,
                                             default_initializer=init)

    @staticmethod
    def _step(x, h, wih, whh, bih, bhh):
        xg = x @ wih.T + bih
        hg = h @ whh.T + bhh
        xr, xz, xc = torch.chunk(xg, 3, dim=-1)
        hr, hz, hc = torch.chunk(hg, 3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        c = torch.tanh(xc + r * hc)
        return (1 - z) * c + z * h

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs.shape[0])
        h2 = apply_op("gru_cell", self._step, inputs, states,
                      self.weight_ih, self.weight_hh, self.bias_ih,
                      self.bias_hh)
        return h2, h2

    @property
    def state_shape(self):
        return (self.hidden_size,)


# ---- sequence runners (torch's fused recurrence inside one dispatched op) ---
_FUSED = {"LSTM": "lstm", "GRU": "gru", "RNN_TANH": "rnn_tanh",
          "RNN_RELU": "rnn_relu"}


def _scan_layer(mode, x, h0, c0, wih, whh, bih, bhh, reverse=False):
    """x [B, T, I] → (out [B, T, H], hT, cT): one layer and direction
    through torch's fused recurrence (train mode, which cuDNN needs for a
    backward; no dropout inside it)."""
    if reverse:
        x = torch.flip(x, [1])
    fused = getattr(torch._VF, _FUSED[mode])
    params = [wih, whh, bih, bhh]
    if mode == "LSTM":
        ys, hT, cT = fused(x, (h0[None], c0[None]), params, True, 1, 0.0,
                           True, False, True)
        hT, cT = hT[0], cT[0]
    else:
        ys, hT = fused(x, h0[None], params, True, 1, 0.0, True, False, True)
        hT = cT = hT[0]
    if reverse:
        ys = torch.flip(ys, [1])
    return ys, hT, cT


class _MultiLayerRNN(Layer):
    """Shared driver for SimpleRNN/LSTM/GRU (reference RNNBase)."""

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"bad direction {direction}")
        self.mode = mode
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers = num_layers
        self.bidirectional = direction != "forward"
        self.num_directions = 2 if self.bidirectional else 1
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        gate_mul = {"LSTM": 4, "GRU": 3}.get(mode, 1)
        init = _std_init(hidden_size)
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_sz = input_size if layer == 0 else \
                    hidden_size * self.num_directions
                sfx = f"l{layer}" + ("_reverse" if d else "")
                setattr(self, f"weight_ih_{sfx}", self.create_parameter(
                    [gate_mul * hidden_size, in_sz], attr=weight_ih_attr,
                    default_initializer=init))
                setattr(self, f"weight_hh_{sfx}", self.create_parameter(
                    [gate_mul * hidden_size, hidden_size],
                    attr=weight_hh_attr, default_initializer=init))
                setattr(self, f"bias_ih_{sfx}", self.create_parameter(
                    [gate_mul * hidden_size], attr=bias_ih_attr, is_bias=True,
                    default_initializer=init))
                setattr(self, f"bias_hh_{sfx}", self.create_parameter(
                    [gate_mul * hidden_size], attr=bias_hh_attr, is_bias=True,
                    default_initializer=init))

    def _mode_key(self):
        if self.mode == "RNN":
            return "RNN_TANH" if self.activation == "tanh" else "RNN_RELU"
        return self.mode

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs
        if self.time_major:
            from ... import ops
            x = ops.transpose(x, [1, 0, 2])
        B = x.shape[0]
        L, D, H = self.num_layers, self.num_directions, self.hidden_size
        is_lstm = self.mode == "LSTM"
        if initial_states is None:
            z = _creation.zeros([L * D, B, H], "float32")
            h0_all, c0_all = (z, z) if is_lstm else (z, None)
        else:
            h0_all, c0_all = initial_states if is_lstm else (initial_states,
                                                             None)
        mode = self._mode_key()
        h_outs, c_outs = [], []
        for layer in range(L):
            outs = []
            for d in range(D):
                sfx = f"l{layer}" + ("_reverse" if d else "")
                wih = getattr(self, f"weight_ih_{sfx}")
                whh = getattr(self, f"weight_hh_{sfx}")
                bih = getattr(self, f"bias_ih_{sfx}")
                bhh = getattr(self, f"bias_hh_{sfx}")
                idx = layer * D + d
                h0 = h0_all[idx]
                c0 = c0_all[idx] if is_lstm else h0

                def seq_fn(xx, hh, cc, a, b, e, g, _d=d, _mode=mode):
                    return _scan_layer(_mode, xx, hh, cc, a, b, e, g,
                                       reverse=bool(_d))

                out, hT, cT = apply_op(f"{mode.lower()}_layer", seq_fn, x, h0,
                                       c0, wih, whh, bih, bhh)
                outs.append(out)
                h_outs.append(hT)
                c_outs.append(cT)
            if D == 2:
                from ... import ops
                x = ops.concat(outs, axis=-1)
            else:
                x = outs[0]
            if self.dropout and layer < L - 1 and self.training:
                from .. import functional as F
                x = F.dropout(x, p=self.dropout)
        from ... import ops
        h_stack = ops.stack(h_outs, axis=0)
        out = ops.transpose(x, [1, 0, 2]) if self.time_major else x
        if is_lstm:
            return out, (h_stack, ops.stack(c_outs, axis=0))
        return out, h_stack


class SimpleRNN(_MultiLayerRNN):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        super().__init__("RNN", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, activation, **kw)


class LSTM(_MultiLayerRNN):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        kw.pop("activation", None)
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class GRU(_MultiLayerRNN):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        kw.pop("activation", None)
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class RNN(Layer):
    """Generic cell runner (reference rnn.py RNN): steps a cell over time via
    a Python loop at the Tensor level — works with ANY user cell."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ... import ops
        x = inputs if not self.time_major else ops.transpose(inputs, [1, 0, 2])
        T = x.shape[1]
        steps = range(T - 1, -1, -1) if self.is_reverse else range(T)
        state = initial_states
        outs = [None] * T
        for t in steps:
            out, state = self.cell(x[:, t], state)
            outs[t] = out
        y = ops.stack(outs, axis=1)
        if self.time_major:
            y = ops.transpose(y, [1, 0, 2])
        return y, state


class BiRNN(Layer):
    """Forward + backward cells, concatenated outputs (reference BiRNN)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ... import ops
        s_fw, s_bw = (initial_states if initial_states is not None
                      else (None, None))
        y_fw, st_fw = self.rnn_fw(inputs, s_fw)
        y_bw, st_bw = self.rnn_bw(inputs, s_bw)
        return ops.concat([y_fw, y_bw], axis=-1), (st_fw, st_bw)
