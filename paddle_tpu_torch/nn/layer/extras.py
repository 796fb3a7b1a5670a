"""Layer-surface completion: counterpart of ``paddle_tpu/nn/layer/extras.py``
(reference: python/paddle/nn/layer/ — loss layers, pooling variants, pads,
containers, seq2seq decoding).  The beam search keeps its bookkeeping in
torch on the cell's device; ``dynamic_decode`` backtracks on the host, as
the reference does."""
from __future__ import annotations

import numpy as np
import torch

from ...core.dispatch import unwrap
from ...core.tensor import Tensor, Parameter
from .layers import Layer
from .. import functional as F


# ---- loss layers (thin wrappers over the functionals) ------------------------
def _loss_layer(name, fn, *fixed_keys, **defaults):
    class _L(Layer):
        def __init__(self, **kw):
            super().__init__()
            cfg = dict(defaults)
            cfg.update(kw)
            self._cfg = cfg

        def forward(self, *args):
            return fn(*args, **self._cfg)
    _L.__name__ = name
    _L.__qualname__ = name
    return _L


PoissonNLLLoss = _loss_layer("PoissonNLLLoss", F.poisson_nll_loss,
                             log_input=True, full=False, epsilon=1e-8,
                             reduction="mean")
GaussianNLLLoss = _loss_layer("GaussianNLLLoss", F.gaussian_nll_loss,
                              full=False, epsilon=1e-6, reduction="mean")
SoftMarginLoss = _loss_layer("SoftMarginLoss", F.soft_margin_loss,
                             reduction="mean")
MultiLabelSoftMarginLoss = _loss_layer("MultiLabelSoftMarginLoss",
                                       F.multi_label_soft_margin_loss,
                                       weight=None, reduction="mean")
MultiMarginLoss = _loss_layer("MultiMarginLoss", F.multi_margin_loss,
                              p=1, margin=1.0, weight=None, reduction="mean")
TripletMarginWithDistanceLoss = _loss_layer(
    "TripletMarginWithDistanceLoss", F.triplet_margin_with_distance_loss,
    distance_function=None, margin=1.0, swap=False, reduction="mean")


class CTCLoss(Layer):
    """reference loss.py CTCLoss."""

    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=self.blank, reduction=self.reduction,
                          norm_by_times=norm_by_times)


class RNNTLoss(Layer):
    """reference loss.py RNNTLoss."""

    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean",
                 name=None):
        super().__init__()
        self.blank = blank
        self.fastemit_lambda = fastemit_lambda
        self.reduction = reduction

    def forward(self, input, label, input_lengths, label_lengths):
        return F.rnnt_loss(input, label, input_lengths, label_lengths,
                           blank=self.blank,
                           fastemit_lambda=self.fastemit_lambda,
                           reduction=self.reduction)


class HSigmoidLoss(Layer):
    """reference loss.py HSigmoidLoss — owns the internal-node weight table
    ((num_classes - 1) rows for the default complete binary tree)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False, name=None):
        super().__init__()
        self.num_classes = num_classes
        # the complete binary tree over num_classes leaves has exactly
        # num_classes - 1 internal nodes (heap ids 1..C-1 -> rows 0..C-2),
        # matching the reference's [num_classes - 1, feature_size] weight
        n_nodes = num_classes - 1
        from ..initializer import XavierUniform, Constant
        self.weight = self.create_parameter(
            [n_nodes, feature_size], attr=weight_attr,
            default_initializer=XavierUniform())
        self.bias = self.create_parameter(
            [n_nodes], attr=bias_attr, is_bias=True,
            default_initializer=Constant(0.0))

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               bias=self.bias, path_table=path_table,
                               path_code=path_code)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """reference loss.py AdaptiveLogSoftmaxWithLoss (torch-style cutoffs +
    div_value tail down-projections)."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, name=None):
        super().__init__()
        cutoffs = list(cutoffs)
        if cutoffs != sorted(cutoffs) or cutoffs[-1] >= n_classes:
            raise ValueError("cutoffs must be increasing and < n_classes")
        self.cutoffs = cutoffs + [n_classes]
        self.n_clusters = len(cutoffs)
        from ..initializer import XavierUniform, Constant
        head_out = cutoffs[0] + self.n_clusters
        self.head_weight = self.create_parameter(
            [in_features, head_out], default_initializer=XavierUniform())
        self.head_bias = self.create_parameter(
            [head_out], is_bias=True, default_initializer=Constant(0.0)) \
            if head_bias else None
        for i in range(self.n_clusters):
            hsz = max(1, int(in_features / (div_value ** (i + 1))))
            osz = self.cutoffs[i + 1] - self.cutoffs[i]
            proj = self.create_parameter([in_features, hsz],
                                         default_initializer=XavierUniform())
            cls = self.create_parameter([hsz, osz],
                                        default_initializer=XavierUniform())
            self.add_parameter(f"tail_proj_{i}", proj)
            self.add_parameter(f"tail_cls_{i}", cls)

    def forward(self, input, label):
        out, loss = F.adaptive_log_softmax_with_loss(
            input, label, self.head_weight, self._collect_tails(),
            self.cutoffs, head_bias=self.head_bias)
        return out, loss

    def _collect_tails(self):
        tails = []
        for i in range(self.n_clusters):
            tails.append(self._parameters[f"tail_proj_{i}"])
            tails.append(self._parameters[f"tail_cls_{i}"])
        return tails

    def log_prob(self, input):
        """Full [N, n_classes] log-probabilities (eval utility)."""
        x = input
        head = x @ Tensor(self.head_weight._buf)
        if self.head_bias is not None:
            head = head + self.head_bias
        head_lp = F.log_softmax(head, axis=-1)
        parts = [head_lp[:, :self.cutoffs[0]]]
        for i in range(self.n_clusters):
            h = x @ self._parameters[f"tail_proj_{i}"]
            tail_lp = F.log_softmax(h @ self._parameters[f"tail_cls_{i}"],
                                    axis=-1)
            cluster = head_lp[:, self.cutoffs[0] + i].unsqueeze(-1)
            parts.append(tail_lp + cluster)
        from ... import ops
        return ops.concat(parts, axis=-1)

    def predict(self, input):
        from ... import ops
        return ops.argmax(self.log_prob(input), axis=-1)


# ---- misc layers -------------------------------------------------------------
class Softmax2D(Layer):
    """reference activation.py Softmax2D: softmax over the channel dim of
    NCHW."""

    def forward(self, x):
        if x.ndim not in (3, 4):
            raise ValueError("Softmax2D expects 3-D or 4-D input")
        return F.softmax(x, axis=-3)


class Unflatten(Layer):
    """reference common.py Unflatten."""

    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis, self.shape = axis, shape

    def forward(self, x):
        from ... import ops
        return ops.unflatten(x, self.axis, self.shape)


class ParameterDict(Layer):
    """reference container.py ParameterDict."""

    def __init__(self, parameters=None):
        super().__init__()
        if parameters:
            for k, v in (parameters.items() if isinstance(parameters, dict)
                         else parameters):
                self.add_parameter(str(k), v)

    def __getitem__(self, key):
        return self._parameters[str(key)]

    def __setitem__(self, key, value):
        self.add_parameter(str(key), value)

    def __contains__(self, key):
        return str(key) in self._parameters

    def __len__(self):
        return len(self._parameters)

    def keys(self):
        return self._parameters.keys()

    def values(self):
        return self._parameters.values()

    def items(self):
        return self._parameters.items()

    def update(self, parameters):
        for k, v in (parameters.items() if isinstance(parameters, dict)
                     else parameters):
            self.add_parameter(str(k), v)


class _PadCompat(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format=None, name=None):
        super().__init__()
        self._padding = padding
        self._value = value
        self._df = data_format

    def forward(self, x):
        return F.pad(x, self._padding, mode="constant", value=self._value,
                     data_format=self._df or self._default_df)


class ZeroPad1D(_PadCompat):
    """reference common.py ZeroPad1D (NCL)."""
    _default_df = "NCL"


class ZeroPad3D(_PadCompat):
    """reference common.py ZeroPad3D (NCDHW)."""
    _default_df = "NCDHW"


# ---- pooling variants --------------------------------------------------------
class LPPool1D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCL", name=None):
        super().__init__()
        self._a = (norm_type, kernel_size, stride, padding, ceil_mode,
                   data_format)

    def forward(self, x):
        n, k, s, p, c, df = self._a
        return F.lp_pool1d(x, n, k, s, p, ceil_mode=c, data_format=df)


class LPPool2D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self._a = (norm_type, kernel_size, stride, padding, ceil_mode,
                   data_format)

    def forward(self, x):
        n, k, s, p, c, df = self._a
        return F.lp_pool2d(x, n, k, s, p, ceil_mode=c, data_format=df)


class FractionalMaxPool2D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self._a = (output_size, kernel_size, random_u, return_mask)

    def forward(self, x):
        o, k, u, m = self._a
        return F.fractional_max_pool2d(x, o, k, u, return_mask=m)


class FractionalMaxPool3D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self._a = (output_size, kernel_size, random_u, return_mask)

    def forward(self, x):
        o, k, u, m = self._a
        return F.fractional_max_pool3d(x, o, k, u, return_mask=m)


class MaxUnPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
        super().__init__()
        self._kw = dict(kernel_size=kernel_size, stride=stride,
                        padding=padding, output_size=output_size)

    def forward(self, x, indices):
        return F.max_unpool3d(x, indices, **self._kw)


# ---- seq2seq decoding --------------------------------------------------------
class Decoder:
    """reference decoder.py Decoder protocol (initialize/step/finalize)."""


class BeamSearchDecoder(Decoder):
    """reference decoder.py BeamSearchDecoder over an RNN cell: expand each
    batch row into `beam_size` hypotheses, step the cell on the flattened
    beam batch, keep the top-k continuations by accumulated log-prob."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def _map_states(fn, states):
        """Apply fn to every Tensor leaf, preserving the cell's own state
        structure (Tensor for GRU/SimpleRNN, tuple for LSTM, nests thereof)."""
        if isinstance(states, (list, tuple)):
            return type(states)(BeamSearchDecoder._map_states(fn, s)
                                for s in states)
        return fn(states)

    @staticmethod
    def _first_leaf(states):
        while isinstance(states, (list, tuple)):
            states = states[0]
        return states

    def initialize(self, initial_cell_states):
        first = self._first_leaf(initial_cell_states)
        B = first.shape[0]
        K = self.beam_size
        dev = unwrap(first).device if isinstance(first, Tensor) else \
            torch.device("cpu")

        def tile(t):
            arr = unwrap(t) if isinstance(t, Tensor) else torch.as_tensor(t)
            return Tensor(torch.repeat_interleave(arr, K, dim=0))
        states = self._map_states(tile, initial_cell_states)
        tokens = Tensor(torch.full((B * K,), self.start_token,
                                   dtype=torch.int32, device=dev))
        # first expansion: only beam 0 is live so duplicates don't win top-k
        log_probs = torch.where(torch.arange(K, device=dev) == 0, 0.0,
                                -1e9).tile(B)
        finished = torch.zeros((B * K,), dtype=torch.bool, device=dev)
        return tokens, states, (Tensor(log_probs), Tensor(finished))

    def step(self, time, inputs, states, aux):
        log_probs, finished = aux
        K = self.beam_size
        emb = self.embedding_fn(inputs) if self.embedding_fn else inputs
        out, new_states = self.cell(emb, states)
        logits = self.output_fn(out) if self.output_fn else out
        lp = torch.log_softmax(unwrap(logits).detach().float(), dim=-1)
        V = lp.shape[-1]
        BK = lp.shape[0]
        B = BK // K
        fin = unwrap(finished)
        # finished beams only extend with end_token at prob 1
        keep_end = torch.full((V,), -1e9, device=lp.device)
        keep_end[self.end_token] = 0.0
        lp = torch.where(fin[:, None], keep_end[None, :], lp)
        total = unwrap(log_probs)[:, None] + lp                   # [BK, V]
        flat = total.reshape(B, K * V)
        top_lp, top_idx = torch.topk(flat, K, dim=-1)             # [B, K]
        parent = top_idx // V                                      # beam index
        token = top_idx % V
        flat_parent = (torch.arange(B, device=lp.device)[:, None] * K
                       + parent).reshape(-1)

        def sel(t):
            arr = unwrap(t) if isinstance(t, Tensor) else t
            return Tensor(arr[flat_parent])
        new_states = self._map_states(sel, new_states)
        tokens = Tensor(token.reshape(-1).to(torch.int32))
        new_fin = fin[flat_parent] | (token.reshape(-1) == self.end_token)
        return (tokens, new_states,
                (Tensor(top_lp.reshape(-1)), Tensor(new_fin)),
                Tensor(flat_parent.to(torch.int32)))

    def finished(self, aux):
        return bool(aux[1].numpy().all())


def dynamic_decode(decoder, inits=None, max_step_num=32, **kw):
    """reference decoder.py dynamic_decode: run decoder.initialize + step
    until all beams finish or max_step_num; returns (ids [B, K, T],
    final log-probs [B, K])."""
    tokens, states, aux = decoder.initialize(inits)
    K = decoder.beam_size
    ids, parents = [], []
    for t in range(max_step_num):
        tokens, states, aux, parent = decoder.step(t, tokens, states, aux)
        ids.append(tokens.numpy())
        parents.append(parent.numpy())
        if decoder.finished(aux):
            break
    T = len(ids)
    BK = ids[0].shape[0]
    B = BK // K
    # backtrack parent pointers to recover aligned sequences
    seqs = np.zeros((T, BK), np.int64)
    cur = np.arange(BK)
    for t in range(T - 1, -1, -1):
        seqs[t] = ids[t][cur]
        cur = parents[t][cur]
    out = seqs.T.reshape(B, K, T)
    lp = aux[0].numpy().reshape(B, K)
    dev = unwrap(aux[0]).device
    # 32-bit ids, as the reference's (JAX runs with x64 off)
    return (Tensor(torch.as_tensor(out.astype(np.int32), device=dev)),
            Tensor(torch.as_tensor(lp, device=dev)))
