"""paddle.text analog: counterpart of ``paddle_tpu/text/__init__.py``
(reference: python/paddle/text — viterbi_decode.py + datasets/).

Viterbi is a loop over time on device tensors — the max-product forward
pass, then the backtrace — with no read back to the host inside it (the
reference runs it as a ``lax.scan``).  Ties resolve to the first index, as
``jnp.argmax`` does."""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor
from ..core.dispatch import apply_op, unwrap
from ..nn.layer.layers import Layer
from . import datasets

__all__ = ["viterbi_decode", "ViterbiDecoder", "datasets"]


def _lengths(lengths, like):
    if isinstance(lengths, Tensor):
        return Tensor(unwrap(lengths).to(torch.int32))
    return Tensor(torch.as_tensor(np.asarray(lengths), dtype=torch.int32,
                                  device=unwrap(like).device))


def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag=True, name=None):
    """reference: text/viterbi_decode.py:31.

    potentials [B, T, N], transition_params [N, N], lengths [B] ->
    (scores [B], paths [B, T] int64; positions past each length are 0)."""
    def f(emit, trans, lens):
        B, T, N = emit.shape
        e = emit.to(torch.float32).transpose(0, 1)           # [T, B, N]
        tr = trans.to(torch.float32)
        lens = lens.to(torch.int64)
        if include_bos_eos_tag:
            # last row/col = BOS, second-to-last = EOS (reference contract)
            alpha = e[0] + tr[-1][None, :]
        else:
            alpha = e[0]
        ptrs = []
        for t in range(1, T):
            # alpha [B, N]; score of moving i->j
            m = alpha[:, :, None] + tr[None, :, :]           # [B, N, N]
            best = torch.amax(m, dim=1) + e[t]               # [B, N]
            ptrs.append(torch.argmax(m, dim=1))              # [B, N]
            # sequences already past their length keep alpha frozen
            alpha = torch.where((t < lens)[:, None], best, alpha)
        if include_bos_eos_tag:
            # transition into EOS for each sequence's final state
            alpha = alpha + tr[:, -2][None, :]
        scores = torch.amax(alpha, dim=-1)
        tag = torch.argmax(alpha, dim=-1)                    # [B]

        # backtrace from each sequence's last valid position
        tags = [tag]
        for t in range(T - 1, 0, -1):
            prev = torch.gather(ptrs[t - 1], 1, tag[:, None])[:, 0]
            tag = torch.where(t < lens, prev, tag)
            tags.append(tag)
        path = torch.stack(tags[::-1], 1)                    # [B, T]
        mask = torch.arange(T, device=path.device)[None, :] < lens[:, None]
        return scores, torch.where(mask, path, 0)

    return apply_op("viterbi_decode", f, potentials, transition_params,
                    _lengths(lengths, potentials))


class ViterbiDecoder(Layer):
    """reference: viterbi_decode.py:110 — holds the transition matrix."""

    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        super().__init__()
        self.transitions = transitions if isinstance(transitions, Tensor) \
            else Tensor(np.asarray(transitions, np.float32))
        self._include = include_bos_eos_tag

    def forward(self, potentials, lengths):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self._include)
from .datasets import (UCIHousing, Imdb, Imikolov, Conll05st, Movielens,  # noqa: F401,E402
                       WMT14, WMT16)
