"""Weight-only quantization for LLM serving: counterpart of
``paddle_tpu/quantization/weight_only.py`` (reference:
python/paddle/nn/quant/quantized_linear.py weight_quantize /
weight_only_linear over phi weight_only_linear_kernel).

int8 weights live in device memory at half (int4: a quarter of) the bf16
bytes.  On the card, no-grad calls with block-divisible shapes run K8
(:func:`~paddle_tpu_torch.ops.quant_matmul.quant_matmul`), which
dequantizes each tile where it is used, so the bf16 copy of the weight is
never materialised.  Every other call — any CPU call, a call that needs a
gradient, a shape K8 does not take, or ``FLAGS_weight_only_use_kernel``
off — runs the reference's own second path, the dequant formulation
``(x @ W.to(x.dtype)) * scale``, in torch ops.  That path is chosen before
anything runs; once K8 is chosen it launches or raises.

Each function takes torch tensors and gives torch tensors; given port
Tensors (the reference's surface) it runs through the op dispatch and
gives Tensors."""
from __future__ import annotations

import functools
import math

import torch

from ..core.flags import flag
from ..ops import quant_matmul as qmm

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear"]

def _takes_tensors(fn):
    """Port Tensors in any argument: run ``fn`` through ``apply_op`` on
    their torch buffers and give Tensors; torch tensors go straight in."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        from ..core.tensor import Tensor
        keys = [k for k, v in kwargs.items() if isinstance(v, Tensor)]
        if not keys and not any(isinstance(a, Tensor) for a in args):
            return fn(*args, **kwargs)
        from ..core.dispatch import apply_op
        n = len(args)

        def f(*arrays):
            return fn(*arrays[:n], **{**kwargs, **dict(zip(keys, arrays[n:]))})
        return apply_op(fn.__name__, f, *args, *(kwargs[k] for k in keys))
    return call


_OUT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "float16": torch.float16}


@_takes_tensors
def weight_quantize(x, algo="weight_only_int8", group_size=-1):
    """w [in, out] -> (qw int8 [in, out] or packed int4 [in // 2, out],
    scale float32 [out]), per output channel, computed in w's dtype as the
    reference computes it.

    algo: weight_only_int8 | weight_only_int4 (packed two nibbles a byte:
    row 2i in the low nibble, row 2i + 1 in the high one)."""
    if algo not in ("weight_only_int8", "weight_only_int4"):
        raise ValueError(f"unsupported algo {algo}")
    bits = 8 if algo.endswith("int8") else 4
    qmax = float(2 ** (bits - 1) - 1)
    s = torch.clamp(x.abs().amax(0) / qmax, min=1e-9)
    q = torch.clamp(torch.round(x / s[None, :]), -qmax, qmax).to(torch.int8)
    if bits == 4:
        if q.shape[0] % 2:
            raise ValueError("int4 packing needs even in_features")
        lo = q[0::2] & 0xF
        hi = (q[1::2] & 0xF) << 4
        q = (lo | hi).to(torch.int8)            # [in // 2, out]
    return q, s.to(torch.float32)


@_takes_tensors
def weight_dequantize(x, scale, algo="weight_only_int8", out_dtype="float32"):
    """The integer weight (unpacked for int4) times its scale, in
    ``out_dtype``."""
    q = qmm.unpack_int4(x) if algo.endswith("int4") else x
    dt = _OUT_DTYPES.get(out_dtype, out_dtype)
    return (q.to(torch.float32) * scale[None, :]).to(dt)


def _on_card(x):
    """Whether ``x`` lies on the card (the reference asks for a TPU)."""
    return x.device.type == "cuda"


@_takes_tensors
def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1):
    """y = x @ dequant(weight) + bias (reference: quantized_linear.py:33).

    On the card, no-grad calls with block-divisible shapes run K8, whose
    bf16 weight never exists in device memory; other calls take the
    dequant formulation (see the module note)."""
    is4 = str(weight_dtype) == "int4"
    K_in = weight.shape[0] * (2 if is4 else 1)
    N = weight.shape[1]
    M = math.prod(x.shape[:-1]) if x.dim() > 1 else 1
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, weight, weight_scale))
    use_kernel = (flag("weight_only_use_kernel")
                  and _on_card(x)
                  and not needs_grad
                  and x.shape[-1] == K_in
                  and qmm.supported(M, K_in, N, int4=is4))
    if use_kernel:
        s = (weight_scale if weight_scale.dtype == torch.float32
             else weight_scale.float())
        y = qmm.quant_matmul(x.reshape(-1, x.shape[-1]), weight, s,
                             int4=is4)
        y = y.reshape(*x.shape[:-1], N)
    else:
        wq = qmm.unpack_int4(weight) if is4 else weight
        y = (x @ wq.to(x.dtype)) * weight_scale.to(x.dtype)
    return y + bias.to(x.dtype) if bias is not None else y
