"""The port's flash attention (``paddle_tpu_torch/ops/flash_attention.py``)
against the JAX package's Pallas kernels, on the CPU.

The JAX kernels run in interpret mode (as ``tests/test_pallas_kernels.py``
runs them); the port's wrapper takes its plain versions on CPU tensors —
the same math as the CUDA kernels K1-K3, which ``chip_smoke.py`` holds
against these plain versions on the card.  Both sides get the same numpy
inputs.  Tolerances are the reference tests': float32 at 2e-5 forward and
5e-4 for gradients; bfloat16 at 2e-2 (gradients at 2e-2 of the largest
reference magnitude, since they scale with the inputs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops.flash_attention import (flash_attention_bshd,
                                                  flash_bwd_ref,
                                                  flash_fwd_ref, supported)

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(seed, B, S, H, Hk, D):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for shape in
            ((B, S, H, D), (B, S, Hk, D), (B, S, Hk, D), (B, S, H, D))]


def _to3(x, dt):
    """[B, S, h, D] numpy -> the JAX kernels' [B * h, S, D]."""
    B, S, h, D = x.shape
    return jnp.moveaxis(jnp.asarray(x).astype(JDT[dt]), 2, 1).reshape(
        B * h, S, D)


def _from3(x3, B, h):
    BH, S, D = x3.shape
    return np.asarray(jnp.moveaxis(x3.astype(jnp.float32).reshape(B, h, S, D),
                                   1, 2))


def _close(got, want, dt, grad=False):
    got = got.detach().float().numpy()
    if dt == "f32":
        np.testing.assert_allclose(got, want, atol=5e-4 if grad else 2e-5,
                                   rtol=0)
    else:
        scale = float(np.abs(want).max()) if grad else 1.0
        np.testing.assert_allclose(got, want, atol=2e-2 * scale, rtol=0)


# (S, D, causal, H, Hk, dtype): S 128 and 256, D 64, 128, 192, 256, 320
# and 512, causal and not, MHA and GQA 2:1 and 4:1, float32 and bfloat16
CASES = [(128, 64, True, 2, 2, "f32"), (256, 64, True, 4, 2, "f32"),
         (256, 128, False, 2, 2, "f32"), (128, 128, True, 4, 1, "f32"),
         (128, 64, False, 4, 1, "bf16"), (256, 128, True, 4, 2, "bf16"),
         (128, 192, True, 2, 1, "f32"), (128, 256, False, 2, 2, "f32"),
         (128, 192, False, 2, 2, "bf16"), (128, 256, True, 4, 2, "bf16"),
         (128, 320, True, 4, 2, "f32"), (128, 512, False, 2, 2, "f32"),
         (128, 512, True, 2, 1, "bf16")]


@pytest.mark.parametrize("S,D,causal,H,Hk,dt", CASES)
def test_plain_fwd_bwd_match_the_jax_kernels(S, D, causal, H, Hk, dt):
    B = 2
    q, k, v, do = _inputs(S + D + H, B, S, H, Hk, D)
    scale = 1.0 / np.sqrt(D)
    o3, lse3 = jfa._flash_fwd(_to3(q, dt), _to3(k, dt), _to3(v, dt), scale,
                              causal, H, Hk)
    dq3, dk3, dv3 = jfa._flash_bwd(_to3(q, dt), _to3(k, dt), _to3(v, dt), o3,
                                   lse3, _to3(do, dt), scale, causal, H, Hk)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(TDT[dt]) for x in (q, k, v, do))
    o, lse = flash_fwd_ref(tq, tk, tv, causal)
    assert o.dtype == TDT[dt] and lse.dtype == torch.float32
    assert tuple(lse.shape) == (B * H, S)
    _close(o, _from3(o3, B, H), dt)
    # the TPU kernel broadcasts the LSE over 128 lanes; the port keeps one
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse3[..., 0]),
                               atol=2e-5 if dt == "f32" else 2e-2, rtol=0)
    dq, dk, dv = flash_bwd_ref(tq, tk, tv, o, lse, tdo, causal)
    assert (dq.dtype, dk.dtype, dv.dtype) == (TDT[dt],) * 3
    _close(dq, _from3(dq3, B, H), dt, grad=True)
    _close(dk, _from3(dk3, B, Hk), dt, grad=True)
    _close(dv, _from3(dv3, B, Hk), dt, grad=True)


@pytest.mark.parametrize("dt,causal,Hk", [("f32", True, 1), ("f32", False, 2),
                                          ("bf16", True, 2)])
def test_autograd_matches_jax_grad(dt, causal, Hk):
    """``flash_attention_bshd`` forward and backward (its autograd Function
    on CPU tensors) against ``jax.grad`` of the JAX function."""
    B, S, H, D = 2, 128, 4, 64
    q, k, v, w = _inputs(7, B, S, H, Hk, D)

    def jloss(q, k, v):
        o = jfa.flash_attention_bshd(q, k, v, causal=causal)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(w))

    jargs = [jnp.asarray(x).astype(JDT[dt]) for x in (q, k, v)]
    want_o = np.asarray(jfa.flash_attention_bshd(*jargs, causal=causal)
                        .astype(jnp.float32))
    want = jax.grad(jloss, argnums=(0, 1, 2))(*jargs)
    ts = [torch.from_numpy(x).to(TDT[dt]).requires_grad_() for x in (q, k, v)]
    before = (flash_attention_bshd.launches_fwd,
              flash_attention_bshd.launches_dq,
              flash_attention_bshd.launches_dkv)
    o = flash_attention_bshd(*ts, causal=causal)
    (o.float() * torch.from_numpy(w)).sum().backward()
    _close(o, want_o, dt)
    for t, g in zip(ts, want):
        _close(t.grad, np.asarray(g.astype(jnp.float32)), dt, grad=True)
    # CPU tensors never launch a kernel
    assert (flash_attention_bshd.launches_fwd,
            flash_attention_bshd.launches_dq,
            flash_attention_bshd.launches_dkv) == before


def test_strided_qkv_views_take_the_same_path():
    """GPT-2 splits one [B, S, 3, H, D] projection into q / k / v views
    (row stride 3 H D); the wrapper reads them as they are."""
    rng = np.random.RandomState(3)
    qkv = torch.from_numpy(rng.randn(1, 128, 3, 2, 64).astype(np.float32))
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    got = flash_attention_bshd(q, k, v, causal=True)
    want = flash_attention_bshd(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_rejects_non_divisible_seq_and_head_dim():
    q = torch.zeros(1, 100, 2, 64)
    with pytest.raises(ValueError, match="divisible"):
        flash_attention_bshd(q, q, q)
    with pytest.raises(ValueError, match="head_dim % 64"):
        tfa._check_divisible(128, 128, 96)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention_bshd(torch.zeros(1, 128, 4, 64),
                             torch.zeros(1, 128, 3, 64),
                             torch.zeros(1, 128, 3, 64))


@pytest.mark.parametrize("q_shape,kv_shape", [
    ((1, 256, 8, 64), None), ((1, 256, 8, 128), (1, 256, 8, 128)),
    ((1, 100, 8, 128), None), ((1, 256, 8, 100), None),
    ((1, 256, 8, 64), (1, 100, 8, 64)), ((1, 256, 8, 64), (1, 256, 3, 64)),
    ((1, 256, 8, 192), None), ((1, 256, 8, 256), (1, 256, 2, 256))])
def test_supported_agrees_with_jax(q_shape, kv_shape):
    """The reference test's shapes, and head dims 192 and 256, which the
    reference's predicate also takes."""
    assert supported(q_shape, kv_shape) == jfa.supported(q_shape, kv_shape)


def test_kernels_refuse_head_dims_they_lack(monkeypatch):
    """head_dim 576 passes the dispatch predicate, as in the reference; CPU
    tensors take the plain versions (matching the JAX kernels), and on the
    card's path the wrapper refuses it before any launch, since the CUDA
    kernels are instantiated for every head_dim % 64 == 0 up to 512.  Those
    eight, 320, 384 and 512 among them, pass the wrapper's check and reach
    the launcher."""
    B, S, H, Hk, D = 1, 128, 2, 1, 576
    q, k, v, do = _inputs(11, B, S, H, Hk, D)
    assert supported(q.shape, k.shape)
    o3, _ = jfa._flash_fwd(_to3(q, "f32"), _to3(k, "f32"), _to3(v, "f32"),
                           1.0 / np.sqrt(D), True, H, Hk)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    _close(flash_attention_bshd(tq, tk, tv), _from3(o3, B, H), "f32")
    before = flash_attention_bshd.launches_fwd
    monkeypatch.setattr(tfa, "_device_path", lambda t, name: "cuda")
    with pytest.raises(ValueError, match="instantiated for head_dim"):
        flash_attention_bshd(tq, tk, tv)
    assert flash_attention_bshd.launches_fwd == before
    reached = []
    monkeypatch.setattr(tfa, "_launch_fwd", lambda q, *a: reached.append(
        q.shape[-1]) or tfa.flash_fwd_ref(q, *a[:3]))
    dims = (64, 128, 192, 256, 320, 384, 448, 512)
    for d in dims:
        x = torch.zeros(1, 128, 2, d)
        flash_attention_bshd(x, x, x)
    assert reached == list(dims)
