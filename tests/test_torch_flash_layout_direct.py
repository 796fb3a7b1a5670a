"""The port's layout-direct flash path (K4, ``FLAGS_flash_layout_direct``)
against the JAX package's, on the CPU.

The JAX kernels (``_bshd_fwd`` / ``_bshd_bwd``) run in interpret mode; the
port's wrapper takes K4's plain twins on CPU tensors — the arithmetic of
the CUDA bodies, which ``chip_smoke.py`` holds against these twins on the
card.  Both sides get the same numpy inputs.  Tolerances: float32 at 2e-5
forward and 5e-4 for gradients; bfloat16 at 2e-2 (gradients at 2e-2 of the
largest reference magnitude, since they scale with the inputs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops.flash_attention import (bshd_bwd_ref, bshd_fwd_ref,
                                                  flash_attention_bshd)

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(seed, B, S, H, D, mul=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, S, H, D) * mul).astype(np.float32)
            for _ in range(4)]


def _close(got, want, dt, grad=False):
    got = got.detach().float().numpy()
    if dt == "f32":
        np.testing.assert_allclose(got, want, atol=5e-4 if grad else 2e-5,
                                   rtol=0)
    else:
        scale = float(np.abs(want).max()) if grad else 1.0
        np.testing.assert_allclose(got, want, atol=2e-2 * scale, rtol=0)


@pytest.fixture
def layout_direct():
    """FLAGS_flash_layout_direct on in both packages, restored after."""
    jpt.set_flags({"FLAGS_flash_layout_direct": True})
    tpt.set_flags({"FLAGS_flash_layout_direct": True})
    try:
        yield
    finally:
        jpt.set_flags({"FLAGS_flash_layout_direct": False})
        tpt.set_flags({"FLAGS_flash_layout_direct": False})


# (S, D, causal, H, dtype): D 64, 256, 320 and 512, causal and not, f32 and
# bf16
CASES = [(128, 64, True, 2, "f32"), (256, 64, False, 2, "f32"),
         (128, 256, True, 2, "f32"), (128, 256, False, 1, "f32"),
         (256, 64, True, 2, "bf16"), (128, 256, False, 2, "bf16"),
         (128, 320, True, 2, "f32"), (128, 512, False, 1, "f32"),
         (128, 512, True, 2, "bf16")]


@pytest.mark.parametrize("S,D,causal,H,dt", CASES)
def test_plain_twins_match_the_jax_bshd_kernels(S, D, causal, H, dt):
    B = 2
    q, k, v, do = _inputs(S + D + H, B, S, H, D)
    scale = 1.0 / np.sqrt(D)
    bq, bk, hb = jfa._bshd_config(B, S, S, H, D, JDT[dt])
    jq, jk, jv, jdo = (jnp.asarray(x).astype(JDT[dt]) for x in (q, k, v, do))
    o_j, lse_j = jfa._bshd_fwd(jq, jk, jv, scale, causal, bq, bk, hb)
    grads_j = jfa._bshd_bwd(jq, jk, jv, o_j, lse_j, jdo, scale, causal, bq,
                            bk, hb)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(TDT[dt]) for x in (q, k, v, do))
    o, lse = bshd_fwd_ref(tq, tk, tv, causal)
    assert o.dtype == TDT[dt] and tuple(lse.shape) == (B * H, S)
    _close(o, np.asarray(o_j.astype(jnp.float32)), dt)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j[..., 0]),
                               atol=2e-5 if dt == "f32" else 2e-2, rtol=0)
    grads = bshd_bwd_ref(tq, tk, tv, o, lse, tdo, causal)
    for g, gj in zip(grads, grads_j):
        assert g.dtype == TDT[dt]
        _close(g, np.asarray(gj.astype(jnp.float32)), dt, grad=True)


@pytest.mark.parametrize("dt,causal,D", [("f32", True, 64),
                                         ("f32", False, 256),
                                         ("bf16", True, 64)])
def test_autograd_with_the_flag_matches_jax_grad(layout_direct, dt, causal,
                                                 D):
    """``flash_attention_bshd`` with the flag, forward and autograd,
    against the JAX function with the flag and ``jax.grad``."""
    B, S, H = 2, 128, 2
    q, k, v, w = _inputs(5, B, S, H, D)

    def jloss(q, k, v):
        o = jfa.flash_attention_bshd(q, k, v, causal=causal)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(w))

    jargs = [jnp.asarray(x).astype(JDT[dt]) for x in (q, k, v)]
    want_o = np.asarray(jfa.flash_attention_bshd(*jargs, causal=causal)
                        .astype(jnp.float32))
    want = jax.grad(jloss, argnums=(0, 1, 2))(*jargs)
    ts = [torch.from_numpy(x).to(TDT[dt]).requires_grad_() for x in (q, k, v)]
    o = flash_attention_bshd(*ts, causal=causal)
    (o.float() * torch.from_numpy(w)).sum().backward()
    _close(o, want_o, dt)
    for t, g in zip(ts, want):
        _close(t.grad, np.asarray(g.astype(jnp.float32)), dt, grad=True)


def test_layout_direct_bshd_path_matches_reference():
    """The reference's own test (``tests/test_pallas_kernels.py``) on the
    port: with the flag, the forward and gradients match the default path
    at 1e-4 / 1e-3."""
    rng = np.random.RandomState(7)
    B, S, H, D = 2, 128, 4, 64
    q, k, v = (torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32)
                                * 0.3) for _ in range(3))

    def run():
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        o = flash_attention_bshd(*ts, causal=True)
        (o.float() ** 2).sum().backward()
        return o.detach(), [t.grad for t in ts]

    o_ref, g_ref = run()
    tpt.set_flags({"FLAGS_flash_layout_direct": True})
    try:
        assert tfa._bshd_config(B, S, S, H, D, q.dtype) is not None
        o_new, g_new = run()
    finally:
        tpt.set_flags({"FLAGS_flash_layout_direct": False})
    np.testing.assert_allclose(o_new.numpy(), o_ref.numpy(), rtol=1e-4,
                               atol=1e-4)
    for a, b in zip(g_new, g_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_bshd_config_matches_jax(dt):
    for B in (1, 16):
        for S in (128, 256, 384, 512, 1024, 2048, 100):
            for Sk in (S, 128, 512):
                for H in (1, 4, 12, 32):
                    for D in (64, 128, 256):
                        got = tfa._bshd_config(B, S, Sk, H, D, TDT[dt])
                        assert got == jfa._bshd_config(B, S, Sk, H, D,
                                                       JDT[dt])
    # the GPT-2 bench geometry takes K4 with the flag
    assert tfa._bshd_config(16, 1024, 1024, 12, 64, torch.bfloat16) == (
        256, 256, 12)


def _record_path(monkeypatch):
    """Send CPU tensors down the card's path, with launchers that record
    which bodies (K1-K3 or K4) were asked for and run the matching twins."""
    seen = []

    def fwd(q, k, v, causal, s, direct=False):
        seen.append(("fwd", direct))
        ref = tfa.bshd_fwd_ref if direct else tfa.flash_fwd_ref
        return ref(q, k, v, causal, s)

    def dq(q, k, v, o, lse, do, causal, s, direct=False):
        seen.append(("dq", direct))
        ref = tfa.bshd_bwd_ref if direct else tfa.flash_bwd_ref
        return ref(q, k, v, o, lse, do, causal, s)[0], None

    def dkv(q, k, v, o, lse, do, delta, causal, s, direct=False):
        seen.append(("dkv", direct))
        ref = tfa.bshd_bwd_ref if direct else tfa.flash_bwd_ref
        return ref(q, k, v, o, lse, do, causal, s)[1:]

    monkeypatch.setattr(tfa, "_device_path", lambda t, name: "cuda")
    monkeypatch.setattr(tfa, "_launch_fwd", fwd)
    monkeypatch.setattr(tfa, "_launch_dq", dq)
    monkeypatch.setattr(tfa, "_launch_dkv", dkv)
    return seen


@pytest.mark.parametrize("flag_on,Hk,S,direct", [
    (True, 4, 128, True),           # MHA with the flag: K4
    (True, 2, 128, False),          # GQA with the flag: K1-K3
    (False, 4, 128, False),         # MHA without it: K1-K3
    (True, 4, 100, False),          # no _bshd_config tiles: K1-K3's check
])
def test_routing(monkeypatch, flag_on, Hk, S, direct):
    """MHA with the flag reaches K4's bodies (forward, dq, dk / dv) and
    GQA with the flag, or any shape without it, reaches K1-K3's."""
    seen = _record_path(monkeypatch)
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(1, S, 4, 64).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(1, S, Hk, 64).astype(np.float32))
            for _ in range(2))
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    tpt.set_flags({"flash_layout_direct": flag_on})
    try:
        if S % 128:
            with pytest.raises(ValueError, match="divisible"):
                flash_attention_bshd(*ts, causal=True)
            assert seen == []
            return
        o = flash_attention_bshd(*ts, causal=True)
        o.sum().backward()
    finally:
        tpt.set_flags({"flash_layout_direct": False})
    assert seen == [("fwd", direct), ("dq", direct), ("dkv", direct)]
    ref = tfa.bshd_fwd_ref if direct else tfa.flash_fwd_ref
    torch.testing.assert_close(o, ref(q, k, v, True)[0])
