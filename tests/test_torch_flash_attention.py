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


@pytest.mark.parametrize("D", sorted(tfa.FWD_PLAN))
def test_forward_tile_plan_fits_the_card_and_every_supported_shape(D):
    """The bf16 forward's tiles at each head_dim up to 256, as the wrapper
    records them (``chip_smoke.py`` holds the card's compiled plan to the
    same numbers): two consumer warpgroups of 64 q rows, wgmma widths (a
    multiple of 8 up to 256) for the keys of a tile, at least two ring
    stages, and shared memory within what a Hopper block may use.  Every
    sequence length that ``supported()`` accepts (a multiple of 128)
    divides into q and k tiles."""
    plan = tfa.fwd_plan(D)
    bq, bk, stages = plan["bq"], plan["bk"], plan["stages"]
    assert (bq, bk, stages) == tfa.FWD_PLAN[D]
    assert bq % 64 == 0 and bq // 64 == 2
    assert bk % 8 == 0 and bk <= 256 and stages >= 2
    assert plan["threads"] == 384
    tiles = 2 * bq * D + stages * 2 * 2 * bk * D
    assert plan["smem"] == 1024 + tiles + 128
    assert plan["smem"] <= tfa.SMEM_PER_BLOCK == 232448
    for S in range(128, 8193, 128):
        assert supported((1, S, 2, D), (1, S, 1, D))
        assert S % bq == 0 and S % bk == 0


@pytest.mark.parametrize("D", sorted(tfa.BWD_PLAN))
def test_backward_tile_plan_fits_the_card_and_every_supported_shape(D):
    """The bf16 backward's tiles at each head_dim up to 256, as the wrapper
    records them (``chip_smoke.py`` holds the card's compiled plans to the
    same numbers).  K2: two consumer warpgroups of 64 q rows over a ring of
    K / V tiles whose width is a wgmma width (a multiple of 8 up to 256)
    and a whole number of 16-key steps.  K3: a ring of q tiles of such a
    width over the keys of a block, two warpgroups of 64 keys each, or,
    split, both on the same 64 keys where dK and dV together (D f32
    registers a thread) would not fit beside the score tiles.  Shared
    memory within what a Hopper block may use; every sequence length that
    ``supported()`` accepts (a multiple of 128) divides into the tiles."""
    plan = tfa.bwd_plan(D)
    dq, dkv = plan["dq"], plan["dkv"]
    assert ((dq["bq"], dq["bk"], dq["stages"]),
            (dkv["bq"], dkv["bk"], dkv["stages"], dkv["q2"],
             dkv["split"])) == tfa.BWD_PLAN[D]
    assert dq["bq"] == 128 and dq["stages"] >= 2
    assert dq["bk"] % 16 == 0 and dq["bk"] <= 256
    assert dq["smem"] == (1024 + 2 * 2 * dq["bq"] * D
                          + dq["stages"] * 2 * 2 * dq["bk"] * D + 128)
    assert dkv["bq"] % 16 == 0 and dkv["bq"] <= 256
    assert dkv["split"] == int(D > 128)
    assert dkv["bk"] == (64 if dkv["split"] else 128)
    assert (D // 2 if dkv["split"] else D) <= 128
    assert dkv["stages"] >= 2 and dkv["q2"] >= 1
    tile = 2 * dkv["bq"] * D
    assert dkv["smem"] == (1024 + 2 * 2 * dkv["bk"] * D
                           + dkv["stages"] * (2 * tile + 2 * 4 * dkv["bq"])
                           + dkv["q2"] * tile + 128)
    for p in (dq, dkv):
        assert p["threads"] == 384
        assert p["smem"] <= tfa.SMEM_PER_BLOCK == 232448
    for S in range(128, 8193, 128):
        assert supported((1, S, 2, D), (1, S, 1, D))
        assert S % dq["bq"] == 0 and S % dq["bk"] == 0
        assert S % dkv["bq"] == 0 and S % dkv["bk"] == 0


@pytest.mark.parametrize("D", sorted(tfa.BWD_PLAN_DIRECT))
def test_direct_backward_tile_plan_fits_the_card_and_every_supported_shape(
        D):
    """K4-dq and K4-dkv (the layout-direct backward) on the same bodies as
    K2 and K3, with K4's numerics, as the wrapper records their tiles
    (``chip_smoke.py`` holds the card's compiled plans to the same
    numbers).  K4-dq takes K2's tiles.  K4-dkv scores each q tile of its
    ring as it landed, so it has no q2 buffer, and keeps K3's tiles, ring
    and split (above head_dim 128 the two warpgroups hold dV and dK of the
    same 64 keys): its shared memory is K3's less the q2 buffers, within
    what a Hopper block may use.  Every sequence length that
    ``supported()`` accepts (a multiple of 128) divides into the tiles."""
    plan, k23 = tfa.bwd_plan(D, direct=True), tfa.bwd_plan(D)
    dq, dkv = plan["dq"], plan["dkv"]
    assert ((dq["bq"], dq["bk"], dq["stages"]),
            (dkv["bq"], dkv["bk"], dkv["stages"], dkv["q2"],
             dkv["split"])) == tfa.BWD_PLAN_DIRECT[D]
    assert dq == k23["dq"]
    assert dkv["q2"] == 0 and k23["dkv"]["q2"] >= 1
    assert {k: v for k, v in dkv.items() if k not in ("q2", "smem")} == {
        k: v for k, v in k23["dkv"].items() if k not in ("q2", "smem")}
    assert dkv["split"] == int(D > 128) and dkv["stages"] >= 2
    tile = 2 * dkv["bq"] * D
    assert dkv["smem"] == (1024 + 2 * 2 * dkv["bk"] * D
                           + dkv["stages"] * (2 * tile + 2 * 4 * dkv["bq"])
                           + 128)
    assert dkv["smem"] == k23["dkv"]["smem"] - k23["dkv"]["q2"] * tile
    for p in (dq, dkv):
        assert p["threads"] == 384
        assert p["smem"] <= tfa.SMEM_PER_BLOCK == 232448
    for S in range(128, 8193, 128):
        assert supported((1, S, 2, D), (1, S, 2, D))
        assert S % dq["bq"] == 0 and S % dq["bk"] == 0
        assert S % dkv["bq"] == 0 and S % dkv["bk"] == 0


def _strides_legal(t):
    """What a TMA tensor map needs of a tensor the kernels read in place:
    a 16-byte aligned base, a unit last stride, every other stride of a
    dimension longer than 1 a positive multiple of 16 bytes."""
    el = t.element_size()
    return (t.data_ptr() % 16 == 0 and t.stride(-1) == 1
            and all(n == 1 or (st > 0 and st * el % 16 == 0)
                    for n, st in zip(t.shape[:-1], t.stride()[:-1])))


@pytest.mark.parametrize("case", ["fused-qkv", "gqa-kv", "misaligned",
                                  "broadcast", "odd-row-stride"])
def test_strided_hands_the_kernels_tma_legal_strides(case):
    """``_strided`` passes q, k and v through untouched when their layout
    is legal for TMA (fused-qkv views with row stride 3 H D, GQA K / V) and
    copies them when it is not (a view one element off a 16-byte boundary,
    a broadcast head axis with stride 0, a row stride of 40 bytes)."""
    B, S, H, D = 2, 128, 4, 64
    base = torch.zeros(B * S * 3 * H * D + 8, dtype=torch.bfloat16)
    assert base.data_ptr() % 16 == 0
    if case == "fused-qkv":
        t = base[:B * S * 3 * H * D].view(B, S, 3, H, D)[:, :, 1]
        want_copy = False
    elif case == "gqa-kv":
        t = base[:B * S * 1 * D].view(B, S, 1, D)
        want_copy = False
    elif case == "misaligned":
        t = base[1:1 + B * S * H * D].view(B, S, H, D)
        want_copy = True
    elif case == "broadcast":
        t = base[:B * S * D].view(B, S, 1, D).expand(B, S, H, D)
        want_copy = True
    else:
        t = base[:B * S * 20].view(B, S, 20)[..., :16].unsqueeze(2)
        want_copy = True
    got = tfa._strided(t)
    assert (got.data_ptr() != t.data_ptr()) == want_copy
    assert _strides_legal(got)
    assert torch.equal(got, t)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("D", sorted(tfa.FWD_PLAN), ids=lambda d: f"d{d}")
def test_cuda_bf16_forward_matches_plain_versions(cuda_device, D):
    """On the card, the bf16 forward (K1 on GQA, K4 on MHA) against its
    plain versions at 2e-2, bitwise the same on a second run, causal over
    three q tiles and on q / k / v views of one fused projection; the
    compiled tile plan is the recorded one."""
    for direct in (False, True):
        got = tfa.compiled_fwd_plan(D, direct)
        assert {k: got[k] for k in tfa.fwd_plan(D)} == tfa.fwd_plan(D)
        assert got["local_bytes"] == 0
    q, k, v, _ = _inputs(5, 2, 384, 4, 2, D)
    qkv = np.random.RandomState(6).randn(2, 256, 3, 4, D).astype(np.float32)
    fused = torch.from_numpy(qkv).to(cuda_device).bfloat16().unbind(2)
    for direct, args in ((False, (q, k, v)), (True, (q, q, q)),
                         (False, fused), (True, fused)):
        t = [x if torch.is_tensor(x) else
             torch.from_numpy(x).to(cuda_device).bfloat16() for x in args]
        s = 1.0 / np.sqrt(D)
        o, lse = tfa._launch_fwd(*t, True, s, direct)
        o2, lse2 = tfa._launch_fwd(*t, True, s, direct)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        ref = tfa.bshd_fwd_ref if direct else flash_fwd_ref
        ro, rl = ref(*t, True, s)
        torch.testing.assert_close(o.float(), ro.float(), rtol=0, atol=2e-2)
        torch.testing.assert_close(lse, rl, rtol=0, atol=2e-2)


def check_card_backward(dev, D, direct):
    """On the card, the bf16 backward (K2 / K3 against ``flash_bwd_ref``,
    or with ``direct`` K4-dq / K4-dkv against ``bshd_bwd_ref``) at 2e-2 of
    each gradient's largest reference magnitude: MHA (and GQA 4:1 where
    not ``direct``, K4 being MHA only) causal over three q tiles, not
    causal with Sk != Sq, and on q / k / v views of one fused projection.
    Each case runs twice through the backward launchers on the plain
    forward's o and lse, and twice through ``flash_attention_bshd``'s
    autograd (whose backward runs on a thread of its own), each pair
    bitwise the same; each autograd run launches the route's three bodies
    once each and no others, and its gradients are bitwise those of the
    launchers on the kernel forward's o and lse.  The compiled tile plans
    are the recorded ones, with no spills.  The caller sets
    ``FLAGS_flash_layout_direct`` to ``direct``."""
    got, want = tfa.compiled_bwd_plan(D, direct), tfa.bwd_plan(D, direct)
    for role in ("dq", "dkv"):
        assert {k: got[role][k] for k in want[role]} == want[role]
        assert got[role]["local_bytes"] == 0
    s = 1.0 / np.sqrt(D)
    rng = np.random.RandomState(8 if direct else 7)

    def card(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev).bfloat16()
    qkv = card(2, 256, 3, 4, D)
    cases = [((card(2, 384, 4, D), card(2, 384, 4, D), card(2, 384, 4, D)),
              True)]
    if not direct:
        cases.append(((card(2, 384, 8, D), card(2, 384, 2, D),
                       card(2, 384, 2, D)), True))
    H, Hk = (4, 4) if direct else (8, 2)
    cases += [((card(1, 256, H, D), card(1, 640, Hk, D), card(1, 640, Hk, D)),
               False),
              (None, True)]
    fwd_ref, bwd_ref = ((tfa.bshd_fwd_ref, tfa.bshd_bwd_ref) if direct
                        else (flash_fwd_ref, flash_bwd_ref))
    names = ("fwd", "dq", "dkv")
    counters = [f"launches_{'direct_' if d else ''}{n}"
                for d in (False, True) for n in names]
    expect = [int(d == direct) for d in (False, True) for _ in names]
    for ins, causal in cases:
        q, k, v = qkv.unbind(2) if ins is None else ins
        do = card(*q.shape)
        o, lse = fwd_ref(q, k, v, causal, s)
        want = bwd_ref(q, k, v, o, lse, do, causal, s)

        def launch(o, lse):
            dq, delta = tfa._launch_dq(q, k, v, o, lse, do, causal, s, direct)
            return (dq, *tfa._launch_dkv(q, k, v, o, lse, do, delta, causal,
                                         s, direct))
        launched, graded = [], []
        for _ in range(2):
            launched.append(launch(o, lse))
            chained = launch(*tfa._launch_fwd(q, k, v, causal, s, direct))
            before = [getattr(flash_attention_bshd, c) for c in counters]
            if ins is None:
                leaf = qkv.clone().requires_grad_()
                leaves = leaf.unbind(2)
            else:
                leaves = [t.clone().requires_grad_() for t in ins]
            flash_attention_bshd(*leaves, causal=causal).backward(do)
            torch.cuda.synchronize()
            assert [getattr(flash_attention_bshd, c) - b
                    for c, b in zip(counters, before)] == expect
            graded.append(leaf.grad.unbind(2) if ins is None
                          else [t.grad for t in leaves])
            assert all(torch.equal(a, b) for a, b in zip(graded[-1], chained))
        for runs in (launched, graded):
            assert all(torch.equal(a, b) for a, b in zip(*runs))
            for g, w in zip(runs[0], want):
                assert bool(torch.isfinite(g).all())
                scale = w.float().abs().max().item()
                torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                           atol=2e-2 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("D", sorted(tfa.BWD_PLAN), ids=lambda d: f"d{d}")
def test_cuda_bf16_backward_matches_plain_versions(cuda_device, D):
    """K2 and K3 on the card against ``flash_bwd_ref``, as
    ``check_card_backward`` sets out."""
    check_card_backward(cuda_device, D, direct=False)
