"""The PyTorch port's int8-page and multi-query paged attention (K6, K7,
K7q) on CPU tensors — their plain versions — and its ``quantize_kv``,
against the JAX package's Pallas kernels (interpret mode on CPU) and jnp
references, on the same seeded numpy inputs.

Tolerances: float32 atol 2e-5 against the jnp reference (both sides
dequantize and score in float32, summing in other orders) and 2e-3 against
the interpret-mode kernel, the reference's own bar (``test_kv_int8.py``,
``test_spec_decode.py``); bfloat16 atol 2e-2 (the JAX kernels round
dequantized int8 values to bf16 before the dots, the plain versions
dequantize in float32, and both round the output to bf16)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_multiquery,
    paged_attention_multiquery_ref, paged_attention_ref, quantize_kv)

# (B, P, page, KVH, H, D, S, Q, row-0 contexts): the reference's multi-query
# test shape, and the engine's head_dim 128 at a max_draft=4 verify width
# with one row whose last position runs past the table (60 + 7 > 4 * 16)
SHAPES = {
    "reference": (2, 9, 8, 2, 4, 16, 4, 3, (13, 22)),
    "d128_q8": (3, 13, 16, 2, 8, 128, 4, 8, (1, 40, 60)),
}
TOLS = {"float32": (2e-5, 2e-3), "bfloat16": (2e-2, 2e-2)}


def _inputs(shape, seed=0):
    B, P, page, KVH, H, D, S, Q, ctx = SHAPES[shape]
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((P, page, KVH, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, KVH, D)).astype(np.float32)
    bt = rng.permutation(P - 1)[:B * S].reshape(B, S).astype(np.int32)
    q = rng.standard_normal((B, Q, H, D)).astype(np.float32)
    return q, kp, vp, bt, np.asarray(ctx, np.int32)


def _quant(kp, vp):
    """int8 pages and scales from the JAX package's quantize_kv."""
    kq, ks = jpa.quantize_kv(jnp.asarray(kp))
    vq, vs = jpa.quantize_kv(jnp.asarray(vp))
    return [np.asarray(a) for a in (kq, vq, ks, vs)]


def _jax(fn, dtype, q, kp, vp, bt, cl, scales=None):
    dt = getattr(jnp, dtype)
    if scales is None:
        kp, vp, kw = jnp.asarray(kp, dt), jnp.asarray(vp, dt), {}
    else:
        kw = dict(k_scales=jnp.asarray(scales[0]),
                  v_scales=jnp.asarray(scales[1]))
    out = fn(jnp.asarray(q, dt), kp, vp, jnp.asarray(bt), jnp.asarray(cl),
             **kw)
    return np.asarray(out.astype(jnp.float32))


def _torch(fn, dtype, q, kp, vp, bt, cl, scales=None):
    dt = getattr(torch, dtype)
    if scales is None:
        kp, vp, kw = (torch.from_numpy(kp).to(dt),
                      torch.from_numpy(vp).to(dt), {})
    else:
        kp, vp = torch.from_numpy(kp), torch.from_numpy(vp)
        kw = dict(k_scales=torch.from_numpy(scales[0]),
                  v_scales=torch.from_numpy(scales[1]))
    out = fn(torch.from_numpy(q).to(dt), kp, vp, torch.from_numpy(bt),
             torch.from_numpy(cl), **kw)
    assert out.dtype == dt
    return out.float().numpy()


def test_quantize_kv_matches_jax():
    x = np.random.default_rng(3).standard_normal((6, 5, 4, 32)).astype(
        np.float32) * 3.0
    x[0, 0, 0] = 0.0                      # an all-zero row: scale floor 1e-8
    qv, s = quantize_kv(torch.from_numpy(x))
    jq, js = jpa.quantize_kv(jnp.asarray(x))
    assert qv.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == (6, 5, 4)
    np.testing.assert_array_equal(qv.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-7)


def test_quantize_roundtrip_error_bounded():
    """Symmetric int8: |dequant(quant(x)) - x| <= scale / 2 per element
    (the reference's ``test_quantize_roundtrip_error_bounded``)."""
    x = torch.from_numpy(np.random.RandomState(0).randn(5, 4, 32).astype(
        np.float32)) * 3.0
    qv, s = quantize_kv(x)
    err = (qv.float() * s[..., None] - x).abs()
    assert bool((err <= s[..., None] / 2 + 1e-6).all())


@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_int8_single_query_matches_jax_kernel_and_reference(shape, dtype):
    """K6's plain version: row 0 of each shape as decode queries."""
    q, kp, vp, bt, cl = _inputs(shape)
    kq, vq, ks, vs = _quant(kp, vp)
    q1 = np.ascontiguousarray(q[:, 0])
    before = paged_attention.launches_int8
    got = _torch(paged_attention, dtype, q1, kq, vq, bt, cl, (ks, vs))
    assert paged_attention.launches_int8 == before     # CPU never launches
    assert np.isfinite(got).all()
    tol_ref, tol_kernel = TOLS[dtype]
    np.testing.assert_allclose(
        got, _jax(jpa.paged_attention_ref, dtype, q1, kq, vq, bt, cl,
                  (ks, vs)), atol=tol_ref, rtol=0)
    np.testing.assert_allclose(
        got, _jax(jpa.paged_attention, dtype, q1, kq, vq, bt, cl, (ks, vs)),
        atol=tol_kernel, rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16_pages",
                                                      "int8_pages"])
@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_multiquery_matches_jax_kernel_and_reference(shape, dtype, quant):
    """K7's (pages in q's dtype) and K7q's (int8 pages) plain version; the
    d128_q8 shape holds a row whose horizon runs past its table, which
    both sides cap at S * page tokens."""
    q, kp, vp, bt, cl = _inputs(shape)
    scales = None
    if quant:
        kp, vp, ks, vs = _quant(kp, vp)
        scales = (ks, vs)
    counts = (paged_attention_multiquery.launches,
              paged_attention_multiquery.launches_int8)
    got = _torch(paged_attention_multiquery, dtype, q, kp, vp, bt, cl,
                 scales)
    assert counts == (paged_attention_multiquery.launches,
                      paged_attention_multiquery.launches_int8)
    assert got.shape == q.shape and np.isfinite(got).all()
    tol_ref, tol_kernel = TOLS[dtype]
    np.testing.assert_allclose(
        got, _jax(jpa.paged_attention_multiquery_ref, dtype, q, kp, vp, bt,
                  cl, scales), atol=tol_ref, rtol=0)
    np.testing.assert_allclose(
        got, _jax(jpa.paged_attention_multiquery, dtype, q, kp, vp, bt, cl,
                  scales), atol=tol_kernel, rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["f32_pages",
                                                      "int8_pages"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_row_j_equals_single_query_at_ctx_plus_j(shape, quant):
    """Row j of the multi-query version equals the single-query version at
    ctx + j — the causal-horizon contract verification rests on (the
    reference's ``test_rows_match_single_query_ref``)."""
    q, kp, vp, bt, cl = (torch.from_numpy(a) for a in _inputs(shape))
    kw = {}
    if quant:
        kp, ks = quantize_kv(kp)
        vp, vs = quantize_kv(vp)
        kw = dict(k_scales=ks, v_scales=vs)
    out = paged_attention_multiquery(q, kp, vp, bt, cl, **kw)
    for j in range(q.shape[1]):
        single = paged_attention(q[:, j].contiguous(), kp, vp, bt, cl + j,
                                 **kw)
        torch.testing.assert_close(out[:, j], single, rtol=1e-5, atol=1e-5)


def test_capped_horizon_matches_jax():
    """Every row of one sequence past its table (ctx + Q - 1 > S * page):
    the plain versions see S * page tokens at most, as the TPU kernels'
    (B, S) grid does."""
    q, kp, vp, bt, _ = _inputs("reference")
    cl = np.asarray([31, 40], np.int32)            # S * page = 32
    for fn, jfn in ((paged_attention_multiquery,
                     jpa.paged_attention_multiquery),
                    (paged_attention_multiquery_ref,
                     jpa.paged_attention_multiquery_ref)):
        got = _torch(fn, "float32", q, kp, vp, bt, cl)
        np.testing.assert_allclose(got, _jax(jfn, "float32", q, kp, vp, bt,
                                             cl), atol=2e-3, rtol=0)
    single = _torch(paged_attention, "float32", np.ascontiguousarray(q[:, 0]),
                    kp, vp, bt, cl)
    np.testing.assert_allclose(single, _jax(jpa.paged_attention, "float32",
                                            np.ascontiguousarray(q[:, 0]),
                                            kp, vp, bt, cl), atol=2e-3)
    # past the table, a longer context changes nothing
    q0 = np.ascontiguousarray(q[:, 0])
    np.testing.assert_array_equal(
        _torch(paged_attention_ref, "float32", q0, kp, vp, bt,
               np.asarray([33, 40], np.int32)),
        _torch(paged_attention_ref, "float32", q0, kp, vp, bt,
               np.asarray([32, 10 ** 6], np.int32)))


def test_pages_past_the_last_horizon_are_never_read():
    """Table entries past the last row's horizon may hold anything:
    out-of-range ids and pages full of NaN there change nothing."""
    q, kp, vp, bt, cl = _inputs("reference", seed=4)   # ctx 13, 22; Q 3
    args = [torch.from_numpy(a) for a in (q, kp, vp)]
    clean = paged_attention_multiquery(*args, torch.from_numpy(bt),
                                       torch.from_numpy(cl))
    bad = bt.copy()
    bad[0, 2:] = 10 ** 6          # 13 + 2 = 15 tokens: slots 0 and 1 live
    bad[1, 3:] = -5               # 22 + 2 = 24 tokens: slots 0..2 live
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[bt[0, 2:]] = np.nan
    vp2[bt[0, 2:]] = np.nan
    dirty = paged_attention_multiquery(
        torch.from_numpy(q), torch.from_numpy(kp2), torch.from_numpy(vp2),
        torch.from_numpy(bad), torch.from_numpy(cl))
    torch.testing.assert_close(dirty[0], clean[0], rtol=0, atol=0)


def _int8_inputs(case):
    q, kp, vp, bt, cl = (torch.from_numpy(a) for a in _inputs("d128_q8"))
    kp, ks = quantize_kv(kp)
    vp, vs = quantize_kv(vp)
    if case == "no_scales":
        ks = vs = None
    elif case == "one_scale":
        vs = None
    elif case == "float64_scales":
        ks = ks.double()
    elif case == "scales_with_d":
        ks = ks[..., None].expand(*ks.shape, 128).contiguous()
    elif case == "bf16_pages_with_scales":
        kp, vp = kp.bfloat16(), vp.bfloat16()
    elif case == "strided_scales":
        ks = ks.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "float16_q":
        q = q.half()
    return (q, kp, vp, bt, cl), dict(k_scales=ks, v_scales=vs)


@pytest.mark.parametrize("case,err", [
    ("no_scales", TypeError), ("one_scale", ValueError),
    ("float64_scales", TypeError), ("scales_with_d", ValueError),
    ("bf16_pages_with_scales", TypeError), ("strided_scales", ValueError),
    ("float16_q", TypeError)])
def test_int8_and_multiquery_input_checks_raise(case, err):
    """What K6 / K7 / K7q do not take raises before any launch (the checks
    the wrappers run on CUDA tensors, applied here to CPU ones)."""
    from paddle_tpu_torch.ops.paged_attention import _check
    args, kw = _int8_inputs("none")
    _check(*args, **kw)                          # the engine's inputs pass
    args, kw = _int8_inputs(case)
    with pytest.raises(err):
        _check(*args, **kw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_cuda_multiquery_kernels_match_plain_version(cuda_device, quant):
    """On the card, K7 / K7q and K6 against their plain versions at the
    d128_q8 shape (float32, TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, kp, vp, bt, cl = (torch.from_numpy(a).to(cuda_device)
                         for a in _inputs("d128_q8"))
    kw = {}
    if quant:
        kp, ks = quantize_kv(kp)
        vp, vs = quantize_kv(vp)
        kw = dict(k_scales=ks, v_scales=vs)
    out = paged_attention_multiquery(q, kp, vp, bt, cl, **kw)
    single = paged_attention(q[:, 0].contiguous(), kp, vp, bt, cl, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, paged_attention_multiquery_ref(q, kp, vp, bt, cl, **kw),
        rtol=0, atol=2e-5)
    torch.testing.assert_close(
        single, paged_attention_ref(q[:, 0].contiguous(), kp, vp, bt, cl,
                                    **kw), rtol=0, atol=2e-5)
