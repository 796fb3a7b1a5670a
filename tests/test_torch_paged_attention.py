"""The PyTorch port's paged attention on CPU tensors (its plain version)
against the JAX package's Pallas kernel (interpret mode on CPU) and its jnp
reference, on the same seeded numpy inputs.

Tolerances: float32 atol 2e-5, the reference kernel test's own bar (the two
sides sum in different orders); bfloat16 atol 2e-2 (both sides round the
output to bf16, one bf16 ulp near 1 is 7.8e-3)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.paged_attention import (
    paged_attention as jax_paged_attention,
    paged_attention_ref as jax_paged_attention_ref)
from paddle_tpu_torch.ops.paged_attention import (paged_attention,
                                                  paged_attention_ref)

B, H, KVH, D, PAGE, S, P = 4, 8, 2, 128, 16, 4, 33
TRASH = P - 1
# the context lengths of the reference's page-boundary test, plus a row
# pointed at the trash page with ctx 1 (an inactive engine slot)
LENS = ([1, 16, 17, 1], [15, 32, 48, 1], [64, 64, 64, 1])


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(P, PAGE, KVH, D).astype(np.float32)
    vp = rng.randn(P, PAGE, KVH, D).astype(np.float32)
    bt = rng.choice(P - 1, (B, S), replace=False).astype(np.int32)
    bt[-1] = TRASH
    return q, kp, vp, bt


def _jax(fn, dtype, q, kp, vp, bt, cl):
    out = fn(jnp.asarray(q, dtype), jnp.asarray(kp, dtype),
             jnp.asarray(vp, dtype), jnp.asarray(bt), jnp.asarray(cl))
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("lens", LENS, ids=lambda l: "-".join(map(str, l)))
def test_plain_version_matches_jax_kernel_and_reference(dtype, atol, lens):
    q, kp, vp, bt = _inputs()
    cl = np.asarray(lens, np.int32)
    tdt = getattr(torch, dtype)
    before = paged_attention.launches
    out = paged_attention(torch.from_numpy(q).to(tdt),
                          torch.from_numpy(kp).to(tdt),
                          torch.from_numpy(vp).to(tdt),
                          torch.from_numpy(bt), torch.from_numpy(cl))
    assert paged_attention.launches == before    # CPU never launches
    assert out.dtype == tdt and tuple(out.shape) == (B, H, D)
    got = out.float().numpy()
    assert np.isfinite(got).all()
    jdt = getattr(jnp, dtype)
    for fn in (jax_paged_attention, jax_paged_attention_ref):
        np.testing.assert_allclose(got, _jax(fn, jdt, q, kp, vp, bt, cl),
                                   atol=atol, err_msg=fn.__name__)


def test_pages_past_context_are_never_read():
    """Table entries at or past ceil(ctx/page) may hold anything: garbage
    there (out-of-range page ids, pages full of NaN) changes nothing."""
    q, kp, vp, bt = _inputs(1)
    cl = np.asarray([1, 16, 17, 1], np.int32)
    args = [torch.from_numpy(a) for a in (q, kp, vp)]
    clean = paged_attention(*args, torch.from_numpy(bt), torch.from_numpy(cl))
    bad = bt.copy()
    bad[1, 1:] = 10 ** 6                 # ctx 16 -> only slot 0 is live
    bad[2, 2:] = -5                      # ctx 17 -> slots 0 and 1
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[bt[0, 1:]] = np.nan              # pages row 0 (ctx 1) never reaches
    vp2[bt[0, 1:]] = np.nan
    dirty = paged_attention(torch.from_numpy(q), torch.from_numpy(kp2),
                            torch.from_numpy(vp2), torch.from_numpy(bad),
                            torch.from_numpy(cl))
    torch.testing.assert_close(dirty[:3], clean[:3], rtol=0, atol=0)


def test_scale_defaults_to_inverse_sqrt_head_dim():
    q, kp, vp, bt = _inputs(2)
    t = [torch.from_numpy(a) for a in (q, kp, vp, bt)]
    cl = torch.tensor([5, 20, 33, 1], dtype=torch.int32)
    torch.testing.assert_close(paged_attention(*t, cl),
                               paged_attention(*t, cl, scale=D ** -0.5),
                               rtol=0, atol=0)
    ref = _jax(lambda *a: jax_paged_attention_ref(*a, scale=0.3), jnp.float32,
               q, kp, vp, bt, cl.numpy())
    np.testing.assert_allclose(paged_attention_ref(*t, cl, scale=0.3).numpy(),
                               ref, atol=2e-5)


def _bad_inputs(case):
    q, kp, vp, bt = (torch.from_numpy(a) for a in _inputs(4))
    cl = torch.tensor([5, 20, 33, 1], dtype=torch.int32)
    if case == "float16":
        q, kp, vp = q.half(), kp.half(), vp.half()
    elif case == "mixed_dtypes":
        kp = kp.bfloat16()
    elif case == "head_dim_96":
        q, kp, vp = q[..., :96], kp[..., :96].contiguous(), vp[..., :96]
        q, vp = q.contiguous(), vp.contiguous()
    elif case == "heads_not_a_multiple":
        q = q[:, :7].contiguous()
    elif case == "int64_tables":
        bt = bt.long()
    elif case == "strided_q":
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "batch_mismatch":
        cl = cl[:3]
    return q, kp, vp, bt, cl


@pytest.mark.parametrize("case,err", [
    ("float16", TypeError), ("mixed_dtypes", TypeError),
    ("head_dim_96", ValueError), ("heads_not_a_multiple", ValueError),
    ("int64_tables", TypeError), ("strided_q", ValueError),
    ("batch_mismatch", ValueError)])
def test_kernel_input_checks_raise(case, err):
    """What the kernel does not take raises before any launch (the checks
    the wrapper runs on CUDA tensors, applied here to CPU ones)."""
    from paddle_tpu_torch.ops.paged_attention import _check
    _check(*_bad_inputs("none"))                 # the engine's inputs pass
    with pytest.raises(err):
        _check(*_bad_inputs(case))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(cuda_device):
    """On the card, the kernel against its plain version at the engine's
    GQA shape (float32, TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, kp, vp, bt = _inputs(3)
    cl = torch.tensor([1, 16, 17, 64], dtype=torch.int32)
    t = [torch.from_numpy(a).to(cuda_device) for a in (q, kp, vp, bt)]
    before = paged_attention.launches
    out = paged_attention(*t, cl.to(cuda_device))
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = paged_attention_ref(*t, cl.to(cuda_device))
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-5)
