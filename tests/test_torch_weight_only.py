"""The port's weight-only quantization (``paddle_tpu_torch/quantization``,
``nn/quant``, ``ops/quant_matmul.py``) against the JAX package's, on the
CPU.  Both sides get the same numpy inputs.  ``weight_quantize`` is held
byte for byte; the dequant path at 1e-5 in float32; the plain twin of K8
against the Pallas kernel in interpret mode at 2e-2, the bar of
``tests/test_quantization.py``'s kernel test."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.nn.quant as jquant
from paddle_tpu.ops.pallas import quant_matmul as jqmm
import paddle_tpu_torch as tpt
import paddle_tpu_torch.nn.quant as tquant
from paddle_tpu_torch import quantization as tq
from paddle_tpu_torch.ops import quant_matmul as tqmm

ALGOS = ["weight_only_int8", "weight_only_int4"]


def _w(K, N, seed=0):
    return np.random.RandomState(seed).randn(K, N).astype(np.float32) * 0.1


def _j(t):
    return np.array(t.numpy())


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_quantize_is_byte_identical(algo, dtype):
    w = _w(64, 48)
    w[3, 5], w[10, 7] = -0.7, 0.9          # large of both signs in a column
    jq, js = jquant.weight_quantize(jpt.to_tensor(w).astype(dtype), algo=algo)
    tq_, ts = tquant.weight_quantize(torch.from_numpy(w).to(getattr(
        torch, dtype)), algo=algo)
    assert tq_.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq_.numpy(), _j(jq))
    np.testing.assert_array_equal(ts.numpy(), _j(js))


def test_int4_packing_puts_row_2i_low_and_2i_plus_1_high():
    """Negative values in both nibbles: -7 in the low one and -1 in the
    high one pack to 0xF9; unpacking gives them back, sign-extended."""
    w = np.zeros((4, 2), np.float32)
    w[:, 0] = [-7.0, -1.0, 3.0, 7.0]
    w[:, 1] = [7.0, -7.0, -4.0, 0.0]
    q, s = tquant.weight_quantize(torch.from_numpy(w),
                                  algo="weight_only_int4")
    jqw, _ = jquant.weight_quantize(jpt.to_tensor(w), algo="weight_only_int4")
    np.testing.assert_array_equal(q.numpy(), _j(jqw))
    assert q[0, 0].item() == np.int8(np.uint8(0xF9))
    np.testing.assert_array_equal(tqmm.unpack_int4(q).numpy(),
                                  np.round(w / s.numpy()).astype(np.int8))


@pytest.mark.parametrize("algo", ALGOS)
def test_weight_dequantize_matches(algo):
    w = _w(64, 32, 1)
    jq, js = jquant.weight_quantize(jpt.to_tensor(w), algo=algo)
    tq_, ts = tquant.weight_quantize(torch.from_numpy(w), algo=algo)
    for out in ("float32", "bfloat16"):
        want = _j(jquant.weight_dequantize(jq, js, algo=algo,
                                           out_dtype=out).astype("float32"))
        got = tquant.weight_dequantize(tq_, ts, algo=algo, out_dtype=out)
        assert got.dtype == getattr(torch, out)
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("lead,bias", [((5,), False), ((2, 3), True),
                                       ((), True)])
def test_weight_only_linear_matches_on_the_cpu(algo, lead, bias):
    """The dequant formulation both packages take on the CPU, with and
    without a bias and with leading dims, at 1e-5 in float32."""
    rng = np.random.RandomState(2)
    K, N = 256, 256
    w = _w(K, N, 3)
    x = rng.randn(*lead, K).astype(np.float32)
    b = rng.randn(N).astype(np.float32) if bias else None
    wd = "int4" if algo.endswith("int4") else "int8"
    jq, js = jquant.weight_quantize(jpt.to_tensor(w), algo=algo)
    tq_, ts = tquant.weight_quantize(torch.from_numpy(w), algo=algo)
    want = _j(jquant.weight_only_linear(
        jpt.to_tensor(x), jq, bias=None if b is None else jpt.to_tensor(b),
        weight_scale=js, weight_dtype=wd))
    before = (tqmm.quant_matmul.launches, tqmm.quant_matmul.launches_int4)
    got = tquant.weight_only_linear(
        torch.from_numpy(x), tq_, bias=None if b is None else
        torch.from_numpy(b), weight_scale=ts, weight_dtype=wd)
    assert tuple(got.shape) == (*lead, N) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (tqmm.quant_matmul.launches,
            tqmm.quant_matmul.launches_int4) == before


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("M,K,N", [(1, 256, 256), (8, 512, 256),
                                   (13, 256, 512)])
def test_plain_twin_matches_the_pallas_kernel(M, K, N, int4):
    algo = ALGOS[int4]
    rng = np.random.RandomState(M + K + N)
    x = (rng.randn(M, K) * 0.3).astype(np.float32)
    w = _w(K, N, M)
    jq, js = jquant.weight_quantize(jpt.to_tensor(w), algo=algo)
    for dt in ("float32", "bfloat16"):
        want = np.asarray(jqmm.quant_matmul(
            jnp.asarray(x).astype(dt), jnp.asarray(_j(jq)),
            jnp.asarray(_j(js)), int4=int4).astype(jnp.float32))
        got = tqmm.quant_matmul(torch.from_numpy(x).to(getattr(torch, dt)),
                                torch.from_numpy(_j(jq)),
                                torch.from_numpy(_j(js)), int4=int4)
        assert got.dtype == getattr(torch, dt) and tuple(got.shape) == (M, N)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                                   atol=2e-2)


def test_the_reference_errors():
    with pytest.raises(ValueError, match="even in_features"):
        tquant.weight_quantize(torch.zeros(3, 4), algo="weight_only_int4")
    with pytest.raises(ValueError, match="unsupported algo"):
        tquant.weight_quantize(torch.zeros(4, 4), algo="weight_only_int2")
    q = torch.zeros(256, 256, dtype=torch.int8)
    s = torch.ones(256)
    with pytest.raises(ValueError, match="weight K 256 != x K 512"):
        tqmm.quant_matmul(torch.zeros(8, 512), q, s)
    with pytest.raises(ValueError, match="weight K 512 != x K 256"):
        tqmm.quant_matmul(torch.zeros(8, 256), q, s, int4=True)
    with pytest.raises(ValueError, match="shapes must divide blocks"):
        tqmm.quant_matmul(torch.zeros(8, 128), q[:128], s)
    with pytest.raises(ValueError, match="weight K"):
        jqmm.quant_matmul(jnp.zeros((8, 512)), jnp.zeros((256, 256),
                                                         jnp.int8),
                          jnp.ones(256))


# clusters of 1, 2, 4, 7 and 8 blocks an H100 SXM (132 SMs) holds at once
# with one block an SM (cudaOccupancyMaxActiveClusters on the card)
H100_CLUSTERS = {1: 132, 2: 66, 4: 30, 7: 15, 8: 15}


@pytest.mark.parametrize("M,K,N,want", [
    (8, 4096, 4096, (64, 2, 1)), (8, 4096, 1024, (128, 8, 1)),
    (8, 4096, 14336, (128, 1, 1)), (8, 14336, 4096, (64, 2, 1)),
    (1, 4096, 4096, (64, 2, 1)), (13, 4096, 1024, (128, 8, 2)),
    (300, 4096, 4096, (128, 1, 4)), (8, 256, 256, (64, 1, 1))])
def test_launch_plan_fills_the_card(M, K, N, want):
    """The bf16 body's launch plan (strip columns, splits of K, batch
    tiles) for the Llama-3-8B decode projections on an H100: the most
    blocks, one an SM, whose clusters the card holds at once (so there is
    no second wave); splits a divisor of K / 256 and at most a portable
    cluster of 8.  q / o and down take 128 blocks in strips of 64, gate /
    up 112; k / v 64, since 16 clusters of 8 would be one more than the
    card holds."""
    got = tqmm.launch_plan(M, K, N, 132, lambda bn, mt, s: H100_CLUSTERS[s])
    assert got == want
    bn, splits, mt = got
    assert (K // 256) % splits == 0 and 1 <= splits <= tqmm.MAX_SPLITS
    tiles = N // bn * -(-M // (8 * mt))
    if M <= 32:
        assert tiles * splits <= 132 and tiles <= H100_CLUSTERS[splits]
    if M <= 32 and K >= 4096:
        assert tiles * splits >= 64


@pytest.mark.parametrize("mt", [1, 2, 4])
@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("bn", [64, 128])
def test_body_plan_ring_takes_an_sm(bn, int4, mt):
    """Each bf16 body's ring: stages of 16 KB of raw weight bytes (8 KB for
    int4 strips of 64), k rows a stage dividing the 256 of a split; two
    pipelines for int4, one for int8; at least three stages each, so at
    least two stages of each pipeline are in flight; and a block's shared
    memory within the card's 227 KB but over half an SM's, so one block
    takes an SM."""
    plan = tqmm.body_plan(bn, int4, mt)
    wbytes = plan["ks"] // (2 if int4 else 1) * bn
    assert wbytes == (8192 if int4 and bn == 64 else 16384)
    assert 256 % plan["ks"] == 0
    assert plan["pipes"] == (2 if int4 else 1)
    assert 3 <= plan["stages"] <= tqmm.MAX_STAGES
    assert plan["smem"] <= tqmm.SMEM_PER_BLOCK
    assert 2 * (plan["smem"] + 1024) > 233472


def test_supported_and_the_public_names():
    assert tquant.weight_only_linear is tq.weight_only_linear
    assert tquant.weight_quantize is tq.weight_quantize
    assert tquant.weight_dequantize is tq.weight_dequantize
    for M, K, N in ((8, 4096, 1024), (1, 256, 512), (8, 384, 256),
                    (8, 256, 320)):
        assert tqmm.supported(M, K, N) == jqmm.supported(M, K, N)
    assert tpt.get_flags("weight_only_use_kernel") == {
        "FLAGS_weight_only_use_kernel": True}


def test_route_on_the_card_picks_k8_only_without_grad(monkeypatch):
    """With CPU tensors taken for the card's, no-grad calls reach
    ``quant_matmul``; a call that needs a gradient, a shape K8 does not
    take, or the flag off takes the dequant formulation."""
    seen = []

    def fake(x, qw, scale, *, int4=False):
        seen.append((tuple(x.shape), int4))
        return tqmm.quant_matmul_ref(x, qw, scale, int4=int4)

    monkeypatch.setattr(tqmm, "quant_matmul", fake)
    monkeypatch.setattr(tq.weight_only, "_on_card", lambda x: True)
    w = torch.from_numpy(_w(256, 256))
    q, s = tquant.weight_quantize(w)
    q4, s4 = tquant.weight_quantize(w, algo="weight_only_int4")
    x = torch.randn(2, 4, 256)
    with torch.no_grad():
        y = tquant.weight_only_linear(x, q, weight_scale=s)
        tquant.weight_only_linear(x[0], q4, weight_scale=s4,
                                  weight_dtype="int4")
    torch.testing.assert_close(
        y, (x @ q.float()) * s, rtol=1e-5, atol=1e-5)
    assert seen == [((8, 256), False), ((4, 256), True)]
    tquant.weight_only_linear(x.requires_grad_(), q, weight_scale=s)
    tquant.weight_only_linear(torch.randn(3, 128), q[:128], weight_scale=s)
    tpt.set_flags({"weight_only_use_kernel": False})
    try:
        tquant.weight_only_linear(x.detach(), q, weight_scale=s)
    finally:
        tpt.set_flags({"weight_only_use_kernel": True})
    assert len(seen) == 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 8, 13, 300])
@pytest.mark.parametrize("K,N", [(256, 256), (4096, 1024), (14336, 4096)])
@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
def test_cuda_k8_matches_the_plain_twin(cuda_device, int4, K, N, M):
    """K8 on the card against ``quant_matmul_ref``: bf16 x within 2e-2 and
    f32 x within 1e-5 of the largest reference magnitude (both sum in f32,
    in other orders; bf16 also rounds y once), and a second launch bitwise
    the same."""
    gen = torch.Generator(device=cuda_device).manual_seed(M + K + N)
    w = torch.randn(K, N, generator=gen, device=cuda_device) * 0.02
    q, s = tquant.weight_quantize(
        w, algo="weight_only_int4" if int4 else "weight_only_int8")
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        x = torch.randn(M, K, generator=gen, device=cuda_device).to(dt)
        y = tqmm.quant_matmul(x, q, s, int4=int4)
        again = tqmm.quant_matmul(x, q, s, int4=int4)
        want = tqmm.quant_matmul_ref(x, q, s, int4=int4).float()
        torch.cuda.synchronize()
        assert y.dtype == dt and tuple(y.shape) == (M, N)
        assert torch.isfinite(y).all()
        err = ((y.float() - want).abs().max() / want.abs().max()).item()
        assert err <= tol, f"{dt}: error {err} of the largest over {tol}"
        assert torch.equal(y, again), f"{dt}: a second launch differs"
