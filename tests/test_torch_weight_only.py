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


@pytest.mark.parametrize("M,K,N,want", [
    (8, 4096, 4096, 8), (8, 4096, 1024, 16), (8, 4096, 14336, 2),
    (8, 14336, 4096, 7), (1, 4096, 4096, 8), (300, 4096, 4096, 1),
    (8, 256, 256, 1)])
def test_k_split_fills_the_card(M, K, N, want):
    """The CUDA grid's split of K (a divisor of K / 256) gives the Llama-3-8B
    decode projections at least two blocks an SM of a 132-SM card."""
    assert tqmm._splits(M, K, N, 132) == want
    blocks = (N // 64) * -(-M // 16) * want
    assert blocks >= 264 or want == K // 256


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
