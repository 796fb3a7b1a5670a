"""The spine's attention and the GPT-2 program written in the Paddle Tensor
API, against the JAX package on the CPU.

- The Tensor-level ``scaled_dot_product_attention`` / ``flash_attention``
  (``paddle_tpu_torch/nn/functional/attention.py``: one ``apply_op``
  dispatch around the flash wrapper's own autograd Function) against the
  JAX Tensor-level functionals on the same numpy q / k / v: causal and
  not, GQA, a boolean mask (the dense path), a shape the kernels do not
  take, and ``FLAGS_flash_layout_direct`` (K4's twin).  float32 forward at
  2e-5, gradients at 5e-4 (``tests/test_pallas_kernels.py``'s bars).  On
  the CPU the JAX functionals take their dense path and the port the
  kernels' plain twins.
- ``chip_smoke.spine_gpt2_loss`` (the program ``chip_smoke.py``'s spine
  phase trains on the card) at a tiny width (2 layers, 2 heads of 64,
  S 128) against the JAX package's ``GPT2ForCausalLM`` on the same numpy
  weights: the loss at 1e-5 relative and every parameter's gradient at
  5e-4 (``tests/test_torch_gpt2.py``'s tolerances), and its PyLayer GELU
  against the plain one."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.nn.functional as JF
from paddle_tpu.models import gpt2 as jgpt2
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.core import dispatch as tdispatch

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev


@pytest.fixture
def layout_direct():
    saved = tp.get_flags("flash_layout_direct")
    tp.set_flags({"flash_layout_direct": True})
    yield
    tp.set_flags(saved)


class _Count:
    """Counts the port's apply_op dispatches by name."""

    def __init__(self):
        self.names = []

    def record(self, name, dt, **kw):
        self.names.append(name)


# (B, S, H, KVH, D, causal, mask)
CASES = {
    "causal": (2, 128, 2, 2, 64, True, False),
    "full": (1, 128, 2, 2, 64, False, False),
    "gqa": (1, 256, 4, 2, 64, True, False),
    "d128": (1, 128, 2, 1, 128, True, False),
    "mask": (2, 128, 2, 2, 64, False, True),
    "dense-shape": (2, 19, 2, 2, 32, True, False),
}


def _qkv(B, S, H, KVH, D, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, S, H, D).astype(np.float32)
    k = rng.randn(B, S, KVH, D).astype(np.float32)
    v = rng.randn(B, S, KVH, D).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (B, S, H, D)).astype(np.float32)
    m = rng.rand(1, 1, S, S) > 0.3
    m[..., np.arange(S), np.arange(S)] = True
    return q, k, v, w, m


def _run(pkg, F, which, arrays, causal, mask):
    q, k, v, w, m = arrays
    ts = [pkg.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
    if which == "sdpa":
        out = F.scaled_dot_product_attention(
            *ts, attn_mask=pkg.to_tensor(m) if mask else None,
            is_causal=causal)
    else:
        out, sm = F.flash_attention(*ts, causal=causal)
        assert sm is None
    (out * pkg.to_tensor(w)).sum().backward()
    return [out.numpy()] + [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("case,which", [
    (c, w) for c in sorted(CASES) for w in ("sdpa", "flash")
    if not (CASES[c][-1] and w == "flash")])      # flash takes no mask
def test_tensor_level_attention_matches_jax(case, which):
    B, S, H, KVH, D, causal, mask = CASES[case]
    arrays = _qkv(B, S, H, KVH, D)
    rec = _Count()
    prev = tdispatch._state.op_recorder
    tdispatch._state.op_recorder = rec
    try:
        got = _run(tp, TF, which, arrays, causal, mask)
    finally:
        tdispatch._state.op_recorder = prev
    want = _run(pt, JF, which, arrays, causal, mask)
    assert rec.names.count("scaled_dot_product_attention"
                           if which == "sdpa" else "flash_attention") == 1
    np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=0)
    for g, w, n in zip(got[1:], want[1:], "qkv"):
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=0, err_msg=f"d{n}")


@pytest.mark.parametrize("which", ["sdpa", "flash"])
def test_layout_direct_flag_matches_jax(which, layout_direct):
    """MHA with FLAGS_flash_layout_direct: K4's plain twins on the port."""
    arrays = _qkv(2, 128, 2, 2, 64, seed=3)
    got = _run(tp, TF, which, arrays, True, False)
    want = _run(pt, JF, which, arrays, True, False)
    np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=0)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=0)


def test_torch_tensors_still_take_the_torch_path():
    """The torch.nn models pass torch tensors: the same functional returns
    a torch tensor, with no dispatch."""
    import torch
    q = torch.randn(1, 128, 2, 64)
    out = TF.scaled_dot_product_attention(q, q, q, is_causal=True)
    assert isinstance(out, torch.Tensor)
    out, _ = TF.flash_attention(q, q, q, causal=True)
    assert isinstance(out, torch.Tensor)


# ---- the GPT-2 program of the spine phase ------------------------------------
TINY = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0)


@pytest.fixture(scope="module")
def jax_run():
    pt.seed(4)
    jm = jgpt2.GPT2ForCausalLM(jgpt2.GPT2Config(**TINY))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    ids = np.random.RandomState(5).randint(0, TINY["vocab_size"], (2, 129))
    x, y = ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)
    _, loss = jm(pt.to_tensor(x), labels=pt.to_tensor(y))
    loss.backward()
    grads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    return state, x, y, float(loss.item()), grads


def _spine(state, x, y, **kw):
    params = {n: tp.Parameter(a, name=n) for n, a in state.items()}
    loss = chip_smoke.spine_gpt2_loss(params, tp.to_tensor(x),
                                      tp.to_tensor(y), num_heads=2, **kw)
    loss.backward()
    return loss.item(), {n: p.grad.numpy() for n, p in params.items()}


def test_spine_gpt2_loss_matches_the_jax_model(jax_run):
    state, x, y, want_loss, want = jax_run
    loss, grads = _spine(state, x, y)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=1e-4)
    assert set(grads) == set(want)
    for n, g in want.items():
        np.testing.assert_allclose(grads[n], g, atol=5e-4, rtol=0,
                                   err_msg=n)


def test_spine_pylayer_gelu_matches_the_plain_one(jax_run):
    state, x, y, want_loss, want = jax_run
    loss, grads = _spine(state, x, y,
                         gelu=chip_smoke.spine_gelu_layer().apply)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=1e-4)
    for n, g in want.items():
        np.testing.assert_allclose(grads[n], g, atol=5e-4, rtol=0,
                                   err_msg=n)
