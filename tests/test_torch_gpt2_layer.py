"""The port's GPT-2 on ``nn.Layer`` (``paddle_tpu_torch/models/gpt2.py``)
against the JAX package's ``GPT2ForCausalLM`` on the CPU.

A tiny model (2 layers, width 64, one head of 64, S 128: the flash path's
shape) is built by the JAX package from a seed; its ``state_dict`` as numpy
arrays loads into the port's model through ``set_state_dict`` unchanged
(both store ``Linear`` weights ``[in, out]``).  The JAX model attends
through its dense path on the CPU, the port through the flash kernels'
plain twins (K1-K3, or K4's with ``FLAGS_flash_layout_direct``).
Tolerances, those of ``tests/test_torch_gpt2.py`` for the same comparison:
float32 logits and losses at 1e-5 relative / 1e-4 absolute, gradients at
5e-4; bf16 logits of the chunked loss at 1e-3 for the loss and 2e-2 of the
largest element for the gradients; parameters after AdamW + clip at rtol
2e-4 / atol 1e-5, or within 2 lr where a gradient element was ever under
1e-4 of its tensor's largest (Adam's first update is about lr * sign(g))."""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.nn as jnn
from paddle_tpu.models import gpt2 as jgpt2
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.models import gpt2 as tgpt2
from paddle_tpu_torch.ops.flash_attention import flash_attention_bshd

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=1,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0)
B, S = 2, 128


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


def _pair(seed=0, **kw):
    """The JAX model and the port's holding its weights."""
    pt.seed(seed)
    jm = jgpt2.GPT2ForCausalLM(jgpt2.GPT2Config(**TINY, **kw))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tp.seed(seed + 1)
    tm = tgpt2.GPT2ForCausalLM(tgpt2.GPT2Config(**TINY, **kw))
    missing, unexpected = tm.set_state_dict(state)
    assert not missing and not unexpected
    return jm, tm


def _ids(seed):
    ids = np.random.RandomState(seed).randint(0, TINY["vocab_size"],
                                              (B, S + 1)).astype(np.int32)
    return ids[:, :-1], ids[:, 1:]


def _grads(jm, tm):
    jg = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    tg = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert set(jg) == set(tg)
    return jg, tg


def test_classes_names_and_state_dict_keys_are_the_reference_s():
    for name in ("GPT2Attention", "GPT2MLP", "GPT2Block", "GPT2Model",
                 "GPT2ForCausalLM", "gpt2_small", "gpt2_tiny"):
        assert hasattr(tgpt2, name)
    for kw in ({}, {"vocab_size": 512, "loss_chunk_size": 64}):
        assert (vars(tgpt2.GPT2Config.gpt2_small(**kw))
                == vars(jgpt2.GPT2Config.gpt2_small(**kw)))
    jm, tm = _pair()
    assert list(tm.state_dict()) == list(jm.state_dict())
    for (n, jp), (_, p) in zip(jm.named_parameters(), tm.named_parameters()):
        assert p.shape == jp.shape, n
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp.numpy()), n)
    assert isinstance(tm, tnn.Layer) and all(
        isinstance(p, tp.Parameter) for p in tm.parameters())


def test_logits_match_jax():
    jm, tm = _pair(1)
    jm.eval()
    tm.eval()
    x, _ = _ids(2)
    want = np.asarray(jm(pt.to_tensor(x)).numpy())
    before = flash_attention_bshd.launches_fwd
    got = tm(tp.to_tensor(x))
    assert got.dtype == tp.float32 and got.shape == list(want.shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    assert flash_attention_bshd.launches_fwd == before   # CPU: plain twins


@pytest.mark.parametrize("chunk,logits_dtype,recompute", [
    (0, "float32", True),
    (64, "float32", True), (64, "float32", False),
    (64, "bfloat16", True), (64, "bfloat16", False)])
def test_loss_and_every_gradient_match_jax(chunk, logits_dtype, recompute):
    """The dense loss (``cross_entropy`` over the logits) and the chunked
    loss in 64-token chunks (float32 and bf16 logits, recompute on and
    off): the loss and the gradient of every parameter."""
    kw = dict(loss_chunk_size=chunk, loss_logits_dtype=logits_dtype,
              loss_recompute=recompute)
    jm, tm = _pair(3, **kw)
    x, y = _ids(4)
    _, jl = jm(pt.to_tensor(x), labels=pt.to_tensor(y))
    jl.backward()
    _, tl = tm(tp.to_tensor(x), labels=tp.to_tensor(y))
    tl.backward()
    f32 = logits_dtype == "float32"
    assert tl.dtype == tp.float32 and tl.shape == []
    np.testing.assert_allclose(tl.item(), jl.item(), rtol=1e-5 if f32 else 1e-3)
    jg, tg = _grads(jm, tm)
    for n, g in jg.items():
        tol = 5e-4 if f32 else 2e-2 * np.abs(g).max()
        np.testing.assert_allclose(tg[n], g, atol=tol, rtol=0, err_msg=n)


def _train(steps, lr=1e-3):
    """``bench.py`` ``_train``'s optimizer and ``train_step`` on both
    models: AdamW(lr, weight_decay 0.01) with ClipGradByGlobalNorm(1.0),
    ``steps`` steps on one batch."""
    jm, tm = _pair(5)
    jopt = pt.optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                              parameters=jm.parameters(),
                              grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    topt = tp.optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                              parameters=tm.parameters(),
                              grad_clip=tnn.ClipGradByGlobalNorm(1.0))

    def step(model, opt, x, y):     # bench.py's train_step
        _, loss = model(x, labels=y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    x, y = _ids(6)
    jx, jy = pt.to_tensor(x), pt.to_tensor(y)
    tx, ty = tp.to_tensor(x), tp.to_tensor(y)
    small = {n: False for n, _ in tm.named_parameters()}
    jparams = dict(jm.named_parameters())
    counts = flash_attention_bshd
    launched = (counts.launches_fwd, counts.launches_direct_fwd)
    for i in range(steps):
        _, jl = jm(jx, labels=jy)
        jl.backward()
        for n, p in jparams.items():
            g = np.abs(np.asarray(p.grad.numpy()))
            small[n] = small[n] | (g < 1e-4 * g.max())
        jopt.step()
        jopt.clear_grad()
        tl = step(tm, topt, tx, ty)
        np.testing.assert_allclose(tl.item(), jl.item(), rtol=1e-5,
                                   err_msg=f"loss, step {i}")
        for n, p in tm.named_parameters():
            want = np.asarray(jparams[n].numpy())
            got = p.numpy()
            ok = np.isclose(got, want, rtol=2e-4, atol=1e-5) | (
                small[n] & (np.abs(got - want) <= 2 * lr))
            assert ok.all(), (f"param {n}, step {i}: worst "
                              f"{np.abs(got - want).max()}")
        assert all(p.grad is None for p in tm.parameters())
    # the CPU runs the kernels' plain twins: nothing launched
    assert (counts.launches_fwd, counts.launches_direct_fwd) == launched
    return topt


def test_three_adamw_clip_train_steps_match_jax():
    opt = _train(3)
    assert int(opt._global_step) == 3
    assert opt._lr_t.dtype == tp.float32 and opt._lr_t.shape == []


def test_three_train_steps_layout_direct(layout_direct):
    _train(3)


def test_bf16_model_matches_jax_at_the_bf16_bar():
    """``model.to(dtype="bfloat16")`` on both sides: the loss and the
    logits at 2e-2 (bf16 rounds each op's output on both sides)."""
    jm, tm = _pair(7, loss_chunk_size=64, loss_logits_dtype="bfloat16",
                   loss_recompute=False)
    jm.to(dtype="bfloat16")
    params = tm.parameters()
    tm.to(dtype="bfloat16")
    assert all(a is b for a, b in zip(params, tm.parameters()))
    assert all(p.dtype == tp.bfloat16 and p.is_leaf and not p.stop_gradient
               for p in params)
    x, y = _ids(8)
    _, jl = jm(pt.to_tensor(x), labels=pt.to_tensor(y))
    _, tl = tm(tp.to_tensor(x), labels=tp.to_tensor(y))
    np.testing.assert_allclose(tl.item(), jl.item(), rtol=2e-2)
    jm.eval()
    tm.eval()
    want = np.asarray(jm(pt.to_tensor(x)).astype("float32").numpy())
    got = tm(tp.to_tensor(x)).astype("float32").numpy()
    np.testing.assert_allclose(got, want, atol=2e-2 * np.abs(want).max())


def test_state_dict_numpy_round_trip_gives_an_equal_forward():
    _, tm = _pair(9)
    tp.seed(123)
    fresh = tgpt2.GPT2ForCausalLM(tgpt2.GPT2Config(**TINY))
    fresh.set_state_dict({k: v.numpy() for k, v in tm.state_dict().items()})
    x, _ = _ids(10)
    tm.eval()
    fresh.eval()
    np.testing.assert_array_equal(fresh(tp.to_tensor(x)).numpy(),
                                  tm(tp.to_tensor(x)).numpy())


def test_unported_options_refuse():
    _, tm = _pair(11, use_recompute=True)
    x, _ = _ids(12)
    with pytest.raises(NotImplementedError, match="M12"):
        tm(tp.to_tensor(x))
    tm.eval()                    # the reference recomputes only in training
    assert tm(tp.to_tensor(x)).shape == [B, S, TINY["vocab_size"]]
