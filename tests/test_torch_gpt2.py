"""The port's GPT-2 against the JAX package's: the config and its
classmethods, the weight bridge (``gpt2_from_numpy``), logits, the chunked
LM loss and two AdamW + global-norm-clip training steps, on seeded tiny
models on the CPU.

The JAX model attends through its dense path on the CPU (the Pallas kernel
is used only on a TPU); the port takes the flash wrapper's plain versions
(the math of K1-K3) where the shape allows (head_dim 64, S = 128) and its
dense ``_sdpa_ref`` where it does not (``GPT2Config.tiny``: head_dim 32).
Tolerances: float32 logits and losses at 1e-5 relative / 1e-4 absolute
(sums in other orders through two layers), gradients at 5e-4 (the
reference's flash-gradient bar)."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
from paddle_tpu.models import gpt2 as jgpt2
from paddle_tpu_torch.models import gpt2_module as tgpt2
from paddle_tpu_torch.models.convert import gpt2_from_numpy
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW

# head_dim 64 and S = 128: the flash path; dropout off so both sides agree
FLASH = dict(vocab_size=256, hidden_size=128, num_layers=1, num_heads=2,
             max_position_embeddings=128, hidden_dropout_prob=0.0,
             attention_dropout_prob=0.0)


def _jax_model(cfg, seed=0):
    pt.seed(seed)
    m = jgpt2.GPT2ForCausalLM(cfg)
    state = {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}
    return m, state


def _ids(seed, b, s, vocab):
    ids = np.random.RandomState(seed).randint(0, vocab, (b, s + 1))
    return ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)


@pytest.mark.parametrize("name", ["gpt2_small", "tiny"])
def test_config_classmethods_match(name):
    for kw in ({}, {"vocab_size": 512, "loss_chunk_size": 64}):
        assert (vars(getattr(tgpt2.GPT2Config, name)(**kw))
                == vars(getattr(jgpt2.GPT2Config, name)(**kw)))
    assert vars(tgpt2.GPT2Config()) == vars(jgpt2.GPT2Config())


def test_gpt2_from_numpy_round_trips_every_key():
    cfg = jgpt2.GPT2Config.tiny()
    _, state = _jax_model(cfg)
    model = gpt2_from_numpy(state, tgpt2.GPT2Config.tiny(), device="cpu")
    params = dict(model.named_parameters())
    assert set(params) == set(state)
    for name, p in params.items():
        a = state[name]
        if a.ndim == 2 and name not in ("gpt2.wte.weight", "gpt2.wpe.weight"):
            a = a.T                          # Linear: [in, out] -> [out, in]
        np.testing.assert_array_equal(p.detach().numpy(), a, err_msg=name)


def test_gpt2_from_numpy_refuses_a_mismatched_state():
    _, state = _jax_model(jgpt2.GPT2Config.tiny())
    cfg = tgpt2.GPT2Config.tiny()
    with pytest.raises(KeyError, match="missing"):
        gpt2_from_numpy({k: v for k, v in state.items()
                         if k != "gpt2.ln_f.bias"}, cfg, device="cpu")
    with pytest.raises(KeyError, match="unexpected"):
        gpt2_from_numpy(dict(state, extra=np.zeros(1)), cfg, device="cpu")
    bad = dict(state)
    bad["gpt2.blocks.0.mlp.fc.weight"] = state["gpt2.blocks.0.mlp.fc.weight"].T
    with pytest.raises(ValueError, match="mlp.fc"):
        gpt2_from_numpy(bad, cfg, device="cpu")


@pytest.mark.parametrize("which", ["tiny", "flash"])
def test_logits_match_jax(which):
    kw = (dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
          if which == "tiny" else FLASH)
    jcfg = (jgpt2.GPT2Config.tiny(**kw) if which == "tiny"
            else jgpt2.GPT2Config(**kw))
    tcfg = (tgpt2.GPT2Config.tiny(**kw) if which == "tiny"
            else tgpt2.GPT2Config(**kw))
    jm, state = _jax_model(jcfg, seed=1)
    jm.eval()
    model = gpt2_from_numpy(state, tcfg, device="cpu").eval()
    s = 19 if which == "tiny" else 128
    x, _ = _ids(2, 2, s, tcfg.vocab_size)
    want = np.asarray(jm(pt.to_tensor(x)).numpy())
    got = model(torch.from_numpy(x).long())
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("logits_dtype,recompute", [
    ("float32", True), ("float32", False), ("bfloat16", True),
    ("bfloat16", False)])
def test_chunked_lm_loss_matches_jax(logits_dtype, recompute):
    """3 x 5 tokens in chunks of 4: the last chunk is padded, and one label
    is -100; the loss and its gradients against the hidden states and the
    tied head.  float32 logits at 1e-5.  bf16 logits: the loss at 1e-3 and
    the gradients (which flow back through the bf16 logits) at 2e-2 of the
    largest, the bf16 bar, because the two packages' f32 products round to
    bf16 on different sides of a boundary now and then (one bf16 ulp is
    2**-8 of a value)."""
    import jax
    rng = np.random.RandomState(4)
    h = rng.randn(3, 5, 16).astype(np.float32)
    w = (0.5 * rng.randn(40, 16)).astype(np.float32)
    y = rng.randint(0, 40, (3, 5)).astype(np.int32)
    y[1, 2] = -100

    def jloss(hh, ww):
        out = jgpt2._chunked_lm_loss(pt.to_tensor(hh), pt.to_tensor(ww),
                                     pt.to_tensor(y), 4, recompute=recompute,
                                     logits_dtype=logits_dtype)
        return out._data

    want, (wh, ww) = jax.value_and_grad(jloss, argnums=(0, 1))(h, w)
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = tgpt2._chunked_lm_loss(th, tw, torch.from_numpy(y).long(), 4,
                                 recompute=recompute,
                                 logits_dtype=logits_dtype)
    got.backward()
    assert got.dtype == torch.float32
    f32 = logits_dtype == "float32"
    np.testing.assert_allclose(got.item(), float(want),
                               rtol=1e-5 if f32 else 1e-3)
    for g, w in ((th.grad, wh), (tw.grad, ww)):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.numpy(), w, atol=1e-5 if f32 else 2e-2 * np.abs(w).max())


def test_two_adamw_steps_match_jax():
    """Two steps of AdamW(1e-3, weight_decay 0.01) with
    ClipGradByGlobalNorm(1.0) through the flash path: losses at 1e-5,
    every gradient at 5e-4, parameters at rtol 2e-4 / atol 1e-5.  Where a
    gradient element is under 1e-4 of its tensor's largest, Adam's first
    update (about lr * sign(g)) can flip sign on rounding noise, and the
    moments carry that into later steps, so those parameters are held at
    2 * lr from then on."""
    lr = 1e-3
    jm, state = _jax_model(jgpt2.GPT2Config(**FLASH), seed=2)
    model = gpt2_from_numpy(state, tgpt2.GPT2Config(**FLASH), device="cpu")
    jopt = pt.optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                              parameters=jm.parameters(),
                              grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    topt = AdamW(learning_rate=lr, weight_decay=0.01,
                 parameters=model.parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0))
    jparams = dict(jm.named_parameters())
    x, y = _ids(5, 2, 128, FLASH["vocab_size"])
    small = {name: False for name, _ in model.named_parameters()}
    for step in range(2):
        _, jl = jm(pt.to_tensor(x), labels=pt.to_tensor(y))
        jl.backward()
        _, tl = model(torch.from_numpy(x).long(),
                      labels=torch.from_numpy(y).long())
        tl.backward()
        np.testing.assert_allclose(tl.item(), jl.item(), rtol=1e-5,
                                   err_msg=f"loss, step {step}")
        for name, p in model.named_parameters():
            g = np.asarray(jparams[name].grad.numpy())
            tg = p.grad.numpy()
            if g.ndim == 2 and name not in ("gpt2.wte.weight",
                                            "gpt2.wpe.weight"):
                g = g.T
            np.testing.assert_allclose(tg, g, atol=5e-4, rtol=0,
                                       err_msg=f"grad {name}, step {step}")
            small[name] = small[name] | (np.abs(g) < 1e-4 * np.abs(g).max())
        jopt.step()
        jopt.clear_grad()
        topt.step()
        topt.clear_grad()
        for name, p in model.named_parameters():
            want = np.asarray(jparams[name].numpy())
            if want.ndim == 2 and name not in ("gpt2.wte.weight",
                                               "gpt2.wpe.weight"):
                want = want.T
            got = p.detach().numpy()
            ok = np.isclose(got, want, rtol=2e-4, atol=1e-5) | (
                small[name] & (np.abs(got - want) <= 2 * lr))
            assert ok.all(), (f"param {name}, step {step}: worst "
                              f"{np.abs(got - want).max()}")


def test_seeded_init_follows_the_jax_layers():
    cfg = tgpt2.GPT2Config(hidden_size=64, num_layers=8, num_heads=2,
                           vocab_size=256, max_position_embeddings=64)
    a = tgpt2.GPT2ForCausalLM(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(3))
    b = tgpt2.GPT2ForCausalLM(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=name)
    blk = a.gpt2.blocks[0]
    assert not blk.attn.qkv.bias.any() and bool((blk.ln1.weight == 1).all())
    assert not blk.ln1.bias.any()
    qkv_std = float(blk.attn.qkv.weight.detach().std())
    proj_std = float(torch.cat([blk.attn.proj.weight.detach().flatten()
                                for blk in a.gpt2.blocks]).std())
    assert abs(qkv_std - 0.02) < 0.1 * 0.02
    assert abs(proj_std - 0.02 / 4.0) < 0.1 * 0.02 / 4.0   # sqrt(2 * 8) = 4


def test_labels_without_chunks_use_the_full_cross_entropy():
    kw = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    jm, state = _jax_model(jgpt2.GPT2Config.tiny(**kw), seed=6)
    model = gpt2_from_numpy(state, tgpt2.GPT2Config.tiny(**kw), device="cpu")
    x, y = _ids(7, 2, 16, 256)
    y[0, 3] = -100
    jlog, jl = jm(pt.to_tensor(x), labels=pt.to_tensor(y))
    logits, loss = model(torch.from_numpy(x).long(),
                         labels=torch.from_numpy(y).long())
    assert logits.shape == (2, 16, 256)
    np.testing.assert_allclose(loss.item(), jl.item(), rtol=1e-5)
