"""The PyTorch port's Llama against the JAX package's: the config and its
classmethods, the weight bridge (``llama_from_numpy``) and the dense
``forward_ref`` logits, on seeded tiny models on the CPU.

Tolerance: float32 logits at atol 1e-4 — both sides compute the same
float32 math, but sum matmuls and softmaxes in other orders (XLA's CPU
kernels vs PyTorch's), which moves the last few bits through two layers."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference.engine.runner import _rms as jax_rms
from paddle_tpu.inference.engine.runner import _rope as jax_rope
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.models.convert import llama_from_numpy
from paddle_tpu_torch.models.llama_module import (LlamaConfig, LlamaForCausalLM,
                                           rms_norm, rope)

CLASSMETHODS = ("llama3_8b", "qwen2_moe_a14b", "deepseek_moe_16b", "tiny",
                "tiny_moe")


def _jax_model(seed=0, **kw):
    pt.seed(seed)
    m = JaxLlama(JaxConfig.tiny(**kw))
    m.eval()
    state = {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}
    return m, state


@pytest.mark.parametrize("name", CLASSMETHODS)
def test_config_classmethods_match(name):
    assert vars(getattr(LlamaConfig, name)()) == vars(getattr(JaxConfig,
                                                             name)())
    assert (vars(getattr(LlamaConfig, name)(num_hidden_layers=3))
            == vars(getattr(JaxConfig, name)(num_hidden_layers=3)))


@pytest.mark.parametrize("tied", [False, True])
def test_llama_from_numpy_round_trips_every_key(tied):
    _, state = _jax_model(tie_word_embeddings=tied)
    cfg = LlamaConfig.tiny(tie_word_embeddings=tied)
    model = llama_from_numpy(state, cfg, device="cpu")
    params = dict(model.named_parameters())
    assert set(params) == set(state)
    assert ("lm_head.weight" in params) is not tied
    for name, p in params.items():
        a = state[name]
        if a.ndim == 2 and name != "llama.embed_tokens.weight":
            a = a.T                          # Linear: [in, out] -> [out, in]
        assert tuple(p.shape) == a.shape, name
        np.testing.assert_array_equal(p.detach().numpy(), a, err_msg=name)


def test_llama_from_numpy_refuses_a_mismatched_state():
    _, state = _jax_model()
    cfg = LlamaConfig.tiny()
    with pytest.raises(KeyError, match="missing"):
        llama_from_numpy({k: v for k, v in state.items()
                          if k != "llama.norm.weight"}, cfg, device="cpu")
    bad = dict(state)
    bad["llama.layers.0.mlp.up_proj.weight"] = state[
        "llama.layers.0.mlp.up_proj.weight"].T
    with pytest.raises(ValueError, match="up_proj"):
        llama_from_numpy(bad, cfg, device="cpu")


@pytest.mark.parametrize("tied", [False, True])
def test_forward_ref_logits_match_jax_forward(tied):
    jm, state = _jax_model(seed=1, tie_word_embeddings=tied)
    model = llama_from_numpy(state, LlamaConfig.tiny(tie_word_embeddings=tied),
                             device="cpu")
    ids = np.random.RandomState(0).randint(0, 256, (2, 19)).astype(np.int32)
    want = np.asarray(jm(pt.to_tensor(ids)).numpy())
    got = model.forward_ref(torch.from_numpy(ids).long())
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    # on a CPU tensor ``forward`` is the dense reference
    torch.testing.assert_close(model(torch.from_numpy(ids).long()), got,
                               rtol=0, atol=0)


def test_rope_and_rms_norm_match_the_jax_runner():
    import jax.numpy as jnp
    rng = np.random.RandomState(2)
    x = rng.randn(5, 4, 32).astype(np.float32)
    pos = np.asarray([0, 1, 7, 100, 4095], np.int32)
    np.testing.assert_allclose(
        rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5).numpy(),
        np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos), 5e5)),
        atol=1e-5, rtol=0)
    h, w = rng.randn(3, 64).astype(np.float32), rng.randn(64).astype(
        np.float32)
    np.testing.assert_allclose(
        rms_norm(torch.from_numpy(h), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jax_rms(jnp.asarray(h), jnp.asarray(w), 1e-5)),
        atol=1e-5, rtol=0)


def test_seeded_generator_init_is_reproducible():
    cfg = LlamaConfig.tiny()
    a = LlamaForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(5))
    b = LlamaForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(5))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=name)
    assert torch.equal(a.llama.norm.weight, torch.ones(cfg.hidden_size))
    w = a.llama.layers[0].self_attn.q_proj.weight.detach()
    assert abs(float(w.std()) - cfg.initializer_range) < 0.2 * \
        cfg.initializer_range


# ------------------------------------------------------------- generate
_GEN_IDS = np.random.RandomState(5).randint(0, 256, (2, 7)).astype(np.int64)


@pytest.fixture(scope="module")
def gen_models():
    jm, state = _jax_model(seed=3)
    return jm, llama_from_numpy(state, LlamaConfig.tiny(), device="cpu")


def _jax_generate(jm, **kw):
    return np.asarray(jm.generate(pt.to_tensor(_GEN_IDS), max_new_tokens=10,
                                  **kw).numpy())


def _port_generate(model, **kw):
    out = model.generate(torch.from_numpy(_GEN_IDS), max_new_tokens=10, **kw)
    assert out.dtype == torch.int64
    return out.numpy()


@pytest.mark.parametrize("case", ["cached", "eos", "tokens_per_dispatch_2"])
def test_greedy_generate_matches_jax(gen_models, case):
    """Greedy ``generate`` through the dense per-layer KV cache gives the
    JAX package's tokens: plain, with an eos that stops one row early (the
    finished row pads with eos), and with two decode steps a dispatch."""
    jm, model = gen_models
    kw = {}
    if case == "eos":
        row0 = _jax_generate(jm)[0, _GEN_IDS.shape[1]:].tolist()
        eos = next(t for i, t in enumerate(row0) if row0.index(t) == i >= 2)
        kw = dict(eos_token_id=int(eos))
    elif case == "tokens_per_dispatch_2":
        kw = dict(tokens_per_dispatch=2)
    want = _jax_generate(jm, **kw)
    got = _port_generate(model, **kw)
    np.testing.assert_array_equal(got, want)
    if case == "eos":
        # row 0 stops at eos; later positions of a finished row hold eos
        assert (got[0, _GEN_IDS.shape[1] + row0.index(eos):] == eos).all()


def test_generate_without_cache_equals_cached(gen_models):
    """``use_cache=False`` re-runs the dense forward each step (CPU only
    until K1) and picks the same greedy tokens as the cached path."""
    _, model = gen_models
    np.testing.assert_array_equal(_port_generate(model, use_cache=False),
                                  _port_generate(model))


def test_seeded_sampled_generate_is_reproducible(gen_models):
    _, model = gen_models
    kw = dict(do_sample=True, top_p=0.8, top_k=20, temperature=0.9)
    first = _port_generate(model, seed=7, **kw)
    np.testing.assert_array_equal(first, _port_generate(model, seed=7, **kw))
    np.testing.assert_array_equal(first[:, :7], _GEN_IDS)
    assert ((first >= 0) & (first < 256)).all()
    assert not np.array_equal(first, _port_generate(model, seed=8, **kw))


def test_kv_cache_refuses_to_overflow():
    from paddle_tpu_torch.models.llama_module import KVCache
    cache = KVCache(1, 4, 2, 8, device="cpu")
    k = torch.ones(1, 3, 2, 8)
    kk, _ = cache.update(k, k)
    assert cache.offset == 3 and kk.shape == (1, 4, 2, 8)
    assert torch.equal(kk[:, :3], k) and not kk[:, 3:].any()
    with pytest.raises(ValueError, match="full"):
        cache.update(k, k)


# ------------------------------------------------------------- training
@pytest.mark.parametrize("which", ["tiny", "flash"])
def test_forward_with_labels_matches_jax_loss_and_gradients(which):
    """``forward(ids, labels=...)`` returns (logits, loss) as the JAX model
    does, and the loss's gradients match JAX's: on ``tiny`` (head_dim 16,
    the dense path) and on a GQA 2:1, head_dim 64, S = 128 config (the
    flash wrapper's plain K1-K3 path on the CPU).  float32: logits at 1e-4,
    the loss at 1e-5 relative, gradients at 5e-4 (the reference's flash
    gradient bar)."""
    kw = ({} if which == "tiny" else
          dict(hidden_size=128, num_attention_heads=2, num_key_value_heads=1,
               intermediate_size=256))
    s = 19 if which == "tiny" else 128
    jm, state = _jax_model(seed=4, **kw)
    model = llama_from_numpy(state, LlamaConfig.tiny(**kw), device="cpu")
    ids = np.random.RandomState(6).randint(0, 256, (2, s + 1)).astype(
        np.int32)
    x, y = ids[:, :-1], ids[:, 1:].copy()
    y[1, 5] = -100
    jlogits, jloss = jm(pt.to_tensor(x), labels=pt.to_tensor(y))
    jloss.backward()
    logits, loss = model(torch.from_numpy(x).long(),
                         labels=torch.from_numpy(y).long())
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(jlogits.numpy()), atol=1e-4, rtol=0)
    np.testing.assert_allclose(loss.item(), jloss.item(), rtol=1e-5)
    jparams = dict(jm.named_parameters())
    for name, p in model.named_parameters():
        g = np.asarray(jparams[name].grad.numpy())
        if name.endswith("_proj.weight") or name == "lm_head.weight":
            g = g.T
        np.testing.assert_allclose(p.grad.numpy(), g, atol=5e-4, rtol=0,
                                   err_msg=name)
