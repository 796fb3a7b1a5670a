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
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
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
