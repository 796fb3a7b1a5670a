"""The PyTorch port's ``LLMEngine`` on the CPU against the JAX package's, on
the same tiny Llama (float32, the JAX model's weights bridged through
``llama_from_numpy``): greedy outputs must be token-identical across
continuous batching, chunked prefill, preemption and prefix caching, and
must equal the teacher-forced argmax of the port's own dense
``forward_ref``.  Seeded sampling is reproducible within the port (it cannot
match JAX's threefry draws)."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference.serving import LLMEngine as JaxEngine
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.inference.serving import LLMEngine
from paddle_tpu_torch.models.convert import llama_from_numpy
from paddle_tpu_torch.models.llama_module import LlamaConfig

_CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=176,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128)


@pytest.fixture(scope="module")
def models():
    pt.seed(0)
    jm = JaxLlama(JaxConfig(**_CFG))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    return jm, llama_from_numpy(state, LlamaConfig(**_CFG), device="cpu")


def _prompts(seed, lens, shared=0):
    rng = np.random.RandomState(seed)
    head = rng.randint(1, 128, (shared,)).astype(np.int32)
    return [np.concatenate([head, rng.randint(1, 128, (n,)).astype(np.int32)])
            for n in lens]


def _serve(engine, prompts, new_tokens, waves=1):
    """Serve ``prompts`` (all at once, ``waves`` times over); returns every
    request's tokens, in order."""
    out = []
    for _ in range(waves):
        rids = [engine.add_request(p, max_new_tokens=new_tokens)
                for p in prompts]
        engine.run_until_done()
        out += [list(engine.result(r)) for r in rids]
    return out


# (engine knobs, prompt seed, prompt lengths, shared prefix, new tokens,
#  waves): each case stresses one path of the scheduler / runner
CASES = {
    "continuous_batching": (dict(max_batch=2, max_len=64, page_size=8),
                            0, (5, 9, 3, 12), 0, 6, 1),
    "chunked_prefill": (dict(max_batch=2, max_len=64, page_size=8,
                             prefill_chunk=4), 3, (21, 10), 0, 5, 1),
    "preemption": (dict(max_batch=2, max_len=24, page_size=4,
                        prefill_chunk=8, page_pool=7), 6, (8, 8, 8), 0, 16, 1),
    "prefix_cache": (dict(max_batch=2, max_len=64, page_size=8,
                          prefill_chunk=8, prefix_cache=True),
                     7, (3, 6, 9), 16, 6, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_tokens_identical_to_jax_engine(models, case):
    jm, tm = models
    knobs, seed, lens, shared, new, waves = CASES[case]
    prompts = _prompts(seed, lens, shared)
    jeng = JaxEngine(jm, **knobs)
    teng = LLMEngine(tm, device="cpu", **knobs)
    want = _serve(jeng, prompts, new, waves)
    got = _serve(teng, prompts, new, waves)
    assert got == want
    assert all(len(t) == new for t in got)
    if case == "preemption":
        assert teng.preemptions > 0 and jeng.preemptions > 0
    if case == "prefix_cache":
        assert teng.prefix_cache_stats()["hits"] > 0
        assert (teng.prefix_cache_stats()["hits"]
                == jeng.prefix_cache_stats()["hits"])
    assert teng.prefill_dispatches == jeng.prefill_dispatches
    # every page back in the pool once the engine is idle (the trash page
    # and, with prefix caching, the reclaimable cached pages aside)
    stats = teng.prefix_cache_stats()
    assert (len(teng._free_pages) + stats["reclaimable_pages"]
            == teng.n_pages - 1)


def test_greedy_tokens_are_forward_ref_argmax(models):
    """Teacher-forced: the dense reference fed prompt + the engine's tokens
    picks every engine token as its argmax."""
    _, tm = models
    prompts = _prompts(11, (4, 17, 9))
    eng = LLMEngine(tm, device="cpu", max_batch=2, max_len=64, page_size=8,
                    prefill_chunk=8)
    outs = _serve(eng, prompts, 7)
    for p, out in zip(prompts, outs):
        ids = torch.as_tensor(np.concatenate([p, out[:-1]]))[None].long()
        logits = tm.forward_ref(ids)[0, len(p) - 1:]
        assert logits.argmax(-1).tolist() == out


def test_seeded_sampling_is_reproducible(models):
    _, tm = models
    prompt = _prompts(4, (7,))[0]

    def draw(seed):
        eng = LLMEngine(tm, device="cpu", max_batch=2, max_len=64,
                        page_size=8, prefill_chunk=8)
        rid = eng.add_request(prompt, max_new_tokens=8, do_sample=True,
                              top_p=0.8, top_k=20, temperature=0.9, seed=seed)
        eng.run_until_done()
        return list(eng.result(rid))

    first = draw(1234)
    assert first == draw(1234)
    assert len(first) == 8 and all(0 <= t < 128 for t in first)
    # a different seed draws another sequence (8 draws from a nucleus of
    # several tokens colliding everywhere is vanishingly unlikely)
    assert draw(99) != first


def test_stream_matches_result(models):
    _, tm = models
    prompts = _prompts(12, (6, 11))
    eng = LLMEngine(tm, device="cpu", max_batch=2, max_len=64, page_size=8)
    rids = [eng.add_request(p, max_new_tokens=5) for p in prompts]
    streamed = list(eng.stream(rids[0]))
    eng.run_until_done()
    assert streamed == list(eng.result(rids[0]))
    assert all(eng.ttft(r) is not None for r in rids)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the paged kernels have no CPU mode)")
    return torch.device("cuda")


# engine knobs of the card runs: the default path (K5), int8 pages (K6),
# speculative decoding with n-gram drafts (K5 + K7), and both (K6 + K7q)
CARD_KNOBS = {"default": {}, "int8": dict(kv_cache_dtype="int8"),
              "spec": dict(spec=True),
              "int8_spec": dict(kv_cache_dtype="int8", spec=True)}


def _tiny_pair(head_dim):
    """``LlamaConfig.tiny()`` (head_dim 16) or its head_dim-64 variant
    (hidden 256), from the JAX model's seeded weights, on the CPU and on
    the card."""
    kw = {} if head_dim == 16 else dict(hidden_size=256,
                                        intermediate_size=512)
    pt.seed(0)
    jm = JaxLlama(JaxConfig.tiny(**kw))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = LlamaConfig.tiny(**kw)
    assert cfg.hidden_size // cfg.num_attention_heads == head_dim
    return (llama_from_numpy(state, cfg, device="cpu"),
            llama_from_numpy(state, cfg, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", sorted(CARD_KNOBS))
@pytest.mark.parametrize("head_dim", [16, 64])
def test_cuda_engine_tokens_match_cpu_engine(cuda_device, head_dim, knobs):
    """On the card, ``LlamaConfig.tiny()`` (head_dim 16) and a head_dim-64
    tiny model serve through the paged kernels (K5 / K6, and K7 / K7q when
    drafts are verified), greedy tokens identical to the same engine on the
    CPU (float32, TF32 off)."""
    from paddle_tpu_torch.inference.serving import SpecConfig
    from paddle_tpu_torch.ops.paged_attention import paged_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_model, card_model = _tiny_pair(head_dim)
    prompts = _prompts(13, (5, 16, 21))
    prompts.append(np.asarray(list(prompts[0][:4]) * 4, np.int32))
    kw = dict(CARD_KNOBS[knobs])
    if kw.pop("spec", False):
        kw["spec_decode"] = SpecConfig(max_draft=4)
    kw.update(max_batch=2, max_len=64, page_size=8, prefill_chunk=8)
    before = paged_attention.launches + paged_attention.launches_int8
    got = _serve(LLMEngine(card_model, device=cuda_device, **kw), prompts, 8)
    assert paged_attention.launches + paged_attention.launches_int8 > before
    want = _serve(LLMEngine(cpu_model, device="cpu", **kw), prompts, 8)
    assert got == want
