"""The PyTorch port's ``LLMEngine(kv_cache_dtype="int8")`` on the CPU
against the JAX package's int8 engine, on the same tiny Llama (float32, the
JAX model's weights bridged through ``llama_from_numpy``): int8 K/V pages
with float32 per-(token, kv head) scales, quantized as each layer writes
its rows.  On the CPU both sides dequantize in float32 (their plain
attention), so greedy outputs must be token-identical across continuous
batching, chunked prefill, preemption and prefix caching with
copy-on-write; page bytes must equal the reference's; and pages spilled to
the host tier and restored must serve the same tokens as recompute."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference.serving import LLMEngine as JaxEngine
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.inference.serving import LLMEngine
from paddle_tpu_torch.models.convert import llama_from_numpy
from paddle_tpu_torch.models.llama_module import LlamaConfig, LlamaForCausalLM

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
    "prefix_cache_cow": (dict(max_batch=2, max_len=64, page_size=8,
                              prefill_chunk=8, prefix_cache=True),
                         7, (0, 0, 6), 16, 6, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_tokens_identical_to_jax_int8_engine(models, case):
    jm, tm = models
    knobs, seed, lens, shared, new, waves = CASES[case]
    prompts = _prompts(seed, lens, shared)
    jeng = JaxEngine(jm, kv_cache_dtype="int8", **knobs)
    teng = LLMEngine(tm, device="cpu", kv_cache_dtype="int8", **knobs)
    assert teng.runner.kv_quant and jeng.runner.kv_quant
    assert [a.dtype for a in teng.runner.cache] == [
        torch.int8, torch.int8, torch.float32, torch.float32]
    want = _serve(jeng, prompts, new, waves)
    got = _serve(teng, prompts, new, waves)
    assert got == want
    assert all(len(t) == new for t in got)
    if case == "preemption":
        assert teng.preemptions > 0 and jeng.preemptions > 0
    if case == "prefix_cache_cow":
        st = teng.prefix_cache_stats()
        assert st["hits"] > 0 and st["hits"] == jeng.prefix_cache_stats()[
            "hits"]
        # a fully cached prompt re-prefills its last token through a
        # copy-on-write page: values and scales both travel
        assert st["cow_copies"] > 0
    assert teng.prefill_dispatches == jeng.prefill_dispatches
    assert teng.audit_refcounts() == []


def test_int8_tracks_full_precision(models):
    """The reference's documented tolerance for int8 pages: greedy decode
    agrees with the full-precision engine on at least 75% of tokens (int8
    noise may flip a near-tie argmax)."""
    _, tm = models
    prompt = np.random.RandomState(1).randint(1, 128, (12,)).astype(np.int32)
    base = dict(max_batch=2, max_len=64, page_size=8, prefill_chunk=8)
    outs = [_serve(LLMEngine(tm, device="cpu", kv_cache_dtype=kv, **base),
                   [prompt], 12)[0] for kv in ("auto", "int8")]
    assert len(outs[0]) == len(outs[1]) == 12
    assert np.mean(np.asarray(outs[0]) == np.asarray(outs[1])) >= 0.75


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_bytes_per_page_matches_jax(dtype):
    """Scales count in the page budget, as the reference counts them: int8
    pages cost (D + 4) / (2 D) of bf16 pages."""
    pt.seed(0)
    jm = JaxLlama(JaxConfig.tiny())
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                          dtype=getattr(torch, dtype))
    if dtype == "bfloat16":
        jm.to(dtype="bfloat16")
    base = dict(max_batch=2, max_len=64, page_size=8, prefill_chunk=8)
    bpp = {}
    for kv in ("auto", "int8"):
        bpp[kv] = LLMEngine(tm, device="cpu", kv_cache_dtype=kv,
                            **base).kv_bytes_per_page()
        assert bpp[kv] == JaxEngine(jm, kv_cache_dtype=kv,
                                    **base).kv_bytes_per_page()
    if dtype == "bfloat16":
        D = 64 // 4
        assert bpp["int8"] / bpp["auto"] == pytest.approx((D + 4) / (2 * D))


def test_host_tier_spills_and_restores_int8_pages(models):
    """A 6-page pool with one slot: serving A, B, A evicts A's chain to the
    host tier (int8 values and float32 scales as themselves) and restores
    it; the tokens equal the no-cache engine's, and the restore skips A's
    re-prefill."""
    _, tm = models
    rng = np.random.RandomState(0)
    a, b = (rng.randint(1, 128, (40,)).astype(np.int32) for _ in range(2))
    geo = dict(max_batch=1, max_len=48, page_size=8, prefill_chunk=8,
               page_pool=6, kv_cache_dtype="int8")

    def one_by_one(eng):
        outs, disp = [], []
        for p in (a, b, a):
            rid = eng.add_request(p, max_new_tokens=4)
            eng.run_until_done()
            outs.append(list(eng.result(rid)))
            disp.append(eng._finished[rid].prefill_dispatches)
        return outs, disp

    ref, ref_disp = one_by_one(LLMEngine(tm, device="cpu", **geo))
    eng = LLMEngine(tm, device="cpu", prefix_cache=True,
                    host_cache_bytes=64 << 20, **geo)
    got, disp = one_by_one(eng)
    assert got == ref
    st = eng.kv_tier_stats()
    assert st["host_spills"] >= 5 and st["host_restores"] >= 5, st
    assert st["host_spill_drops"] == 0 and st["host_restore_failures"] == 0
    assert disp[2] == 1 < ref_disp[2]
    blocks = eng.runner.pages_to_host([0])
    assert [blk.dtype for blk in blocks] == [np.int8, np.int8, np.float32,
                                             np.float32]
    assert eng.audit_refcounts() == []
