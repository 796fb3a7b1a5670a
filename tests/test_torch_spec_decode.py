"""Speculative decoding in the PyTorch port on the CPU: n-gram and
draft-model proposals verified by ONE multi-query forward (the plain
version of K7 / K7q on CPU tensors), with paged-KV rollback of rejected
drafts.

Against the JAX package, on the same tiny Llama (float32, weights bridged
through ``llama_from_numpy``) and the reference test's prompts
(``test_spec_decode.py``): greedy tokens AND the speculative counters
(proposed, accepted, emitted, verify dispatches) must be equal, with
``adaptive=False`` (the adaptive draft length follows wall-clock samples).
Within the port: greedy and fixed-seed sampled outputs are token-identical
to a spec-off engine (seeded draws cannot match JAX's threefry), through
eos inside an accepted run, rollback across page boundaries, the prefix
cache, int8 pages, and the model drafting for itself through ``generate``.
"""
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.inference.serving import LLMEngine as JaxEngine
from paddle_tpu.inference.serving import SpecConfig as JaxSpecConfig
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.inference.serving import LLMEngine, SpecConfig
from paddle_tpu_torch.models.convert import llama_from_numpy
from paddle_tpu_torch.models.llama_module import LlamaConfig

_CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=176,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128)

_RNG = np.random.default_rng(1)
_PAT = _RNG.integers(5, 120, size=6).tolist()
# the reference's prompts: repeated structure (n-gram hits), short random,
# mixed tail
_PROMPTS = [_PAT * 4,
            _RNG.integers(5, 120, size=11).tolist(),
            _PAT * 2 + [7, 9],
            _RNG.integers(5, 120, size=3).tolist()]
_STATS = ("proposed", "accepted", "emitted", "verify_dispatches")


@pytest.fixture(scope="module")
def models():
    pt.seed(0)
    jm = JaxLlama(JaxConfig(**_CFG))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    return jm, llama_from_numpy(state, LlamaConfig(**_CFG), device="cpu")


@pytest.fixture(scope="module")
def model(models):
    return models[1]


def _knobs(kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_len", 96)
    kw.setdefault("page_size", 8)
    kw.setdefault("prefill_chunk", 8)
    return kw


def _engine(model, spec, **kw):
    return LLMEngine(model, device="cpu", spec_decode=spec, **_knobs(kw))


def _serve(eng, prompts, **req_kw):
    req_kw.setdefault("max_new_tokens", 20)
    rids = [eng.add_request(p, **req_kw) for p in prompts]
    eng.run_until_done()
    return [list(eng.result(rid)) for rid in rids]


def _check_page_accounting(eng):
    """Pool conservation + per-slot allocation covers each length."""
    alloc = sum(int(eng._n_alloc[s]) for s in range(eng.max_batch))
    assert alloc + len(eng._free_pages) + len(eng._lru) == eng.n_pages - 1
    for s, r in enumerate(eng._slots):
        if r is not None:
            lens = int(eng._lens[s])
            assert int(eng._n_alloc[s]) >= max(1, -(-lens // eng.page))


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_tokens_and_spec_stats_identical_to_jax(models, kv):
    jm, tm = models
    jeng = JaxEngine(jm, spec_decode=JaxSpecConfig(max_draft=4,
                                                   adaptive=False),
                     kv_cache_dtype=kv, **_knobs({}))
    teng = _engine(tm, SpecConfig(max_draft=4, adaptive=False),
                   kv_cache_dtype=kv)
    want = [[int(t) for t in o] for o in _serve(jeng, _PROMPTS)]
    assert _serve(teng, _PROMPTS) == want
    got_st, want_st = teng.spec_stats(), jeng.spec_stats()
    assert {k: got_st[k] for k in _STATS} == {k: want_st[k] for k in _STATS}
    assert got_st["accepted"] > 0 and got_st["tokens_per_step"] > 1.0
    assert teng.runner.has_verify_program(4)
    _check_page_accounting(teng)


def test_greedy_spec_on_equals_spec_off(model):
    base = _serve(_engine(model, None), _PROMPTS)
    eng = _engine(model, SpecConfig(max_draft=4))
    assert _serve(eng, _PROMPTS) == base
    st = eng.spec_stats()
    assert st["proposed"] > 0 and st["accepted"] > 0
    assert st["verify_dispatches"] > 0
    _check_page_accounting(eng)
    # every page back in the pool once idle
    assert sum(int(eng._n_alloc[s]) for s in range(eng.max_batch)) == 0
    assert len(eng._free_pages) + len(eng._lru) == eng.n_pages - 1


def test_fixed_seed_sampling_spec_on_equals_spec_off(model):
    kw = dict(do_sample=True, temperature=0.9, top_p=0.8, seed=17,
              max_new_tokens=16)
    base = _serve(_engine(model, None), _PROMPTS[:3], **kw)
    eng = _engine(model, SpecConfig(max_draft=4))
    assert _serve(eng, _PROMPTS[:3], **kw) == base
    assert eng.spec_stats()["verify_dispatches"] > 0


def test_eos_inside_an_accepted_run(model):
    """eos stops the request exactly where the spec-off engine stops it,
    also when it lands inside an accepted run (the tokens after it in the
    run are dropped on release).  Candidates: each prompt's tokens at
    their first occurrence from position 4 on, as the reference picks its
    eos, until one stops a run whose drafts were accepted."""
    found = False
    for p in _PROMPTS:
        base = _serve(_engine(model, None, max_batch=1), [p])[0]
        for eos in [t for i, t in enumerate(base) if base.index(t) == i >= 4]:
            stop = base.index(eos) + 1
            a = _serve(_engine(model, None, max_batch=1), [p],
                       eos_token_id=eos)
            eng = _engine(model, SpecConfig(max_draft=4), max_batch=1)
            b = _serve(eng, [p], eos_token_id=eos)
            assert a == b
            assert a[0][-1] == eos and len(a[0]) == stop
            if eng.spec_stats()["accepted"] > 0:
                found = True
                break
        if found:
            break
    assert found


def test_rollback_across_page_boundaries(model):
    """max_draft > page_size: provisional rows span page boundaries, and
    every rejection hands those pages back (checked after every step)."""
    eng = _engine(model, SpecConfig(max_draft=6), page_size=4, max_len=64,
                  max_batch=2)
    rids = [eng.add_request(p[:12], max_new_tokens=24)
            for p in _PROMPTS[:2]]
    while eng._waiting or any(s is not None for s in eng._slots):
        eng.step()
        for s, r in enumerate(eng._slots):
            if r is None or r.pos < len(r.prompt):
                continue
            assert int(eng._n_alloc[s]) == max(1, -(-int(eng._lens[s]) // 4))
        _check_page_accounting(eng)
    base = _serve(_engine(model, None, page_size=4, max_len=64, max_batch=2),
                  [p[:12] for p in _PROMPTS[:2]], max_new_tokens=24)
    assert [list(eng.result(r)) for r in rids] == base
    assert eng.spec_stats()["proposed"] > 0


def test_prefix_cache_with_drafts(model):
    """Rejected drafts write provisional KV past a slot's length; with the
    prefix cache on, none may land in a SHARED page, or the third
    request's cached-prefix serve would return other tokens."""
    prompts = [_PAT * 4, _PAT * 4, (_PAT * 4)[:20]]

    def serve_fresh(spec):
        eng = _engine(model, spec, prefix_cache=True, max_batch=2)
        outs = []
        for p in prompts:
            rid = eng.add_request(p, max_new_tokens=16)
            eng.run_until_done()
            outs.append(list(eng.result(rid)))
        return outs, eng

    base, _ = serve_fresh(None)
    out, eng = serve_fresh(SpecConfig(max_draft=4))
    assert out == base
    assert eng.prefix_cache_stats()["hits"] > 0
    assert eng.spec_stats()["accepted"] > 0
    _check_page_accounting(eng)


def test_int8_pages_with_spec_equal_int8_without(model):
    base = _serve(_engine(model, None, kv_cache_dtype="int8"), _PROMPTS)
    eng = _engine(model, SpecConfig(max_draft=4), kv_cache_dtype="int8")
    assert _serve(eng, _PROMPTS) == base
    assert eng.spec_stats()["accepted"] > 0
    _check_page_accounting(eng)


def test_self_draft_is_always_accepted(model):
    """The target model as its own draft model (through the port's
    ``generate``): every proposal is the greedy continuation, so
    acceptance is 1.0 and the output equals spec-off."""
    eng = _engine(model, SpecConfig(max_draft=3, draft_model=model),
                  max_batch=1)
    out = _serve(eng, [_PROMPTS[1]], max_new_tokens=12)
    base = _serve(_engine(model, None, max_batch=1), [_PROMPTS[1]],
                  max_new_tokens=12)
    assert out == base
    st = eng.spec_stats()
    assert st["acceptance_rate"] == 1.0 and st["proposed"] > 0
    assert st["tokens_per_step"] > 2.0
