"""The port's programs (``paddle_tpu_torch/jit/capture.py``): the serving
runner's decode / prefill / verify programs and ``generate``'s cached
decode step, on ``LlamaConfig.tiny()`` in float32 with numpy-seeded
weights.

On the CPU a program runs its body on its static buffers, the code the
card captures into a CUDA graph and replays.  These tests hold that the
buffers carry no state from one dispatch to the next, that returned
tokens are copies, that setting ``LLMEngine.cache`` copies in place, the
reference's ``_gen_states`` semantics (reuse with the offset rewound, a
private state for a reentrant call, at most 4 entries) with greedy tokens
equal to the JAX package's ``generate``, and that sampled dispatches run
eagerly and are counted.  The ``cuda`` cases (replay against the eager
body, launch counters under replay) skip without a card.  Token and cache
comparisons are exact: both sides run the same float32 ops in the same
order."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference.engine import ModelRunner
from paddle_tpu_torch.inference.serving import LLMEngine
from paddle_tpu_torch.models.convert import llama_from_numpy
from paddle_tpu_torch.models.llama_module import LlamaConfig, LlamaForCausalLM

_CFG = LlamaConfig.tiny()
_IDS = np.random.RandomState(5).randint(0, 256, (2, 7)).astype(np.int64)


def _state(cfg, seed=0):
    """Seeded numpy weights in the JAX package's layout (Linear [in, out])."""
    shapes = {}
    for n, m in LlamaForCausalLM(cfg, device="cpu").named_modules():
        for pn, p in m.named_parameters(recurse=False):
            shp = tuple(p.shape)
            shapes[f"{n}.{pn}"] = (shp[::-1] if isinstance(m, torch.nn.Linear)
                                   else shp)
    rng = np.random.RandomState(seed)
    return {n: ((1.0 + 0.1 * rng.randn(*s)) if n.endswith("norm.weight")
                else 0.1 * rng.randn(*s)).astype(np.float32)
            for n, s in shapes.items()}


@pytest.fixture(scope="module")
def state():
    return _state(_CFG)


@pytest.fixture(scope="module")
def model(state):
    return llama_from_numpy(state, _CFG, device="cpu")


def _runner(model, device="cpu", cache=None):
    r = ModelRunner(model, max_batch=2, page_size=4, prefill_chunk=8,
                    n_pages=9, device=device)
    if cache is not None:
        r.load_cache(cache)
    return r


def _random_cache(runner, seed):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(a.shape, generator=g).to(a.dtype)
                 for a in runner.cache)


def _sampling(B, greedy=1):
    return dict(greedy=np.full(B, greedy, np.int32),
                temp=np.full(B, 0.9, np.float32),
                topp=np.full(B, 0.8, np.float32),
                topk=np.zeros(B, np.int32), seeds=np.arange(B, dtype=np.int32),
                fold=np.ones(B, np.int32))


def _dispatch(runner, kind, inp):
    """One dispatch of ``kind`` with inputs ``inp`` (a seed's worth);
    returns its tokens as numpy."""
    if kind == "prefill":
        return np.asarray(int(runner.run_prefill(
            inp["tokens"], inp["start"], inp["table"], inp["n_valid"],
            1, 1.0, 1.0, 0, 0)))
    s = _sampling(2)
    if kind.startswith("decode"):
        return runner.run_decode(int(kind[-1]), inp["tokens"], inp["lens"],
                                 inp["tables"], inp["active"], s["greedy"],
                                 s["temp"], s["topp"], s["topk"], s["seeds"],
                                 s["fold"])
    return runner.run_verify(4, inp["tokens"], inp["lens"], inp["tables"],
                             inp["n_rows"], s["greedy"], s["temp"], s["topp"],
                             s["topk"], s["seeds"], s["fold"])


def _inputs(kind, seed):
    """Inputs of one dispatch; tables are a permutation of pages 0-7 (page
    8 is the trash page), so two seeds write and read different pages."""
    rng = np.random.RandomState(seed)
    pages = rng.permutation(8).astype(np.int32)
    tables = pages.reshape(2, 4)
    if kind == "prefill":
        return dict(tokens=rng.randint(0, 256, 8).astype(np.int32),
                    start=int(rng.randint(0, 6)), table=tables[0],
                    n_valid=int(rng.randint(3, 9)))
    lens = rng.randint(2, 11, 2).astype(np.int32)
    if kind.startswith("decode"):
        return dict(tokens=rng.randint(0, 256, 2).astype(np.int32), lens=lens,
                    tables=tables, active=np.asarray([1, seed % 2], np.int32))
    return dict(tokens=rng.randint(0, 256, (2, 4)).astype(np.int32),
                lens=lens, tables=tables,
                n_rows=np.asarray([4, 1 + seed % 3], np.int32))


@pytest.mark.parametrize("kind", ["decode/1", "decode/2", "prefill",
                                  "verify"])
def test_programs_carry_no_state_between_dispatches(model, kind):
    """One runner's program run twice, with other inputs and tables the
    second time, gives the tokens and the bitwise caches of two fresh
    runners that each run one of the dispatches from the same cache."""
    a, b = _inputs(kind, 1), _inputs(kind, 2)
    reused = _runner(model)
    start = _random_cache(reused, 0)
    reused.load_cache(start)
    got = [_dispatch(reused, kind, a), _dispatch(reused, kind, b)]
    first = _runner(model, cache=start)
    want_a = _dispatch(first, kind, a)
    second = _runner(model, cache=first.cache)
    want_b = _dispatch(second, kind, b)
    np.testing.assert_array_equal(got[0], want_a)
    np.testing.assert_array_equal(got[1], want_b)
    for x, y in zip(reused.cache, second.cache):
        assert torch.equal(x, y)
    progs = reused.program_stats()
    assert len(progs) == 1
    (st,) = progs.values()
    assert st["runs"] == 2 and st["eager"] == 0 and st["captures"] == 0


def test_prefill_token_survives_later_dispatches(model):
    r = _runner(model, cache=None)
    r.load_cache(_random_cache(r, 3))
    a, b = _inputs("prefill", 4), _inputs("prefill", 5)
    tok = r.run_prefill(a["tokens"], a["start"], a["table"], a["n_valid"],
                        1, 1.0, 1.0, 0, 0)
    assert tok.dim() == 0 and tok.dtype == torch.int32
    held = int(tok)
    for _ in range(2):
        other = r.run_prefill(b["tokens"], b["start"], b["table"],
                              b["n_valid"], 1, 1.0, 1.0, 0, 0)
        d = _inputs("decode/1", 6)
        r.run_decode(1, d["tokens"], d["lens"], d["tables"], d["active"],
                     *_sampling(2).values())
    assert int(tok) == held
    assert other.data_ptr() != tok.data_ptr()
    assert r._prefill_program.runs == 3 and r.has_decode_program(1)


def _engine(model, **kw):
    return LLMEngine(model, device="cpu", max_batch=2, max_len=32,
                     page_size=4, prefill_chunk=8, **kw)


_PROMPTS = [np.random.RandomState(s).randint(1, 256, n).astype(np.int32)
            for s, n in ((7, 5), (8, 11), (9, 3))]


def _serve(eng, prompts, new=5, **kw):
    rids = [eng.add_request(p, max_new_tokens=new, **kw) for p in prompts]
    eng.run_until_done()
    return [list(eng.result(r)) for r in rids]


def test_setting_the_engine_cache_copies_in_place(model):
    """``LLMEngine.cache = x`` keeps every buffer (the graphs hold their
    addresses), holds x's values, refuses another shape or dtype, and the
    engine then serves what a fresh engine given the same cache serves."""
    used = _engine(model)
    _serve(used, _PROMPTS[:2])
    ptrs = [t.data_ptr() for t in used.cache]
    given = _random_cache(used.runner, 11)
    used.cache = given
    assert [t.data_ptr() for t in used.cache] == ptrs
    assert all(torch.equal(x, y) for x, y in zip(used.cache, given))
    fresh = _engine(model)
    fresh.cache = given
    assert _serve(used, _PROMPTS) == _serve(fresh, _PROMPTS)
    with pytest.raises(ValueError, match="component 0"):
        used.cache = (given[0][:, :4],) + given[1:]
    with pytest.raises(ValueError, match="component 1"):
        used.cache = (given[0], given[1].double())
    with pytest.raises(ValueError, match="components"):
        used.cache = given[:1]
    assert [t.data_ptr() for t in used.cache] == ptrs


def test_sampled_dispatches_run_eagerly_and_are_counted(model):
    eng = _engine(model)
    _serve(eng, _PROMPTS[:2])
    st = eng.runner.program_stats()
    assert st["decode/1"]["runs"] > 0 and st["prefill"]["runs"] > 0
    assert all(s["eager"] == 0 for s in st.values())
    _serve(eng, _PROMPTS[:1], do_sample=True, temperature=0.8, seed=3)
    st2 = eng.runner.program_stats()
    assert st2["decode/1"]["eager"] > 0 and st2["prefill"]["eager"] == 1
    assert st2["decode/1"]["runs"] == st["decode/1"]["runs"]
    # the mixed batch: one sampled row sends the whole dispatch eager
    eager = st2["decode/1"]["eager"]
    rids = [eng.add_request(_PROMPTS[0], max_new_tokens=4),
            eng.add_request(_PROMPTS[1], max_new_tokens=4, do_sample=True,
                            seed=1)]
    eng.run_until_done()
    assert all(len(eng.result(r)) == 4 for r in rids)
    assert eng.runner.program_stats()["decode/1"]["eager"] > eager


# ------------------------------------------------------------- generate
@pytest.fixture(scope="module")
def jax_generate():
    """The JAX package's tiny Llama (seeded) and its weights as numpy."""
    import paddle_tpu as pt
    from paddle_tpu.models.llama import LlamaConfig as JaxConfig
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
    pt.seed(3)
    jm = JaxLlama(JaxConfig.tiny())
    jm.eval()
    return jm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _fresh(state):
    """A port model of its own (``_gen_states`` lives on the model)."""
    return llama_from_numpy(state, _CFG, device="cpu")


@pytest.mark.parametrize("k", [1, 2])
def test_generate_reuses_its_state_with_greedy_tokens_of_jax(jax_generate,
                                                             k):
    """Two ``generate`` calls with the same key share one ``_gen_states``
    entry, the second with its offset rewound; both give the JAX package's
    greedy tokens."""
    import paddle_tpu as pt
    jm, jstate = jax_generate
    want = np.asarray(jm.generate(pt.to_tensor(_IDS), max_new_tokens=6,
                                  tokens_per_dispatch=k).numpy())
    m = _fresh(jstate)
    first = m.generate(torch.from_numpy(_IDS), max_new_tokens=6,
                       tokens_per_dispatch=k).numpy()
    (key, entry), = m._gen_states.items()
    assert entry["busy"] is False and key[-1] == k and key[1] == 128
    pos = int(entry["caches"][0].pos)
    second = m.generate(torch.from_numpy(_IDS), max_new_tokens=6,
                        tokens_per_dispatch=k).numpy()
    assert list(m._gen_states.items()) == [(key, entry)]
    np.testing.assert_array_equal(first, want)
    np.testing.assert_array_equal(second, want)
    # prompt 7 + 6 new tokens, the last never written back: both calls
    # end at 12, so the second started from 0 again
    assert pos == int(entry["caches"][-1].pos) == 12
    assert all(c.offset == int(c.pos) for c in entry["caches"])
    st = entry["step"].stats()
    # dispatch 0 is the eager prompt (with K - 1 eager steps)
    assert st["runs"] == 2 * (-(-6 // k) - 1) and st["eager"] == 2 * (k > 1)


def test_reentrant_generate_gets_a_private_state(state):
    m = _fresh(state)
    want = m.generate(torch.from_numpy(_IDS), max_new_tokens=4)
    (key, entry), = m._gen_states.items()
    entry["busy"] = True                     # an in-flight generate
    ptrs = [c.k.data_ptr() for c in entry["caches"]]
    pos = [int(c.pos) for c in entry["caches"]]
    try:
        out = m.generate(torch.from_numpy(_IDS), max_new_tokens=4)
    finally:
        entry["busy"] = False
    assert torch.equal(out, want)
    assert list(m._gen_states.items()) == [(key, entry)]
    assert [c.k.data_ptr() for c in entry["caches"]] == ptrs
    assert [int(c.pos) for c in entry["caches"]] == pos
    assert entry["step"].stats()["runs"] == 3


def test_generate_keeps_at_most_four_states(state):
    m = _fresh(state)
    ids = torch.from_numpy(_IDS)
    outs = {}
    for b in (2, 1):
        for k in (1, 2, 3):
            outs[b, k] = m.generate(ids[:b], max_new_tokens=3,
                                    tokens_per_dispatch=k)
    # six keys, the oldest two dropped
    assert [(key[0], key[-1]) for key in m._gen_states] == [
        (2, 3), (1, 1), (1, 2), (1, 3)]
    for (b, k), out in outs.items():
        assert torch.equal(out, outs[b, 1]) and out.shape == (b, 10)


def test_sampled_generate_runs_its_step_eagerly(state):
    m = _fresh(state)
    kw = dict(max_new_tokens=5, do_sample=True, top_k=20, seed=4)
    a = m.generate(torch.from_numpy(_IDS), **kw)
    b = m.generate(torch.from_numpy(_IDS), **kw)
    assert torch.equal(a, b)
    (entry,) = m._gen_states.values()
    st = entry["step"].stats()
    assert st["runs"] == 0 and st["eager"] == 2 * 4
    m.generate(torch.from_numpy(_IDS), max_new_tokens=5)
    greedy = [e for e in m._gen_states.values() if e is not entry][0]
    assert greedy["step"].stats()["runs"] == 4
    assert greedy["step"].stats()["eager"] == 0


# -------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["decode/1", "decode/2", "prefill",
                                  "verify"])
def test_cuda_replay_equals_the_eager_body(cuda_device, kind):
    """On the card, a replayed program and the same body run eagerly on a
    copy of the same inputs and cache give bitwise the same tokens, logits
    and cache (one float32 engine; the kernels are deterministic)."""
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                           num_key_value_heads=1, intermediate_size=512)
    m = llama_from_numpy(_state(cfg), cfg, device=cuda_device)
    r = ModelRunner(m, max_batch=2, page_size=4, prefill_chunk=8, n_pages=9,
                    device=cuda_device)
    r.load_cache(_random_cache(r, 0))
    _dispatch(r, kind, _inputs(kind, 1))         # captures
    start = tuple(t.clone() for t in r.cache)
    _dispatch(r, kind, _inputs(kind, 2))         # replays
    (prog,) = [p for p in (list(r._decode_programs.values())
                           + list(r._verify_programs.values())
                           + [r._prefill_program]) if p is not None]
    assert prog.captures == 1 and prog.replays == 1
    replayed = tuple(t.clone() for t in prog.outputs)
    after = tuple(t.clone() for t in r.cache)
    r.load_cache(start)
    eager = prog.body(prog.buffers)
    torch.cuda.synchronize()
    for x, y in zip(replayed, eager):
        assert torch.equal(x, y)
    for x, y in zip(after, r.cache):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_launch_counters_count_replays(cuda_device):
    """Served on graphs, the paged kernels' counters still read layers x
    dispatches: each replay adds what its capture recorded."""
    from paddle_tpu_torch.ops.paged_attention import paged_attention
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                           num_key_value_heads=1, intermediate_size=512)
    m = llama_from_numpy(_state(cfg), cfg, device=cuda_device)
    eng = LLMEngine(m, device=cuda_device, max_batch=2, max_len=32,
                    page_size=4, prefill_chunk=8)
    before = paged_attention.launches
    _serve(eng, _PROMPTS)
    st = eng.runner.program_stats()
    dispatches = eng.prefill_dispatches + st["decode/1"]["runs"]
    assert st["decode/1"]["replays"] > 0 and st["prefill"]["replays"] > 0
    assert all(s["eager"] == 0 for s in st.values())
    assert paged_attention.launches - before == (cfg.num_hidden_layers
                                                 * dispatches)
