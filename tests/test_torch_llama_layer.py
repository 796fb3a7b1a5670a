"""The port's Llama on ``nn.Layer`` (``paddle_tpu_torch/models/llama.py``)
against the JAX package's ``paddle_tpu.models.llama`` on the CPU.

Tiny models are built by the JAX package from a seed; their
``state_dict`` as numpy arrays loads into the port's model through
``set_state_dict`` unchanged (both store ``Linear`` weights ``[in, out]``).
Tolerances, those of ``tests/test_torch_llama.py`` and
``tests/test_torch_gpt2_layer.py`` for the same comparisons: float32
logits at atol 1e-4, the loss at 1e-5 relative, gradients at 5e-4; greedy
tokens exact.  ``generate`` mirrors ``tests/test_serving.py``'s
``TestGenerate`` and ``test_engine_matches_model_generate``, each case
held to the JAX model's own tokens.  One geometry (head_dim 64, S 128)
takes the flash kernels' plain twins (K1-K3) with GQA; the tiny config
(head_dim 16) takes the reference's dense path on both sides.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.nn as jnn
from paddle_tpu.models import llama as jl
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
from _torch_copies import differing_units, statement
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.models import llama as tl

CLASSMETHODS = ("llama3_8b", "qwen2_moe_a14b", "deepseek_moe_16b", "tiny",
                "tiny_moe")
# head_dim 64, S 128: the flash path's shape, GQA 2:1
FLASH = dict(hidden_size=128, num_attention_heads=2, num_key_value_heads=1,
             intermediate_size=256)


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev


def _pair(seed=0, **kw):
    """The JAX model (eval) and the port's holding its weights."""
    pt.seed(seed)
    jm = jl.LlamaForCausalLM(jl.LlamaConfig.tiny(**kw))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tp.seed(seed + 1)
    tm = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(**kw))
    tm.eval()
    missing, unexpected = tm.set_state_dict(state)
    assert not missing and not unexpected
    return jm, tm, state


def _ids(seed, b, s, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


def _np(t):
    return np.asarray(t.numpy())


# ---- surface and copy fidelity ---------------------------------------------
def test_classes_names_and_state_dict_keys_are_the_reference_s():
    for name in ("LlamaConfig", "KVCache", "LlamaAttention", "LlamaMLP",
                 "LlamaDecoderLayer", "LlamaModel", "LlamaForCausalLM",
                 "shard_llama", "causal_lm_loss", "make_decoder_stage",
                 "LlamaEmbeddingPipe", "LlamaDecoderLayerPipe",
                 "LlamaNormHeadPipe", "LlamaForCausalLMPipe", "llama3_8b",
                 "llama_tiny", "llama_tiny_moe"):
        assert hasattr(tl, name), name
    for tied in (False, True):
        jm, tm, state = _pair(tie_word_embeddings=tied)
        assert list(tm.state_dict()) == list(state)
        for n, p in tm.named_parameters():
            assert tuple(p.shape) == state[n].shape, n


@pytest.mark.parametrize("name", CLASSMETHODS)
def test_config_classmethods_match(name):
    assert vars(getattr(tl.LlamaConfig, name)()) == vars(
        getattr(jl.LlamaConfig, name)())
    assert (vars(getattr(tl.LlamaConfig, name)(num_hidden_layers=3))
            == vars(getattr(jl.LlamaConfig, name)(num_hidden_layers=3)))


# the units that differ from the reference's, each for a reason:
DIVERGENT = {
    "__doc__",
    statement("import jax.numpy as jnp"),
    statement("import torch"),
    # the sep group's ring / Ulysses on the kernels, which take grouped K / V
    # as they are (the reference repeats them first); the stacked-stage
    # block in torch on the flash path
    "LlamaAttention.forward", "make_decoder_stage",
    # the partition spec from parallel/_compat (no jax.sharding)
    "shard_llama",
    # the loss over [B, S, V] unflattened (a sequence split over 'sep')
    "causal_lm_loss",
    # the MoE stream's aux seed in torch
    "LlamaEmbeddingPipe.forward",
    # in-place cache writes and offset (queue 3), torch bodies
    "KVCache", "KVCache.__init__", "KVCache.update", "KVCache.reset",
    "_cached_sdpa",
    # the eos bookkeeping and the offset rewind in torch; top-k's where
    "LlamaForCausalLM.generate", "LlamaForCausalLM._sample",
}


def test_copy_matches_the_reference():
    assert differing_units("models/llama.py") == DIVERGENT


# ---- forward, loss, gradients ----------------------------------------------
@pytest.mark.parametrize("geometry", ["tiny", "flash"])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_logits_loss_and_gradients(tied, geometry):
    kw = dict(FLASH) if geometry == "flash" else {}
    s = 128 if geometry == "flash" else 16
    jm, tm, _ = _pair(tie_word_embeddings=tied, **kw)
    jm.train()
    tm.train()
    ids = _ids(1, 2, s + 1)
    x, y = ids[:, :-1], ids[:, 1:]
    jl_, jloss = jm(pt.to_tensor(x), labels=pt.to_tensor(y))
    tl_, tloss = tm(tp.to_tensor(x), labels=tp.to_tensor(y))
    np.testing.assert_allclose(_np(tl_), _np(jl_), atol=1e-4)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    jloss.backward()
    tloss.backward()
    jg = {n: _np(p.grad) for n, p in jm.named_parameters()}
    tg = {n: _np(p.grad) for n, p in tm.named_parameters()}
    assert set(jg) == set(tg)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], atol=5e-4, err_msg=n)


def test_causal_lm_loss_and_aux_term():
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 5, 16).astype(np.float32)
    labels = rng.randint(0, 16, (2, 5)).astype(np.int32)
    aux = np.float32(0.7)
    for extra in (None, aux):
        j = jl.causal_lm_loss(pt.to_tensor(logits), pt.to_tensor(labels), 16,
                              None if extra is None else pt.to_tensor(extra))
        t = tl.causal_lm_loss(tp.to_tensor(logits), tp.to_tensor(labels), 16,
                              None if extra is None else tp.to_tensor(extra))
        np.testing.assert_allclose(float(t), float(j), rtol=1e-5)


# ---- the cache ---------------------------------------------------------------
def test_kv_cache_update_and_prefix():
    """test_serving.py's TestKVCache: the FULL cache comes back and the
    offset tracks the valid prefix."""
    cache = tl.KVCache(2, 16, 4, 8)
    k1 = tp.to_tensor(np.ones((2, 3, 4, 8), np.float32))
    v1 = tp.to_tensor(np.full((2, 3, 4, 8), 2.0, np.float32))
    kk, vv = cache.update(k1, v1)
    assert int(cache.offset) == 3
    assert kk.shape == [2, 16, 4, 8]
    k2 = tp.to_tensor(np.full((2, 1, 4, 8), 5.0, np.float32))
    kk, vv = cache.update(k2, k2)
    assert int(cache.offset) == 4
    np.testing.assert_allclose(_np(kk)[:, :3], 1.0)
    np.testing.assert_allclose(_np(kk)[:, 3], 5.0)
    np.testing.assert_allclose(_np(kk)[:, 4:], 0.0)   # untouched tail
    np.testing.assert_allclose(_np(vv)[:, :3], 2.0)


@pytest.mark.parametrize("heads", [(4, 2), (4, 4)], ids=["gqa", "mha"])
def test_kv_cache_and_cached_sdpa_at_a_nonzero_offset(heads):
    """Two updates (a prompt of 5, then 2 steps) on both packages: the
    caches and the attention of the 2 new rows against the whole cache
    from offset 5, float32 at 1e-5."""
    h, kvh = heads
    rng = np.random.RandomState(3)
    k = [rng.randn(2, n, kvh, 8).astype(np.float32) for n in (5, 2)]
    v = [rng.randn(2, n, kvh, 8).astype(np.float32) for n in (5, 2)]
    q = rng.randn(2, 2, h, 8).astype(np.float32)
    outs = {}
    for pkg, mod in ((pt, jl), (tp, tl)):
        c = mod.KVCache(2, 16, kvh, 8)
        c.update(pkg.to_tensor(k[0]), pkg.to_tensor(v[0]))
        off = c.offset + 0
        kk, vv = c.update(pkg.to_tensor(k[1]), pkg.to_tensor(v[1]))
        o = mod._cached_sdpa(pkg.to_tensor(q), kk, vv, off)
        outs[mod] = (_np(kk), _np(vv), _np(o), int(np.asarray(
            c.offset.numpy())))
    for a, b in zip(outs[tl], outs[jl]):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_cache_writes_in_place_divergence():
    """Queue 3's divergence, pinned: the reference rebinds the cache
    tensors and the offset on every update and rewinds by rebinding; the
    port writes into the same storage, so a captured decode step replays
    against it with no copy-back."""
    cache = tl.KVCache(1, 8, 2, 4)
    bufs = (cache.k._buf, cache.v._buf, cache.offset._buf)
    ptrs = [b.data_ptr() for b in bufs]
    x = tp.to_tensor(np.ones((1, 3, 2, 4), np.float32))
    cache.update(x, x)
    assert (cache.k._buf, cache.v._buf, cache.offset._buf) == bufs
    assert [b.data_ptr() for b in bufs] == ptrs
    cache.reset()
    assert cache.offset._buf is bufs[2] and int(cache.offset) == 0
    # the reference's update rebinds
    jc = jl.KVCache(1, 8, 2, 4)
    before = jc.k._data
    jx = pt.to_tensor(np.ones((1, 3, 2, 4), np.float32))
    jc.update(jx, jx)
    assert jc.k._data is not before
    # generate: the same cache storage from one call to the next
    _, tm, _ = _pair()
    x = tp.to_tensor(_ids(0, 2, 8))
    tm.generate(x, max_new_tokens=3)
    entry = next(iter(tm._gen_states.values()))
    held = [(c.k._buf, c.v._buf, c.offset._buf) for c in entry["caches"]]
    tm.generate(x, max_new_tokens=3)
    assert [(c.k._buf, c.v._buf, c.offset._buf)
            for c in entry["caches"]] == held


def test_new_kv_caches_are_float32_under_a_bf16_model():
    _, tm, _ = _pair()
    tm.to(dtype="bfloat16")
    caches = tm.new_kv_caches(2, 32)
    assert len(caches) == 2
    assert all(c.k.dtype == tp.float32 and c.offset.dtype == tp.int32
               for c in caches)


# ---- generate: test_serving.py's TestGenerate, against the JAX model -------
class TestGenerate:
    def setup_method(self, _):
        self.jm, self.tm, _ = _pair()
        self.x = _ids(0, 2, 8)

    def _both(self, **kw):
        a = _np(self.jm.generate(pt.to_tensor(self.x), **kw))
        b = _np(self.tm.generate(tp.to_tensor(self.x), **kw))
        return a, b

    @pytest.mark.parametrize("use_cache", [True, False])
    def test_greedy_matches_the_reference(self, use_cache):
        a, b = self._both(max_new_tokens=6, use_cache=use_cache)
        assert b.shape == (2, 14)
        np.testing.assert_array_equal(b, a)

    def test_greedy_cache_matches_full_recompute(self):
        x = tp.to_tensor(self.x)
        a = self.tm.generate(x, max_new_tokens=6, use_cache=True)
        b = self.tm.generate(x, max_new_tokens=6, use_cache=False)
        np.testing.assert_array_equal(_np(a), _np(b))

    @pytest.mark.parametrize("k", [1, 4])
    def test_tokens_per_dispatch(self, k):
        """K tokens a dispatch, 7 new (K = 4 overshoots one and trims):
        the reference's tokens."""
        a, b = self._both(max_new_tokens=7, tokens_per_dispatch=k)
        assert b.shape == (2, 15)
        np.testing.assert_array_equal(b, a)

    def test_gen_state_reuse_and_eviction(self):
        m = self.tm
        x = tp.to_tensor(self.x)
        a1 = m.generate(x, max_new_tokens=4)
        states = m._gen_states
        assert len(states) == 1
        key = next(iter(states))
        entry = states[key]
        assert entry["busy"] is False
        a2 = m.generate(x, max_new_tokens=4)
        assert states[key] is entry
        np.testing.assert_array_equal(_np(a1), _np(a2))
        m.generate(x[:1], max_new_tokens=4)
        assert len(m._gen_states) == 2
        # at most 4 entries: the oldest goes first
        for k in (2, 3, 4):
            m.generate(x, max_new_tokens=4, tokens_per_dispatch=k)
        assert len(m._gen_states) == 4 and key not in m._gen_states
        a3 = m.generate(x, max_new_tokens=4)
        np.testing.assert_array_equal(_np(a3), _np(a1))

    def test_generate_reentrant_uses_private_state(self):
        m = self.tm
        x = tp.to_tensor(self.x)
        ref = _np(m.generate(x, max_new_tokens=2))
        entry = next(iter(m._gen_states.values()))
        held = [_np(c.k).copy() for c in entry["caches"]]
        entry["busy"] = True   # an in-flight generate
        try:
            out = m.generate(x, max_new_tokens=2)
            assert out.shape == [2, 10]
            np.testing.assert_array_equal(_np(out), ref)
            assert next(iter(m._gen_states.values())) is entry
            assert len(m._gen_states) == 1
            for c, h in zip(entry["caches"], held):
                np.testing.assert_array_equal(_np(c.k), h)
        finally:
            entry["busy"] = False

    def test_top_p_and_top_k_decode(self):
        x = tp.to_tensor(self.x)
        top_p = self.tm.generate(x, max_new_tokens=4, do_sample=True,
                                 top_p=0.8, temperature=0.9)
        top_k = self.tm.generate(x, max_new_tokens=4, do_sample=True, top_k=5)
        assert top_p.shape == [2, 12] and top_k.shape == [2, 12]
        v = self.tm.config.vocab_size
        assert (_np(top_p) < v).all() and (_np(top_k) < v).all()
        np.testing.assert_array_equal(_np(top_p)[:, :8], self.x)
        # a fixed seed draws alike
        a = self.tm.generate(x, max_new_tokens=4, do_sample=True, top_p=0.8,
                             seed=5)
        b = self.tm.generate(x, max_new_tokens=4, do_sample=True, top_p=0.8,
                             seed=5)
        np.testing.assert_array_equal(_np(a), _np(b))

    def test_eos_early_stop(self):
        first = _np(self.tm.generate(tp.to_tensor(self.x),
                                     max_new_tokens=1))[:, -1]
        eos = int(first[0])
        a, b = self._both(max_new_tokens=16, eos_token_id=eos)
        np.testing.assert_array_equal(b, a)
        assert b.shape[1] < 8 + 16 or (b[0, 9:] == eos).all()
        assert (b[0, 8:] == eos).all()


def test_generate_decode_is_one_program_a_shape():
    """One ``to_static`` of the step per entry, with a prefill signature
    ([B, prompt]) and a decode one ([B, 1]), each one program that runs
    (on the CPU the body runs on its static buffers; on the card the
    decode program replays a CUDA graph)."""
    _, tm, _ = _pair()
    x = tp.to_tensor(_ids(0, 2, 8))
    tm.generate(x, max_new_tokens=5)
    tm.generate(x, max_new_tokens=5)
    step = next(iter(tm._gen_states.values()))["step"]
    shapes = sorted(k.split("|")[1].split(":")[0] for k in step._cache)
    assert shapes == ["T(2, 1)", "T(2, 8)"]
    progs = {k.split("|")[1].split(":")[0]: [v.compiled for v in g.variants]
             for k, g in step._cache.items()}
    assert all(not g.eager_only for g in step._cache.values())
    (dec,) = progs["T(2, 1)"]
    assert dec is not None and dec.stats()["runs"] >= 6
    assert dec.stats()["eager"] == 0


# ---- scan_steps: bench.py's _llama_child step, f32 ----------------------------
def test_scan_steps_adamw_clip_matches_the_reference():
    """``jit.scan_steps(train_step)`` at K = 3 with AdamW(3e-4, decay 0.01)
    and ClipGradByGlobalNorm(1.0), two calls (the spy, then the program),
    tied head, float32: per-step losses and every parameter after 6 steps
    against the JAX package's ``scan_steps`` on the same weights, at rtol
    2e-4 / atol 1e-5, or within 2 lr where a gradient element of the JAX
    model's eager steps was ever under 1e-4 of its tensor's largest (Adam's
    first update is about lr * sign(g)), as ``test_torch_gpt2_layer.py``
    holds its steps."""
    K, lr = 3, 3e-4
    jm, tm, state = _pair(tie_word_embeddings=True)
    je = jl.LlamaForCausalLM(jl.LlamaConfig.tiny(tie_word_embeddings=True))
    je.set_state_dict(state)
    ids = np.random.RandomState(4).randint(0, 256, (K, 2, 17)).astype(
        np.int32)

    def make(pkg, nn, m):
        m.train()
        opt = pkg.optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                                  parameters=m.parameters(),
                                  grad_clip=nn.ClipGradByGlobalNorm(1.0))

        def train_step(x, y):
            _, loss = m(x, labels=y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return opt, train_step

    got = {}
    for pkg, nn, m in ((pt, jnn, jm), (tp, tnn, tm)):
        scan = pkg.jit.scan_steps(make(pkg, nn, m)[1])
        x, y = pkg.to_tensor(ids[:, :, :-1]), pkg.to_tensor(ids[:, :, 1:])
        got[pkg] = list(_np(scan(x, y))) + list(_np(scan(x, y)))
    np.testing.assert_allclose(got[tp], got[pt], rtol=1e-5)
    assert got[tp][-1] < got[tp][0]
    # the JAX model's eager steps: where a gradient element is near zero
    opt, _ = make(pt, jnn, je)
    small = {n: np.zeros(p.shape, bool) for n, p in je.named_parameters()}
    for i in range(2 * K):
        _, loss = je(pt.to_tensor(ids[i % K, :, :-1]),
                     labels=pt.to_tensor(ids[i % K, :, 1:]))
        loss.backward()
        for n, p in je.named_parameters():
            g = np.abs(_np(p.grad))
            small[n] |= g < 1e-4 * g.max()
        opt.step()
        opt.clear_grad()
    jp = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        want, have = _np(jp[n]), _np(p)
        ok = np.isclose(have, want, rtol=2e-4, atol=1e-5) | (
            small[n] & (np.abs(have - want) <= 2 * lr))
        assert ok.all(), (n, np.abs(have - want).max())


# ---- the engine against generate (test_serving.py:212) ---------------------
def test_engine_matches_model_generate():
    """The port's ``LLMEngine`` (on the ``torch.nn`` model of
    ``llama_module``, bridged from the same numpy weights) against the
    port's ``Layer`` ``generate``: the same greedy tokens."""
    from paddle_tpu_torch.inference.engine.core import LLMEngine
    from paddle_tpu_torch.models.convert import llama_from_numpy
    kw = dict(vocab_size=128, hidden_size=64, intermediate_size=176,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=128)
    pt.seed(0)
    jm = jl.LlamaForCausalLM(jl.LlamaConfig(**kw))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    m = tl.LlamaForCausalLM(tl.LlamaConfig(**kw))
    m.eval()
    m.set_state_dict(state)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 128, (n,)).astype(np.int32) for n in (5, 9, 3)]
    ref = [_np(m.generate(tp.to_tensor(p[None, :]),
                          max_new_tokens=6))[0, len(p):].tolist()
           for p in prompts]
    from paddle_tpu_torch.models.llama_module import LlamaConfig
    nn_model = llama_from_numpy(state, LlamaConfig(**kw), device="cpu")
    eng = LLMEngine(nn_model, device="cpu", max_batch=2, max_len=64,
                    page_size=8)
    rids = [eng.add_request(p, max_new_tokens=6) for p in prompts]
    eng.run_until_done()
    for rid, r in zip(rids, ref):
        assert eng.result(rid) == r, (rid, eng.result(rid), r)


# ---- what needed M12, and what still waits for its part 2 --------------------
def _moe_matches_reference(**kw):
    """The MoE Llama builds and holds the reference's logits, loss (the
    aux term included) and gradients from the same weights."""
    jm, tm, _ = _pair(**kw)
    assert tm.llama.layers[0].mlp.num_experts == jm.llama.layers[0].mlp.num_experts
    jm.train()
    tm.train()
    ids = _ids(3, 2, 17)
    jl_, jloss = jm(pt.to_tensor(ids[:, :-1]), labels=pt.to_tensor(ids[:, 1:]))
    tl_, tloss = tm(tp.to_tensor(ids[:, :-1]), labels=tp.to_tensor(ids[:, 1:]))
    np.testing.assert_allclose(_np(tl_), _np(jl_), atol=1e-4)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    jloss.backward()
    tloss.backward()
    for (n, jp), (_, tp_) in zip(jm.named_parameters(), tm.named_parameters()):
        np.testing.assert_allclose(_np(tp_.grad), _np(jp.grad), atol=5e-4,
                                   err_msg=n)


def _shard_llama_on_one_rank():
    """``shard_llama`` on a one-rank topology is the identity (the
    reference's one-device mesh): the model comes back unsharded."""
    from paddle_tpu_torch.distributed.fleet.topology import \
        get_hybrid_communicate_group
    m = tl.llama_tiny()
    out = tl.shard_llama(m, get_hybrid_communicate_group().get_mesh())
    assert out is m
    assert not any(p.is_dist() for p in m.parameters())


def _pieces_match(jpiece, tpiece, inputs):
    """A pipe piece of each package holding the JAX one's seeded weights:
    the same outputs on the same inputs (logits at the file's atol)."""
    pt.seed(0)
    jm = jpiece()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tpiece()
    missing, unexpected = tm.set_state_dict(state)
    assert not missing and not unexpected
    jo, to = jm(inputs(pt)), tm(inputs(tp))
    for a, b in zip(jo if isinstance(jo, tuple) else (jo,),
                    to if isinstance(to, tuple) else (to,)):
        np.testing.assert_allclose(_np(b), _np(a), atol=1e-4, rtol=1e-5)
    return jm, tm


def _decoder_stage_matches():
    """make_decoder_stage's apply from the JAX stage's stacked weights (as
    numpy) against the JAX apply; its init draws the same shapes from a
    torch.Generator."""
    import jax
    import jax.numpy as jnp
    import torch
    jinit, japply = jl.make_decoder_stage(jl.LlamaConfig.tiny())
    tinit, tapply = tl.make_decoder_stage(tl.LlamaConfig.tiny())
    p = jinit(jax.random.PRNGKey(0))
    x = np.random.RandomState(0).rand(2, 16, 64).astype(np.float32)
    want = np.asarray(japply(p, jnp.asarray(x)))
    got = tapply({k: torch.tensor(np.asarray(v)) for k, v in p.items()},
                 torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    drawn = tinit(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in drawn.items()} == \
        {k: tuple(v.shape) for k, v in p.items()}


def _ids_in(pkg):
    return pkg.to_tensor(_ids(2, 2, 8))


def _hidden_in(pkg, aux=False):
    h = pkg.to_tensor(np.random.RandomState(5).rand(2, 8, 64).astype(
        np.float32))
    return (h, pkg.to_tensor(np.float32(0.25))) if aux else h


@pytest.mark.parametrize("case", [
    lambda: _moe_matches_reference(num_experts=4),
    lambda: (_moe_matches_reference(num_experts=4),
             tl.llama_tiny_moe().llama.layers[1].mlp.top_k == 2),
    lambda: _moe_matches_reference(num_experts=2),
    _shard_llama_on_one_rank,
    _decoder_stage_matches,
    lambda: _pieces_match(
        lambda: jl.LlamaEmbeddingPipe(jl.LlamaConfig.tiny(), emit_aux=True),
        lambda: tl.LlamaEmbeddingPipe(tl.LlamaConfig.tiny(), emit_aux=True),
        _ids_in),
    lambda: _pieces_match(
        lambda: jl.LlamaDecoderLayerPipe(jl.LlamaConfig.tiny_moe()),
        lambda: tl.LlamaDecoderLayerPipe(tl.LlamaConfig.tiny_moe()),
        lambda pkg: _hidden_in(pkg, aux=True)),
    lambda: _pieces_match(
        lambda: jl.LlamaNormHeadPipe(jl.LlamaConfig.tiny()),
        lambda: tl.LlamaNormHeadPipe(tl.LlamaConfig.tiny()), _hidden_in),
    lambda: _pieces_match(
        lambda: jl.LlamaForCausalLMPipe(jl.LlamaConfig.tiny()),
        lambda: tl.LlamaForCausalLMPipe(tl.LlamaConfig.tiny()), _ids_in),
], ids=["tiny_moe", "llama_tiny_moe", "num_experts", "shard_llama",
        "make_decoder_stage", "embedding_pipe", "decoder_pipe", "head_pipe",
        "causal_lm_pipe"])
def test_what_needs_m12_raises(case):
    """Since M12's first part the MoE Llama and ``shard_llama`` work (held
    to the reference here, sharded across ranks in
    ``test_torch_hybrid_llama.py``); since its second, the pipeline pieces
    do: each is held to the reference's on the same weights and inputs
    (the schedules in ``test_torch_pipeline.py``)."""
    case()


def test_moe_configs_build_and_a_sep_group_raises(monkeypatch):
    """The MoE configs build (the full ones stay configs here: too large to
    make on the CPU); a sequence-parallel group larger than 1 in a process
    of its own (no process group: a group of one) takes the plain
    attention and gives the same logits (the ring over launched ranks is
    held in ``test_torch_sequence_parallel.py``)."""
    from paddle_tpu_torch.distributed.fleet import topology
    for name in ("qwen2_moe_a14b", "deepseek_moe_16b", "tiny_moe"):
        assert getattr(tl.LlamaConfig, name)().num_experts > 0
    assert tl.llama_tiny_moe().llama.layers[0].mlp.num_experts == 4
    m = tl.llama_tiny()
    x = tp.to_tensor(_ids(0, 1, 4))
    plain = m(x)
    assert plain.shape == [1, 4, 256]
    hcg = topology.HybridCommunicateGroup(
        topology.CommunicateTopology(dims=[1, 1, 1, 2, 1, 1]), rank=0)
    monkeypatch.setattr(topology, "_hcg", hcg)
    np.testing.assert_allclose(_np(m(x)), _np(plain), rtol=1e-6, atol=1e-6)