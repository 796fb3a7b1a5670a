"""The port's Transformer layers (``paddle_tpu_torch/nn/layer/transformer.py``),
its ERNIE family (``models/ernie.py``) and the Layer GPT-2's ``generate``
against the JAX package's, on the CPU.

Each port layer loads the JAX layer's ``state_dict`` as numpy arrays.
Tolerances, those of ``tests/test_torch_gpt2_layer.py`` for the same
comparison: float32 outputs and losses at rtol 1e-5 / atol 1e-4, gradients
at 5e-4 absolute, parameters after AdamW at rtol 2e-4 / atol 1e-5 (or
within 2 lr where a gradient element was under 1e-4 of its tensor's
largest).  The JAX package attends through its dense path on the CPU; the
port through the flash kernels' plain twins wherever the shape passes
``supported`` (S % 128, head_dim % 64) and there is no mask and no
dropout, else through the same dense path.
"""
import copy

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.nn as jnn
from paddle_tpu.models import ernie as jernie
from paddle_tpu.models import gpt2 as jgpt2
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.models import ernie as ternie
from paddle_tpu_torch.models import gpt2 as tgpt2
from paddle_tpu_torch.ops import flash_attention as fa

OUT = dict(rtol=1e-5, atol=1e-4)
GRAD_ATOL = 5e-4


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev


@pytest.fixture
def flash_twins(monkeypatch):
    """Counts the port's calls of the flash forward's plain twin by
    ``causal``."""
    calls = {True: 0, False: 0}
    ref = fa.flash_fwd_ref

    def counted(q, k, v, causal=True, scale=None):
        calls[bool(causal)] += 1
        return ref(q, k, v, causal, scale)
    monkeypatch.setattr(fa, "flash_fwd_ref", counted)
    return calls


def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _load(tlayer, jlayer):
    missing, unexpected = tlayer.set_state_dict(_state(jlayer))
    assert not missing and not unexpected
    assert list(tlayer.state_dict()) == list(jlayer.state_dict())
    return tlayer


def _u(*shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _np(t):
    return np.asarray(t.numpy())


def _grads(layer):
    return {n: _np(p.grad) for n, p in layer.named_parameters()
            if p.grad is not None}


def _hold_grads(tl, jl):
    tg, jg = _grads(tl), _grads(jl)
    assert set(tg) == set(jg) and tg
    for n, g in jg.items():
        np.testing.assert_allclose(tg[n], g, atol=GRAD_ATOL, rtol=0,
                                   err_msg=n)


def _mask(b, sq, sk, seed):
    m = np.where(np.random.RandomState(seed).rand(b, 1, sq, sk) < 0.2,
                 -1e4, 0.0).astype(np.float32)
    m[..., 0] = 0.0
    return m


# ----------------------------------------------------------- MultiHeadAttention
@pytest.mark.parametrize("case", ["self", "self-mask", "cross", "kvdim"])
def test_multi_head_attention_matches_jax(case):
    pt.seed(0)
    kw = {"kdim": 12, "vdim": 20} if case == "kvdim" else {}
    jm = jnn.MultiHeadAttention(16, 4, **kw)
    tm = _load(tnn.MultiHeadAttention(16, 4, **kw), jm)
    q = _u(2, 5, 16)
    key = {"cross": _u(2, 7, 16, seed=1), "kvdim": _u(2, 7, 12, seed=1)}.get(
        case)
    value = {"cross": _u(2, 7, 16, seed=2), "kvdim": _u(2, 7, 20, seed=2)}.get(
        case)
    mask = _mask(2, 5, 5, 3) if case == "self-mask" else None
    outs = []
    for pkg, m in ((tp, tm), (pt, jm)):
        qt = pkg.to_tensor(q)
        qt.stop_gradient = False
        args = [qt, None if key is None else pkg.to_tensor(key),
                None if value is None else pkg.to_tensor(value),
                None if mask is None else pkg.to_tensor(mask)]
        out = m(*args)
        (out * out).sum().backward()
        outs.append((_np(out), _np(qt.grad)))
    np.testing.assert_allclose(outs[0][0], outs[1][0], **OUT)
    np.testing.assert_allclose(outs[0][1], outs[1][1], atol=GRAD_ATOL)
    _hold_grads(tm, jm)


def test_multi_head_attention_caches_match_jax():
    """An incremental ``Cache`` (three decode steps from an empty cache)
    and a ``StaticCache`` over a memory."""
    pt.seed(1)
    jm = jnn.MultiHeadAttention(16, 2)
    tm = _load(tnn.MultiHeadAttention(16, 2), jm)
    steps = [_u(2, 1, 16, seed=s) for s in range(3)]
    mem = _u(2, 6, 16, seed=9)
    res = []
    for pkg, m in ((tp, tm), (pt, jm)):
        cache = m.gen_cache(pkg.to_tensor(steps[0]))
        assert isinstance(cache, m.Cache) and cache.k.shape == [2, 0, 2, 8]
        outs = []
        for s in steps:
            out, cache = m(pkg.to_tensor(s), cache=cache)
            outs.append(_np(out))
        static = m.gen_cache(pkg.to_tensor(mem), type=m.StaticCache)
        assert isinstance(static, m.StaticCache)
        out, same = m(pkg.to_tensor(steps[0]), pkg.to_tensor(mem),
                      pkg.to_tensor(mem), cache=static)
        assert same is static
        res.append((outs, _np(cache.k), _np(out)))
    for a, b in zip(res[0][0], res[1][0]):
        np.testing.assert_allclose(a, b, **OUT)
    assert res[0][1].shape == (2, 3, 2, 8)
    np.testing.assert_allclose(res[0][1], res[1][1], **OUT)
    np.testing.assert_allclose(res[0][2], res[1][2], **OUT)


# ----------------------------------------------------- encoder / decoder layers
@pytest.mark.parametrize("pre_ln", [False, True])
@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_encoder_layer_and_encoder_match_jax(pre_ln, act):
    pt.seed(2)
    jl = jnn.TransformerEncoderLayer(16, 2, 32, dropout=0.0, activation=act,
                                     normalize_before=pre_ln)
    je = jnn.TransformerEncoder(jl, 3, norm=jnn.LayerNorm(16) if pre_ln
                                else None)
    tl = tnn.TransformerEncoderLayer(16, 2, 32, dropout=0.0, activation=act,
                                     normalize_before=pre_ln)
    te = _load(tnn.TransformerEncoder(tl, 3, norm=tnn.LayerNorm(16) if pre_ln
                                      else None), je)
    x, mask = _u(2, 6, 16), _mask(2, 6, 6, 4)
    outs = []
    for pkg, m in ((tp, te), (pt, je)):
        xt = pkg.to_tensor(x)
        xt.stop_gradient = False
        out = m(xt, pkg.to_tensor(mask))
        (out * out).sum().backward()
        outs.append((_np(out), _np(xt.grad)))
    np.testing.assert_allclose(outs[0][0], outs[1][0], **OUT)
    np.testing.assert_allclose(outs[0][1], outs[1][1], atol=GRAD_ATOL)
    _hold_grads(te, je)


def test_encoder_with_caches_matches_jax():
    pt.seed(3)
    je = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(16, 2, 32,
                                                            dropout=0.0), 2)
    te = _load(tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
        16, 2, 32, dropout=0.0), 2), je)
    x = _u(1, 3, 16)
    res = []
    for pkg, m in ((tp, te), (pt, je)):
        caches = [lay.self_attn.gen_cache(pkg.to_tensor(x))
                  for lay in m.layers]
        out, new = m(pkg.to_tensor(x), cache=caches)
        res.append((_np(out), [_np(c.k) for c in new]))
    np.testing.assert_allclose(res[0][0], res[1][0], **OUT)
    for a, b in zip(res[0][1], res[1][1]):
        np.testing.assert_allclose(a, b, **OUT)


@pytest.mark.parametrize("pre_ln", [False, True])
def test_decoder_layer_and_decoder_match_jax(pre_ln):
    pt.seed(4)
    jl = jnn.TransformerDecoderLayer(16, 2, 32, dropout=0.0,
                                     normalize_before=pre_ln)
    jd = jnn.TransformerDecoder(jl, 2, norm=jnn.LayerNorm(16) if pre_ln
                                else None)
    td = _load(tnn.TransformerDecoder(
        tnn.TransformerDecoderLayer(16, 2, 32, dropout=0.0,
                                    normalize_before=pre_ln), 2,
        norm=tnn.LayerNorm(16) if pre_ln else None), jd)
    tgt, mem = _u(2, 5, 16), _u(2, 7, 16, seed=1)
    outs = []
    for pkg, m in ((tp, td), (pt, jd)):
        causal = pkg.nn.Transformer.generate_square_subsequent_mask(5)
        t, mm = pkg.to_tensor(tgt), pkg.to_tensor(mem)
        t.stop_gradient = mm.stop_gradient = False
        out = m(t, mm, causal, pkg.to_tensor(_mask(2, 5, 7, 5)))
        (out * out).sum().backward()
        outs.append((_np(out), _np(t.grad), _np(mm.grad)))
    for a, b in zip(outs[0][1:], outs[1][1:]):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL)
    np.testing.assert_allclose(outs[0][0], outs[1][0], **OUT)
    _hold_grads(td, jd)


def test_transformer_matches_jax_and_its_mask_is_the_reference_s():
    pt.seed(5)
    jm = jnn.Transformer(16, 2, 2, 2, 32, dropout=0.0)
    tm = _load(tnn.Transformer(16, 2, 2, 2, 32, dropout=0.0), jm)
    want_mask = _np(jnn.Transformer.generate_square_subsequent_mask(4))
    got_mask = tnn.Transformer.generate_square_subsequent_mask(4)
    assert got_mask.dtype == tp.float32 and got_mask.place.is_cpu_place()
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    src, tgt = _u(2, 6, 16), _u(2, 4, 16, seed=1)
    outs = []
    for pkg, m in ((tp, tm), (pt, jm)):
        mask = m.generate_square_subsequent_mask(4)
        out = m(pkg.to_tensor(src), pkg.to_tensor(tgt), tgt_mask=mask)
        out.sum().backward()
        outs.append(_np(out))
    np.testing.assert_allclose(outs[0], outs[1], **OUT)
    _hold_grads(tm, jm)


def test_deep_copied_layers_are_independent_trainable_leaves():
    """``TransformerEncoder`` deep-copies its layer: each copy's parameters
    are new leaves with their own storage, an optimizer sees all of them,
    and a step moves each by its own gradient."""
    tp.seed(0)
    layer = tnn.TransformerEncoderLayer(16, 2, 32, dropout=0.0)
    enc = tnn.TransformerEncoder(layer, 4)
    assert enc.layers[0] is layer
    per = len(layer.parameters())
    params = enc.parameters()
    assert len(params) == 4 * per
    assert len({id(p) for p in params}) == 4 * per
    assert len({p._buf.data_ptr() for p in params}) == 4 * per
    assert all(isinstance(p, tp.Parameter) and p.is_leaf
               and not p.stop_gradient for p in params)
    w0 = [lay.linear1.weight.numpy().copy() for lay in enc.layers]
    for w in w0[1:]:
        np.testing.assert_array_equal(w, w0[0])      # copies start equal
    opt = tp.optimizer.SGD(learning_rate=0.5, parameters=params)
    enc(tp.to_tensor(_u(2, 5, 16))).square().sum().backward()
    grads = [lay.linear1.weight.grad.numpy() for lay in enc.layers]
    assert not np.allclose(grads[0], grads[1])
    opt.step()
    for lay, w, g in zip(enc.layers, w0, grads):
        np.testing.assert_allclose(lay.linear1.weight.numpy(), w - 0.5 * g,
                                   rtol=1e-6, atol=1e-7)
    # writing one copy leaves the others
    enc.layers[1].linear1.weight.set_value(np.zeros((16, 32), np.float32))
    assert np.abs(enc.layers[2].linear1.weight.numpy()).max() > 0
    # a deep copy of a whole model is independent too
    twin = copy.deepcopy(enc)
    assert not {id(p) for p in twin.parameters()} & {id(p) for p in params}


# ------------------------------------------------------------------- ERNIE
TINY = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            task_type_vocab_size=3)


def _ernie_pair(cls, seed=0, num_classes=None, **kw):
    pt.seed(seed)
    cfg = dict(TINY, **kw)
    extra = {} if num_classes is None else {"num_classes": num_classes}
    jm = getattr(jernie, cls)(jernie.ErnieConfig.tiny(**cfg), **extra)
    tp.seed(seed + 1)
    tm = getattr(ternie, cls)(ternie.ErnieConfig.tiny(**cfg), **extra)
    _load(tm, jm)
    return jm, tm


def _ernie_batch(b=2, s=12, seed=0, vocab=256):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, vocab, (b, s)).astype(np.int64)
    tt = np.zeros((b, s), np.int64)
    tt[:, s // 2:] = 1
    labels = np.full((b, s), -100, np.int64)
    pick = rng.rand(b, s) < 0.3
    labels[pick] = rng.randint(1, vocab, pick.sum())
    return ids, tt, labels


def test_ernie_config_and_names_are_the_reference_s():
    for kw in ({}, {"hidden_dropout_prob": 0.0}):
        assert vars(ternie.ErnieConfig.base(**kw)) == vars(
            jernie.ErnieConfig.base(**kw))
        assert vars(ternie.ErnieConfig.tiny(**kw)) == vars(
            jernie.ErnieConfig.tiny(**kw))
    jm, tm = _ernie_pair("ErnieForMaskedLM")
    bias = tm.decoder_bias
    assert isinstance(bias, tp.Parameter) and bias.dtype == tp.float32
    assert bias.place.is_cpu_place() and not bias.stop_gradient
    assert "decoder_bias" in tm.state_dict()


@pytest.mark.parametrize("masked", [False, True])
def test_ernie_model_sequence_and_pooled_match_jax(masked):
    jm, tm = _ernie_pair("ErnieModel", 1)
    jm.eval()
    tm.eval()
    ids, tt, _ = _ernie_batch(seed=2)
    mask = np.ones(ids.shape, np.float32)
    mask[1, 8:] = 0.0
    kw = lambda pkg: {"token_type_ids": pkg.to_tensor(tt),  # noqa: E731
                      "task_type_ids": pkg.to_tensor(np.ones_like(tt)),
                      "attention_mask": pkg.to_tensor(mask) if masked
                      else None}
    ts, tpool = tm(tp.to_tensor(ids), **kw(tp))
    js, jpool = jm(pt.to_tensor(ids), **kw(pt))
    np.testing.assert_allclose(ts.numpy(), _np(js), **OUT)
    np.testing.assert_allclose(tpool.numpy(), _np(jpool), **OUT)


def test_ernie_mlm_logits_loss_gradients_and_an_adamw_step_match_jax():
    jm, tm = _ernie_pair("ErnieForMaskedLM", 3)
    ids, tt, labels = _ernie_batch(seed=4)
    lr = 1e-3
    jopt = pt.optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                              parameters=jm.parameters(),
                              grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    topt = tp.optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                              parameters=tm.parameters(),
                              grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    jlog, jl = jm(pt.to_tensor(ids), pt.to_tensor(tt),
                  labels=pt.to_tensor(labels))
    tlog, tl = tm(tp.to_tensor(ids), tp.to_tensor(tt),
                  labels=tp.to_tensor(labels))
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), **OUT)
    np.testing.assert_allclose(tl.item(), jl.item(), rtol=1e-5)
    jl.backward()
    tl.backward()
    _hold_grads(tm, jm)
    small = {n: np.abs(g) < 1e-4 * np.abs(g).max()
             for n, g in _grads(jm).items()}
    jopt.step()
    topt.step()
    jp = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        want, got = _np(jp[n]), p.numpy()
        ok = np.isclose(got, want, rtol=2e-4, atol=1e-5)
        if n in small:
            ok |= small[n] & (np.abs(got - want) <= 2 * lr)
        assert ok.all(), (n, np.abs(got - want).max())


def test_ernie_classifier_matches_jax():
    jm, tm = _ernie_pair("ErnieForSequenceClassification", 5, num_classes=3)
    ids, tt, _ = _ernie_batch(b=4, seed=6)
    y = np.array([0, 2, 1, 2], np.int64)
    jlog, jl = jm(pt.to_tensor(ids), labels=pt.to_tensor(y))
    tlog, tl = tm(tp.to_tensor(ids), labels=tp.to_tensor(y))
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), **OUT)
    np.testing.assert_allclose(tl.item(), jl.item(), rtol=1e-5)
    jl.backward()
    tl.backward()
    _hold_grads(tm, jm)


def test_ernie_at_head_dim_64_takes_the_flash_twins_non_causally(flash_twins):
    """Head_dim 64 and S 128 pass ``supported``: the port's mask-free
    encoder attends through the flash forward's plain twin, non-causally,
    once a layer, where the JAX package runs ``_sdpa_ref``; with a mask the
    port takes the dense path and the twin is not called."""
    jm, tm = _ernie_pair("ErnieForMaskedLM", 7, hidden_size=128,
                         num_attention_heads=2, max_position_embeddings=128)
    ids, tt, labels = _ernie_batch(b=2, s=128, seed=8)
    jlog, jl = jm(pt.to_tensor(ids), pt.to_tensor(tt),
                  labels=pt.to_tensor(labels))
    tlog, tl = tm(tp.to_tensor(ids), tp.to_tensor(tt),
                  labels=tp.to_tensor(labels))
    assert flash_twins == {True: 0, False: 2}
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), **OUT)
    np.testing.assert_allclose(tl.item(), jl.item(), rtol=1e-5)
    jl.backward()
    tl.backward()
    _hold_grads(tm, jm)
    mask = np.ones(ids.shape, np.float32)
    tm(tp.to_tensor(ids), attention_mask=tp.to_tensor(mask))
    assert flash_twins == {True: 0, False: 2}


# ------------------------------------------ tests/test_ernie.py, on the port
def _ids(b=2, s=12, vocab=256, seed=0):
    rng = np.random.RandomState(seed)
    return tp.to_tensor(rng.randint(1, vocab, (b, s)).astype(np.int64))


class TestErnieCases:
    def test_forward_shapes_and_pooler(self):
        tp.seed(0)
        cfg = ternie.ErnieConfig.tiny(task_type_vocab_size=3)
        m = ternie.ErnieModel(cfg)
        m.eval()
        seq, pooled = m(_ids())
        assert seq.shape == [2, 12, 64] and pooled.shape == [2, 64]
        assert np.isfinite(seq.numpy()).all()
        # tanh pooler is bounded
        assert (np.abs(pooled.numpy()) <= 1.0 + 1e-6).all()

    def test_padding_mask_blocks_pad_influence(self):
        """Changing PAD-position token ids must not change unpadded outputs."""
        tp.seed(0)
        cfg = ternie.ErnieConfig.tiny()
        m = ternie.ErnieModel(cfg)
        m.eval()
        rng = np.random.RandomState(1)
        ids = rng.randint(1, 256, (1, 10)).astype(np.int64)
        mask = np.ones((1, 10), np.float32)
        mask[0, 7:] = 0.0
        a = m(tp.to_tensor(ids), attention_mask=tp.to_tensor(mask))[0].numpy()
        ids2 = ids.copy()
        ids2[0, 7:] = rng.randint(1, 256, (3,))
        b = m(tp.to_tensor(ids2), attention_mask=tp.to_tensor(mask))[0].numpy()
        np.testing.assert_allclose(a[0, :7], b[0, :7], atol=1e-5)

    def test_mlm_head_tied_and_trains(self):
        tp.seed(0)
        cfg = ternie.ErnieConfig.tiny()
        m = ternie.ErnieForMaskedLM(cfg)
        opt = tp.optimizer.AdamW(learning_rate=1e-3, parameters=m.parameters())
        rng = np.random.RandomState(2)
        ids = rng.randint(1, 256, (2, 16)).astype(np.int64)
        labels = np.full((2, 16), -100, np.int64)
        labels[:, 3:8] = rng.randint(1, 256, (2, 5))
        x, y = tp.to_tensor(ids), tp.to_tensor(labels)
        losses = []
        for _ in range(8):
            _, loss = m(x, labels=y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())
        assert losses[-1] < losses[0]
        # decoder is tied to the word embeddings (no separate [V,H] matrix)
        n_vh = sum(1 for _, p in m.named_parameters()
                   if list(p.shape) == [cfg.vocab_size, cfg.hidden_size])
        assert n_vh == 1

    def test_classifier_trains_under_to_static(self):
        tp.seed(0)
        cfg = ternie.ErnieConfig.tiny(hidden_dropout_prob=0.0,
                                      attention_probs_dropout_prob=0.0)
        m = ternie.ErnieForSequenceClassification(cfg, num_classes=3)
        opt = tp.optimizer.AdamW(learning_rate=2e-3, parameters=m.parameters())
        rng = np.random.RandomState(3)
        x = tp.to_tensor(rng.randint(1, 256, (8, 10)).astype(np.int64))
        y = tp.to_tensor(rng.randint(0, 3, (8,)).astype(np.int64))

        def step(x, y):
            _, loss = m(x, labels=y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        static = tp.jit.to_static(step)
        losses = [static(x, y).item() for _ in range(10)]
        assert losses[-1] < losses[0] * 0.9, (losses[0], losses[-1])
        assert all(v.compiled is not None and not g.eager_only
                   for g in static._cache.values() for v in g.variants)


# ------------------------------------------------------------ GPT-2 generate
GPT2 = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=1,
            max_position_embeddings=256, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0)


def _gpt2_pair(seed):
    pt.seed(seed)
    jm = jgpt2.GPT2ForCausalLM(jgpt2.GPT2Config(**GPT2))
    tp.seed(seed + 1)
    tm = tgpt2.GPT2ForCausalLM(tgpt2.GPT2Config(**GPT2))
    _load(tm, jm)
    return jm, tm


def test_generate_top_k_1_is_token_exact_with_jax(flash_twins):
    """Greedy ``generate`` (``top_k=1``: a one-hot ``probs``, which both
    packages' ``multinomial`` draw deterministically) from 120-token prompts
    for 12 tokens: the context crosses 128, the one length where the port's
    forward takes the flash twin (causally, a layer)."""
    jm, tm = _gpt2_pair(0)
    prompt = np.random.RandomState(1).randint(0, 256, (2, 120)).astype(
        np.int32)
    want = _np(jm.generate(pt.to_tensor(prompt), max_new_tokens=12,
                           top_k=1))
    got = tm.generate(tp.to_tensor(prompt), max_new_tokens=12, top_k=1)
    assert got.shape == [2, 132]
    np.testing.assert_array_equal(got.numpy(), want)
    assert flash_twins == {True: 2, False: 0}
    # the same tokens as a plain greedy loop over the port's logits
    ctx = tp.to_tensor(prompt)
    with tp.no_grad():
        for _ in range(12):
            nxt = tm(ctx)[:, -1, :].argmax(axis=-1, keepdim=True)
            ctx = tp.concat([ctx, nxt.astype(ctx.dtype)], axis=1)
    np.testing.assert_array_equal(ctx.numpy(), want)


def test_generate_top_k_sampling_stays_in_the_top_k_and_repeats():
    _, tm = _gpt2_pair(2)
    prompt = tp.to_tensor(np.random.RandomState(3).randint(
        0, 256, (3, 10)).astype(np.int32))
    tp.seed(7)
    a = tm.generate(prompt, max_new_tokens=6, top_k=5, temperature=0.8)
    tp.seed(7)
    b = tm.generate(prompt, max_new_tokens=6, top_k=5, temperature=0.8)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    seq = a.numpy()
    with tp.no_grad():
        for t in range(10, 16):
            logits = tm(tp.to_tensor(seq[:, :t])).numpy()[:, -1]
            top = np.argsort(-logits, -1)[:, :5]
            assert all(seq[i, t] in top[i] for i in range(3)), t
