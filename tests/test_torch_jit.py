"""``paddle_tpu_torch.jit.to_static`` / ``scan_steps`` against the JAX
package's, on the CPU: a twin of each of ``tests/test_jit.py``'s 13 tests,
plus a tiny GPT-2 ``Layer`` step under both against the JAX package's.

Each twin runs the reference's program on both packages from the same
numpy weights and inputs (a JAX layer is built from the seed, its
``state_dict`` loads into the port's) and holds the port at the reference
test's tolerance: against the JAX package's captured step, and against the
port's own eager step.  Dropout draws are compared only within the port
(``torch.Generator`` cannot reproduce threefry keys).

On the CPU a captured variant runs its body on each call (``jit/to_static``
docstring): where the reference asserts that the Python body did not run
in steady state, the twin asserts the variants' structure (``variants``,
``eager_only``, each program's runs and captures), and the body count is
asserted by a ``cuda``-marked twin that skips here and runs on the card.
"""
import logging

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.core import device as tdevice


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev


# units of jit/to_static.py and jit/__init__.py kept as the reference's
# (the rest is rewritten for graphs, see jit/to_static.py's docstring)
SAME = {"jit/to_static.py": {
    "MissedCapture", "MissedCapture.__init__", "EchoMismatch",
    "EchoPlaceholderTensor.numpy", "EchoPlaceholderTensor._convert_scalar",
    "EchoPlaceholderTensor._post_echo_error", "_SigGroup", "_SigGroup.__init__",
    "_guard_ints", "_is_tensor", "StaticFunction", "StaticFunction.__get__",
    "StaticFunction.function", "ScanStaticFunction.__init__",
    "_EchoContext._next_kind", "_EchoContext.finish", "_EchoContext.on_scalar",
    "_EchoContext.on_materialize", "_EchoContext.on_create",
    "_EchoContext.on_read", "to_static", "not_to_static"},
    "jit/__init__.py": {"InputSpec", "InputSpec.__init__", "InputSpec.__repr__",
                        "InputSpec.from_tensor", "enable_to_static",
                        "_code_level_value"}}


@pytest.mark.parametrize("path", sorted(SAME))
def test_kept_units_are_the_reference_s(path):
    from _torch_copies import differing_units
    assert not SAME[path] & differing_units(path)


def test_export_is_refused_until_the_port_has_a_format():
    for fn in (lambda: tp.jit.save(None, "x"), lambda: tp.jit.load("x")):
        with pytest.raises(NotImplementedError, match="jit.save / jit.load"):
            fn()
    assert {"to_static", "not_to_static", "StaticFunction", "scan_steps",
            "ScanStaticFunction", "InputSpec", "enable_to_static",
            "ignore_module", "set_verbosity", "set_code_level",
            "CapturedProgram", "graph_pool"} <= set(dir(tp.jit))
    spec = tp.jit.InputSpec([None, 4], "float32", "x")
    assert spec.shape == [None, 4] and spec.dtype == torch.float32


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = tdevice._current_device
    tp.set_device("gpu")
    return prev


def _bridge(jlayer, tlayer):
    missing, unexpected = tlayer.set_state_dict(
        {k: np.asarray(v.numpy()) for k, v in jlayer.state_dict().items()})
    assert not missing and not unexpected
    return tlayer


def _linears(seed, i, o):
    """A JAX Linear from the seed and two port Linears holding its weights
    (one captured, one eager)."""
    pt.seed(seed)
    jl = jnn.Linear(i, o)
    return jl, _bridge(jl, tnn.Linear(i, o)), _bridge(jl, tnn.Linear(i, o))


def _problem(seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(8, 4).astype(np.float32), rng.rand(8, 2).astype(np.float32)


def _np(t):
    return np.asarray(t.numpy(), np.float32)


def _compiled(static):
    return all(v.compiled is not None and not g.eager_only
               for g in static._cache.values() for v in g.variants)


def _mse_step(pkg, lin, opt):
    def step(x, y):
        loss = ((lin(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return step


def test_static_matches_eager_train_loop():
    xn, yn = _problem()
    jl, tl, te = _linears(0, 4, 2)
    runs = {}
    for tag, pkg, lin, static in (("jax", pt, jl, True), ("port", tp, tl, True),
                                  ("eager", tp, te, False)):
        opt = pkg.optimizer.SGD(learning_rate=0.1, parameters=lin.parameters())
        step = _mse_step(pkg, lin, opt)
        fn = pkg.jit.to_static(step) if static else step
        x, y = pkg.to_tensor(xn), pkg.to_tensor(yn)
        runs[tag] = [float(_np(fn(x, y))) for _ in range(4)]
        if tag == "port":
            assert _compiled(fn)
    np.testing.assert_allclose(runs["port"], runs["jax"], rtol=1e-5)
    np.testing.assert_allclose(runs["port"], runs["eager"], rtol=1e-5)


def _accum(lin):
    def accum_step(x, y):
        loss = ((lin(x) - y) ** 2).mean()
        loss.backward()          # accumulates into existing grads
        return loss
    return accum_step


def test_grad_accumulation_lifts_grads_as_inputs():
    """With clear_grad OUTSIDE the captured fn, pre-existing grads are the
    program's inputs (staged into its buffers), not capture-time values."""
    xn, yn = _problem()
    jl, tl, te = _linears(0, 4, 2)
    jstatic = pt.jit.to_static(_accum(jl))
    static = tp.jit.to_static(_accum(tl))
    ref_step = _accum(te)
    jx, jy = pt.to_tensor(xn), pt.to_tensor(yn)
    x, y = tp.to_tensor(xn), tp.to_tensor(yn)
    for i in range(4):
        jstatic(jx, jy)
        static(x, y)
        ref_step(x, y)
        w_g = _np(tl.weight.grad)
        np.testing.assert_allclose(w_g, _np(te.weight.grad), rtol=1e-5,
                                   err_msg=f"accumulated grads diverge at step {i}")
        np.testing.assert_allclose(w_g, _np(jl.weight.grad), rtol=1e-5)
    # grads really accumulated (about 4x one step's grad), not frozen
    static_once = _np(tl.weight.grad)
    tl.weight.clear_grad()
    static(x, y)
    one = _np(tl.weight.grad)
    np.testing.assert_allclose(static_once, 4 * one, rtol=1e-4)
    (group,) = static._cache.values()
    assert not group.eager_only and group.variants


def test_grad_accumulation_then_clear_retraces():
    """Clearing grads after capture re-spies (the gradient state the
    program was captured against changed), never reuses stale inputs."""
    xn, yn = _problem()
    jl, tl, _ = _linears(0, 4, 2)
    x, y = tp.to_tensor(xn), tp.to_tensor(yn)
    static = tp.jit.to_static(_accum(tl))
    static(x, y)
    static(x, y)
    tl.weight.clear_grad()
    tl.bias.clear_grad()
    static(x, y)  # grads now None -> MissedCapture -> re-spy, no stale reuse
    one = _np(tl.weight.grad)
    tl.weight.clear_grad()
    tl.bias.clear_grad()
    static(x, y)
    np.testing.assert_allclose(_np(tl.weight.grad), one, rtol=1e-6)
    # one step's gradient from the same weights is the JAX package's
    _accum(jl)(pt.to_tensor(xn), pt.to_tensor(yn))
    np.testing.assert_allclose(one, _np(jl.weight.grad), rtol=1e-5)


def test_full_step_capture_with_clear_inside():
    """The canonical fused step (backward+opt+clear inside) works and
    matches the JAX package across lr-schedule changes."""
    xn, yn = _problem()
    jl, tl, _ = _linears(0, 4, 2)
    out = {}
    for tag, pkg, lin in (("jax", pt, jl), ("port", tp, tl)):
        sched = pkg.optimizer.lr.StepDecay(learning_rate=0.1, step_size=2,
                                           gamma=0.5)
        opt = pkg.optimizer.Adam(learning_rate=sched,
                                 parameters=lin.parameters())
        static = pkg.jit.to_static(_mse_step(pkg, lin, opt))
        x, y = pkg.to_tensor(xn), pkg.to_tensor(yn)
        losses = []
        for _ in range(6):
            losses.append(float(_np(static(x, y))))
            sched.step()
        out[tag] = (losses, static)
    assert out["port"][0][-1] < 0.5  # converging
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=1e-5)
    # the capture must actually build a program: lazy accumulator creation
    # during the spy re-spies once, it never pins the step eager
    static = out["port"][1]
    assert _compiled(static)
    (group,) = static._cache.values()
    assert group.variants[0].compiled.runs >= 1


def test_adamw_with_clip_capture_compiles():
    """AdamW + global-norm clip (the bench configuration) is captured, not
    silently eager, and matches a pure-eager twin and the JAX package."""
    xn, yn = _problem()
    jl, tl, te = _linears(0, 4, 2)
    runs = {}
    for tag, pkg, lin, static in (("jax", pt, jl, True), ("port", tp, tl, True),
                                  ("eager", tp, te, False)):
        nn = jnn if pkg is pt else tnn
        opt = pkg.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=lin.parameters(),
                                  grad_clip=nn.ClipGradByGlobalNorm(1.0))
        step = _mse_step(pkg, lin, opt)
        fn = pkg.jit.to_static(step) if static else step
        x, y = pkg.to_tensor(xn), pkg.to_tensor(yn)
        runs[tag] = [float(_np(fn(x, y))) for _ in range(4)]
        if tag == "port":
            assert _compiled(fn)
    np.testing.assert_allclose(runs["port"], runs["eager"], rtol=1e-5)
    np.testing.assert_allclose(runs["port"], runs["jax"], rtol=1e-5)


def _branchy(pkg, calls):
    def f(x):
        calls["n"] += 1
        s = (x * 2).sum()
        if s > 10:                    # bool() guard point
            return s * 3
        return s - 1
    return f


def test_guard_specialization_compiles_both_branches():
    """A data-dependent Python branch does NOT make the signature eager:
    each branch gets its own variant; divergence is detected through the
    guard outputs and the right variant re-runs."""
    calls = {"n": 0}
    static = tp.jit.to_static(_branchy(tp, calls))
    jstatic = pt.jit.to_static(_branchy(pt, {"n": 0}))
    lo_n, hi_n = np.ones(4, np.float32), np.full(4, 10.0, np.float32)
    lo, hi = tp.to_tensor(lo_n), tp.to_tensor(hi_n)
    for t, n, want in ((lo, lo_n, 7.0), (hi, hi_n, 240.0), (lo, lo_n, 7.0),
                       (hi, hi_n, 240.0)):
        got = float(static(t))
        assert abs(got - want) < 1e-5
        assert got == pytest.approx(float(jstatic(pt.to_tensor(n))), rel=1e-6)
    (group,) = static._cache.values()
    assert len(group.variants) == 2 and not group.eager_only
    assert all(v.compiled is not None for v in group.variants)
    # steady state: no new variant, no spy; on the CPU each program runs
    # its body (a call tries the last variant, then the other)
    spies = sum(v.compiled.runs for v in group.variants)
    for _ in range(3):
        static(lo), static(hi)
    assert len(group.variants) == 2 and not group.eager_only
    assert sum(v.compiled.runs for v in group.variants) - spies <= 12


@pytest.mark.cuda
def test_guard_specialization_replays_without_the_body_on_the_card():
    """The reference's steady-state assertion, on the card: after both
    branches are captured, calls replay graphs and the body never runs."""
    prev = _on_card()
    try:
        calls = {"n": 0}
        static = tp.jit.to_static(_branchy(tp, calls))
        lo = tp.to_tensor(np.ones(4, np.float32))
        hi = tp.to_tensor(np.full(4, 10.0, np.float32))
        for _ in range(3):
            assert abs(float(static(lo)) - 7.0) < 1e-5
            assert abs(float(static(hi)) - 240.0) < 1e-5
        n = calls["n"]
        for _ in range(3):
            static(lo), static(hi)
        assert calls["n"] == n
        (group,) = static._cache.values()
        assert len(group.variants) == 2 and not group.eager_only
        assert all(v.compiled.graph is not None for v in group.variants)
    finally:
        tdevice._current_device = prev


def _scaled_step(lin, opt):
    def step(x, y, scale):
        loss = ((lin(x) - y) ** 2).mean() * scale
        if loss > 0.5:            # guard: branch depends on loss value
            loss = loss * 2.0
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return step


def test_guard_divergence_does_not_corrupt_state():
    """A diverged run is rolled back: optimizer state after a branch flip
    matches an eager twin exactly, and the JAX package's captured step."""
    xn, yn = _problem()
    jl, tl, te = _linears(0, 4, 2)
    jstatic = pt.jit.to_static(_scaled_step(
        jl, pt.optimizer.Adam(learning_rate=0.05, parameters=jl.parameters())))
    static = tp.jit.to_static(_scaled_step(
        tl, tp.optimizer.Adam(learning_rate=0.05, parameters=tl.parameters())))
    eager = _scaled_step(
        te, tp.optimizer.Adam(learning_rate=0.05, parameters=te.parameters()))
    x, y = tp.to_tensor(xn), tp.to_tensor(yn)
    jx, jy = pt.to_tensor(xn), pt.to_tensor(yn)
    # scale schedule drives the branch both ways, incl. flips after capture
    for scale in [2.0, 2.0, 0.01, 0.01, 2.0, 0.01, 2.0]:
        ls = _np(static(x, y, scale))
        np.testing.assert_allclose(ls, _np(eager(x, y, scale)), rtol=1e-5)
        np.testing.assert_allclose(ls, _np(jstatic(jx, jy, scale)), rtol=1e-5)
    for ps, pe, pj in zip(tl.parameters(), te.parameters(), jl.parameters()):
        np.testing.assert_allclose(_np(ps), _np(pe), rtol=1e-5)
        np.testing.assert_allclose(_np(ps), _np(pj), rtol=1e-5)


def _gpt2(pkg, seed=0):
    """The JAX package's tiny GPT-2 from the seed, or the port's holding
    its weights (``pkg=None``: the port's from its own seed, on the card,
    where JAX is stubbed out)."""
    from paddle_tpu.models import gpt2 as jgpt2
    from paddle_tpu_torch.models import gpt2 as tgpt2
    kw = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
              max_position_embeddings=64)
    if pkg is None:
        tp.seed(seed)
        tm = tgpt2.GPT2ForCausalLM(tgpt2.GPT2Config.tiny(**kw))
        return tm.config, tm
    pt.seed(seed)
    jm = jgpt2.GPT2ForCausalLM(jgpt2.GPT2Config.tiny(**kw))
    if pkg is pt:
        return jm.config, jm
    tm = tgpt2.GPT2ForCausalLM(tgpt2.GPT2Config.tiny(**kw))
    return tm.config, _bridge(jm, tm)


def _gpt2_branch_step(m, opt, counter):
    def step(x, y):
        counter["n"] += 1
        _, loss = m(x, labels=y)
        loss.backward()
        # data-dependent branch: skip the update on a loss explosion
        if loss > 1e6:
            opt.clear_grad()
        else:
            opt.step()
            opt.clear_grad()
        return loss
    return step


def _gpt2_ids(cfg):
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                           (2, 17)).astype(np.int32)
    return ids[:, :-1], ids[:, 1:]


def _gpt2_losses(pkg, static, steps=5, counter=None):
    cfg, m = _gpt2(pkg)
    pkg = pkg or tp
    opt = pkg.optimizer.AdamW(learning_rate=1e-3, parameters=m.parameters())
    counter = {"n": 0} if counter is None else counter
    fn = _gpt2_branch_step(m, opt, counter)
    fn = pkg.jit.to_static(fn) if static else fn
    xn, yn = _gpt2_ids(cfg)
    x, y = pkg.to_tensor(xn), pkg.to_tensor(yn)
    return [float(_np(fn(x, y))) for _ in range(steps)], fn, (x, y)


def test_gpt2_train_step_with_branch_stays_compiled():
    """A GPT-2 train step containing a data-dependent Python branch stays
    captured and matches the eager step and the JAX package's captured
    step (rtol 2e-3, as the reference)."""
    cnt = {"n": 0}
    losses, static, (x, y) = _gpt2_losses(tp, True, counter=cnt)
    (group,) = static._cache.values()
    assert not group.eager_only and group.variants, "step fell back to eager"
    entry = group.variants[-1]
    assert entry.guard_kinds == ("bool",) and entry.compiled is not None
    assert len(entry.op_tape) > 0
    runs, n = entry.compiled.runs, cnt["n"]
    static(x, y)
    # the CPU runs the captured body once a call: no spy, no new variant
    assert entry.compiled.runs == runs + 1 and cnt["n"] == n + 1
    assert len(group.variants) == 1
    ref, _, _ = _gpt2_losses(tp, False)
    np.testing.assert_allclose(losses, ref, rtol=2e-3)
    jax_losses, _, _ = _gpt2_losses(pt, True)
    np.testing.assert_allclose(losses, jax_losses, rtol=2e-3)


@pytest.mark.cuda
def test_gpt2_train_step_with_branch_replays_without_the_body_on_the_card():
    prev = _on_card()
    try:
        cnt = {"n": 0}
        losses, static, (x, y) = _gpt2_losses(None, True, counter=cnt)
        (group,) = static._cache.values()
        assert not group.eager_only and group.variants
        n = cnt["n"]
        static(x, y)
        assert cnt["n"] == n, "python body ran in steady state (not captured)"
        assert all(v.compiled.graph is not None for v in group.variants)
        ref, _, _ = _gpt2_losses(None, False)
        np.testing.assert_allclose(losses, ref, rtol=2e-3)
    finally:
        tdevice._current_device = prev


def _gpt2_plain_step(m, opt):
    def step(x, y):
        _, loss = m(x, labels=y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return step


@pytest.mark.parametrize("scan", [False, True], ids=["to_static", "scan_steps"])
def test_gpt2_layer_step_matches_the_jax_capture(scan):
    """The tiny GPT-2 ``Layer`` step with AdamW + clip under ``to_static``
    (5 calls) or ``scan_steps`` (two calls of K = 3), against the JAX
    package's same capture on the same numpy weights and batches (rtol
    2e-3, as ``test_jit.py``); every parameter after the run too."""
    rng = np.random.RandomState(1)
    out = {}
    for pkg in (pt, tp):
        nn = jnn if pkg is pt else tnn
        cfg, m = _gpt2(pkg)
        opt = pkg.optimizer.AdamW(learning_rate=1e-3, parameters=m.parameters(),
                                  grad_clip=nn.ClipGradByGlobalNorm(1.0))
        step = _gpt2_plain_step(m, opt)
        ids = np.random.RandomState(1).randint(
            0, cfg.vocab_size, (3, 2, 17)).astype(np.int32)
        if scan:
            fn = pkg.jit.scan_steps(step)
            xs, ys = pkg.to_tensor(ids[..., :-1]), pkg.to_tensor(ids[..., 1:])
            losses = [v for _ in range(2) for v in _np(fn(xs, ys))]
        else:
            fn = pkg.jit.to_static(step)
            losses = [float(_np(fn(pkg.to_tensor(ids[i % 3, :, :-1]),
                                   pkg.to_tensor(ids[i % 3, :, 1:]))))
                      for i in range(5)]
        out[pkg.__name__] = (losses, {n: _np(p) for n, p in
                                      m.named_parameters()}, fn)
    (tl, tw, fn), (jl, jw, _) = out["paddle_tpu_torch"], out["paddle_tpu"]
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    for n in jw:
        np.testing.assert_allclose(tw[n], jw[n], rtol=2e-3, atol=2e-5,
                                   err_msg=n)
    assert _compiled(fn)
    del rng


# ---- scan_steps: K steps per dispatch -------------------------------------

def _scan_problem(k=5, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(k, 8, 4).astype(np.float32),
            rng.rand(k, 8, 2).astype(np.float32))


def test_scan_steps_matches_eager_train_loop():
    """scan_steps(step)(stacked) == running step eagerly per slice: identical
    per-step losses AND identical final weights, with K optimizer updates;
    and the JAX package's scan_steps on the same weights."""
    K = 5
    xs_n, ys_n = _scan_problem(K)
    jl, tl, te = _linears(0, 4, 2)

    def make(pkg, lin):
        nn = jnn if pkg is pt else tnn
        opt = pkg.optimizer.AdamW(learning_rate=1e-2,
                                  parameters=lin.parameters(),
                                  grad_clip=nn.ClipGradByGlobalNorm(1.0))
        return _mse_step(pkg, lin, opt)

    step_e = make(tp, te)
    ref = [float(_np(step_e(tp.to_tensor(xs_n[i % K]),
                            tp.to_tensor(ys_n[i % K])))) for i in range(2 * K)]
    got = {}
    for pkg, lin in ((tp, tl), (pt, jl)):
        scan = pkg.jit.scan_steps(make(pkg, lin))
        xs, ys = pkg.to_tensor(xs_n), pkg.to_tensor(ys_n)
        out1 = scan(xs, ys)          # spy call: eager per slice
        out2 = scan(xs, ys)          # captured (or re-spied for lazy state)
        assert tuple(out2.shape) == (K,)
        got[pkg.__name__] = list(_np(out1)) + list(_np(out2))
        if pkg is tp:
            assert _compiled(scan)
    np.testing.assert_allclose(got["paddle_tpu_torch"], ref, rtol=2e-4)
    np.testing.assert_allclose(got["paddle_tpu_torch"], got["paddle_tpu"],
                               rtol=2e-4)
    np.testing.assert_allclose(_np(tl.weight), _np(te.weight), rtol=2e-4)
    np.testing.assert_allclose(_np(tl.weight), _np(jl.weight), rtol=2e-4)


def test_scan_steps_threads_rng_state():
    """Dropout inside a scanned step draws a fresh mask per slice, matching
    the eager loop (the port's draws against the port's: no draw is
    compared across packages)."""
    K = 4

    def make():
        tp.seed(7)
        lin = tnn.Linear(4, 4)
        drop = tnn.Dropout(0.5)
        opt = tp.optimizer.SGD(learning_rate=0.1, parameters=lin.parameters())

        def step(x, y):
            loss = ((drop(lin(x)) - y) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        return lin, step

    rng = np.random.RandomState(3)
    xs_n = rng.rand(K, 8, 4).astype(np.float32)
    ys_n = rng.rand(K, 8, 4).astype(np.float32)
    _, step_e = make()
    ref = [float(_np(step_e(tp.to_tensor(xs_n[i]), tp.to_tensor(ys_n[i]))))
           for i in range(K)]
    _, step_s = make()
    scan = tp.jit.scan_steps(step_s)
    got = list(_np(scan(tp.to_tensor(xs_n), tp.to_tensor(ys_n))))
    np.testing.assert_allclose(got, ref, rtol=2e-4)
    # per-slice masks must differ: with a stuck generator all K would match
    assert len({round(v, 6) for v in got}) > 1
    # captured calls draw fresh masks too
    again = list(_np(scan(tp.to_tensor(xs_n), tp.to_tensor(ys_n))))
    assert len({round(v, 6) for v in again}) > 1


def test_scan_steps_guarded_fn_falls_back_eager():
    """Host reads can't specialize inside a scan: the signature falls back
    to the per-slice eager loop with correct results (the JAX package's),
    not a crash."""
    K = 3
    xs_n, ys_n = _scan_problem(K, seed=1)
    jl, tl, _ = _linears(0, 4, 2)
    outs = {}
    for pkg, lin in ((tp, tl), (pt, jl)):
        opt = pkg.optimizer.SGD(learning_rate=0.05, parameters=lin.parameters())

        def step(x, y, lin=lin, opt=opt, pkg=pkg):
            loss = ((lin(x) - y) ** 2).mean()
            host = float(loss) if pkg is tp else float(np.asarray(loss._buf))
            if host > 0:                       # a true graph break
                loss = loss * 1.0
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        scan = pkg.jit.scan_steps(step)
        xs, ys = pkg.to_tensor(xs_n), pkg.to_tensor(ys_n)
        vals = [_np(scan(xs, ys)) for _ in range(4)]
        assert vals[-1].shape == (K,)
        assert all(g.eager_only for g in scan._cache.values())
        outs[pkg.__name__] = vals
    np.testing.assert_allclose(outs["paddle_tpu_torch"], outs["paddle_tpu"],
                               rtol=1e-5)


def test_scan_steps_rejects_ragged_leading_dim():
    scan = tp.jit.scan_steps(lambda a, b: a + b)
    with pytest.raises(ValueError):
        scan(tp.to_tensor(np.zeros((3, 2), np.float32)),
             tp.to_tensor(np.zeros((4, 2), np.float32)))


def test_guarded_signature_warns_once(caplog):
    """A value-guarded signature discloses its per-call device->host read
    (and snapshot) cost — once, not per call."""
    _, tl, _ = _linears(0, 4, 2)

    def step(x, y):
        loss = ((tl(x) - y) ** 2).mean()
        if int(loss * 0) == 0:        # value guard (int conversion)
            loss = loss * 1.0
        return loss

    static = tp.jit.to_static(step)
    xn, yn = _problem()
    x, y = tp.to_tensor(xn), tp.to_tensor(yn)
    with caplog.at_level(logging.WARNING, logger="paddle_tpu_torch.jit"):
        for _ in range(3):
            static(x, y)
    warns = [r for r in caplog.records if "value guard" in r.message]
    assert len(warns) == 1, [r.message for r in caplog.records]
