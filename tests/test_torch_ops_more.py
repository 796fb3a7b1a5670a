"""The rest of the port's op surface (``paddle_tpu_torch/ops/{search,stat,
random,linalg,einsum_op}.py`` and the methods ``ops/__init__.py`` installs
from them) against the JAX package's, on the CPU.

- Every ``ops/registry.py`` golden whose reference op is defined in
  ``ops.search``, ``ops.stat`` or ``ops.linalg`` (by the resolved
  function's ``__module__``), and the ``einsum`` and ``bucketize`` entries
  (whose ``op`` is a lambda, so they are picked by name): the port's output
  against the numpy golden (or the entry's property check) and against the
  JAX package's output on the same numpy inputs, at the entry's atol /
  rtol, with the same dtype name.  The decompositions (``qr``, ``svd``,
  ``eig``, ``eigh``) come out of the same LAPACK routines on both
  packages' CPU backends, so their vectors agree element by element too.
- The ``grad=True`` entries among them: the gradients of a weighted sum of
  the outputs against the JAX package's, at the entry's atol / rtol.
- The ``ops.random`` smoke and in-place entries: shape and dtype against
  the JAX package's, and moments and support of a large draw (the draws
  are torch's, not threefry's, so values are never compared); a draw
  repeats under the same ``paddle.seed``; a one-hot ``multinomial`` row
  always draws its index.
- Every method name of these modules on the port's ``Tensor``.
- ``median``'s two modes at an even length, ``topk``'s tie order, and a
  dynamic-shape op inside ``jit.to_static`` (a break).
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.ops as JO
from paddle_tpu.core import dtype as jdtypes
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.ops.registry import REGISTRY
import paddle_tpu_torch as tp
import paddle_tpu_torch.ops as TO
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.core import dtype as tdtypes
from paddle_tpu_torch.core.tensor import Tensor as TTensor

MODULES = {f"paddle_tpu.ops.{m}" for m in ("search", "stat", "linalg")}
BY_NAME = {"einsum": lambda a, b: TO.einsum("ij,jk->ik", a, b),
           "bucketize": TO.bucketize}


def _module(fn):
    return getattr(fn, "__module__", None)


def _resolved_module(spec):
    """The module of an entry's reference op (None where the name is a
    Tensor method only, as some in-place entries are)."""
    try:
        return _module(spec.resolve())
    except AttributeError:
        return None


GOLDEN = sorted(n for n, s in REGISTRY.items() if s.kind == "golden" and (
    _resolved_module(s) in MODULES or n in BY_NAME))
GRAD = [n for n in GOLDEN if REGISTRY[n].grad]
RANDOM = sorted(n for n, s in REGISTRY.items()
                if _resolved_module(s) == "paddle_tpu.ops.random")
RANDOM_SMOKE = [n for n in RANDOM if REGISTRY[n].kind == "smoke"]
RANDOM_INPLACE = [n for n in RANDOM if REGISTRY[n].kind == "inplace"]


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev


def _wrap(pkg, x, grad=False):
    if isinstance(x, list):
        return [_wrap(pkg, v, grad) for v in x]
    t = pkg.to_tensor(x)
    if grad and np.issubdtype(np.asarray(x).dtype, np.floating):
        t.stop_gradient = False
    return t


def _kwargs(pkg, spec):
    return {k: (pkg.to_tensor(v) if isinstance(v, np.ndarray) else v)
            for k, v in spec.kwargs.items()}


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [o for v in out for o in _flat(v)]
    return [out]


def _op(pkg, name):
    spec = REGISTRY[name]
    if pkg is pt:
        return spec.resolve()
    return BY_NAME.get(name) or getattr(TO, spec.op or name)


def _run(pkg, name, raw, grad=False):
    spec = REGISTRY[name]
    ins = [_wrap(pkg, x, grad) for x in raw]
    return ins, _op(pkg, name)(*ins, **_kwargs(pkg, spec))


def _np(o):
    return np.asarray(o.numpy()) if isinstance(o, (JTensor, TTensor)) \
        else np.asarray(o)


def _close(got, want, spec, what):
    if np.iscomplexobj(want) or np.iscomplexobj(got):
        np.testing.assert_allclose(got.astype(np.complex128),
                                   want.astype(np.complex128),
                                   atol=spec.atol, rtol=spec.rtol,
                                   err_msg=what)
    elif want.dtype == np.bool_ or got.dtype == np.bool_:
        np.testing.assert_array_equal(got.astype(bool), want.astype(bool),
                                      err_msg=what)
    elif np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=what)
    else:
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64),
                                   atol=spec.atol, rtol=spec.rtol,
                                   err_msg=what)


def test_the_selection_covers_the_modules():
    by_mod = {}
    for n in GOLDEN:
        by_mod.setdefault(_module(REGISTRY[n].resolve()), []).append(n)
    assert {m: len(v) for m, v in by_mod.items()} == {
        "paddle_tpu.ops.search": 11, "paddle_tpu.ops.stat": 6,
        "paddle_tpu.ops.linalg": 29, "paddle_tpu.ops.registry": 2}
    assert sorted(GRAD) == sorted([
        "dist", "norm", "cholesky", "cholesky_solve", "inverse", "solve",
        "triangular_solve", "det", "cross", "index_sample", "einsum"])
    assert len(RANDOM_SMOKE) == 17 and len(RANDOM_INPLACE) == 7


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_against_numpy_and_jax(name):
    spec = REGISTRY[name]
    raw = spec.sample() if spec.sample else []
    _, out = _run(tp, name, raw)
    _, jout = _run(pt, name, raw)
    outs, jouts = _flat(out), _flat(jout)
    assert len(outs) == len(jouts)
    if spec.check is not None:
        spec.check(raw, out)
    else:
        refs = spec.np_ref(*raw)
        refs = refs if isinstance(refs, (list, tuple)) else [refs]
        for i, (o, r) in enumerate(zip(outs, refs)):
            _close(_np(o), np.asarray(r), spec, f"{name} output {i} vs numpy")
    outs = [_np(o) for o in outs]
    if name == "svd":
        outs = _signs_of(outs, [_np(j) for j in jouts])
    for i, (o, j) in enumerate(zip(outs, jouts)):
        _close(o, _np(j), spec, f"{name} output {i} vs the JAX package")
        if isinstance(j, JTensor):
            assert tdtypes.dtype_name(o.dtype) == jdtypes.dtype_name(j.dtype), \
                (name, i, o.dtype, j.dtype)


def _signs_of(usv, want):
    """U, S, V with each singular pair's sign taken from ``want``'s (an
    SVD fixes a pair only up to sign, and the two packages' CPU drivers
    pick differently)."""
    u, s, v = usv
    sign = np.sign((u * want[0]).sum(0))
    return [u * sign, s, v * sign]


def _grads(pkg, name, raw):
    ins, out = _run(pkg, name, raw, grad=True)
    loss = None
    for k, o in enumerate(_flat(out)):
        if not np.issubdtype(_np(o).dtype, np.floating):
            continue
        w = np.random.RandomState(7 + k).uniform(
            0.5, 1.5, o.shape).astype(np.float32)
        term = (o * pkg.to_tensor(w)).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    leaves = [t for t in _flat(ins) if not t.stop_gradient]
    return [None if t.grad is None else _np(t.grad) for t in leaves]


@pytest.mark.parametrize("name", GRAD)
def test_grad_against_jax(name):
    spec = REGISTRY[name]
    raw = spec.sample() if spec.sample else []
    got, want = _grads(tp, name, raw), _grads(pt, name, raw)
    assert len(got) == len(want) and any(g is not None for g in got)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), (name, i)
        if g is not None:
            np.testing.assert_allclose(g, w, atol=spec.atol, rtol=spec.rtol,
                                       err_msg=f"{name} grad {i}")


@pytest.mark.parametrize("name", RANDOM_SMOKE)
def test_random_smoke_shape_and_dtype_match_jax(name):
    spec = REGISTRY[name]
    raw = spec.sample() if spec.sample else []
    _, out = _run(tp, name, raw)
    _, jout = _run(pt, name, raw)
    outs, jouts = _flat(out), _flat(jout)
    assert len(outs) == len(jouts)
    for o, j in zip(outs, jouts):
        a, b = _np(o), _np(j)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        assert tdtypes.dtype_name(o.dtype) == jdtypes.dtype_name(j.dtype), \
            (name, o.dtype, j.dtype)
        if np.issubdtype(a.dtype, np.floating):
            assert np.isfinite(a).all(), name


N = 200_000
# (op, kwargs, mean, var, support): each draw's moments at 5 standard errors
MOMENTS = [
    ("uniform", {"min": -1.0, "max": 3.0}, 1.0, 16 / 12, (-1.0, 3.0)),
    ("rand", {}, 0.5, 1 / 12, (0.0, 1.0)),
    ("randn", {}, 0.0, 1.0, None),
    ("standard_normal", {}, 0.0, 1.0, None),
    ("normal", {"mean": 2.0, "std": 0.5}, 2.0, 0.25, None),
    ("gaussian", {"mean": -1.0, "std": 2.0}, -1.0, 4.0, None),
    ("randint", {"low": 0, "high": 5}, 2.0, 2.0, (0, 4)),
    ("log_normal", {"mean": 0.0, "std": 0.25},
     np.exp(0.03125), (np.exp(0.0625) - 1) * np.exp(0.0625), (0.0, None)),
]


def _moments(a, mean, var, support, what):
    a = a.astype(np.float64).reshape(-1)
    se = np.sqrt(var / a.size)
    assert abs(a.mean() - mean) < 5 * se, (what, a.mean(), mean)
    assert abs(a.var() - var) < 0.05 * var, (what, a.var(), var)
    if support is not None:
        lo, hi = support
        assert lo is None or a.min() >= lo, (what, a.min())
        assert hi is None or a.max() <= hi, (what, a.max())


@pytest.mark.parametrize("op,kw,mean,var,support", MOMENTS,
                         ids=[m[0] for m in MOMENTS])
def test_random_moments(op, kw, mean, var, support):
    tp.seed(11)
    out = getattr(TO, op)(shape=[N], **kw)
    assert out.shape == [N]
    _moments(out.numpy(), mean, var, support, op)


@pytest.mark.parametrize("op,arg,mean,var", [
    ("poisson", 3.0, 3.0, 3.0), ("bernoulli", 0.3, 0.3, 0.21),
    ("standard_gamma", 2.5, 2.5, 2.5), ("standard_gamma", 0.5, 0.5, 0.5)])
def test_random_moments_of_tensor_parameters(op, arg, mean, var):
    tp.seed(12)
    out = getattr(TO, op)(tp.full([N], arg, "float32"))
    assert out.dtype == tp.float32
    _moments(out.numpy(), mean, var, (0.0, None), op)


def test_binomial_and_multinomial_moments():
    tp.seed(13)
    b = TO.binomial(tp.full([N], 10.0, "float32"), tp.full([N], 0.3,
                                                            "float32"))
    assert b.dtype == tp.int32
    _moments(b.numpy(), 3.0, 2.1, (0, 10), "binomial")
    p = np.array([0.1, 0.2, 0.7], np.float32)
    for repl in (True, False):
        d = TO.multinomial(tp.to_tensor(np.tile(p, (N, 1))), 1,
                           replacement=repl).numpy().reshape(-1)
        freq = np.bincount(d, minlength=3) / N
        np.testing.assert_allclose(freq, p, atol=5e-3, err_msg=str(repl))
    # without replacement: distinct categories per row
    d = TO.multinomial(tp.to_tensor(np.tile(p, (64, 1))), 3).numpy()
    assert (np.sort(d, -1) == np.arange(3)).all()


@pytest.mark.parametrize("num", [1, 2])
def test_one_hot_multinomial_draws_its_index(num):
    rng = np.random.RandomState(0)
    idx = rng.randint(0, 50, 256)
    probs = np.zeros((256, 50), np.float32)
    probs[np.arange(256), idx] = 1.0
    if num == 2:
        probs[np.arange(256), (idx + 1) % 50] = 1.0
    for seed in range(3):
        tp.seed(seed)
        d = TO.multinomial(tp.to_tensor(probs), num).numpy()
        assert (d[:, 0] == idx).all() or num == 2
        assert (np.sort(d, -1) == np.sort(
            np.stack([idx, (idx + 1) % 50][:num], -1), -1)).all()


# (op, kwargs, mean, var, support) of each in-place draw
INPLACE = {
    "uniform_": ({"min": 0.0, "max": 2.0}, 1.0, 1 / 3, (0.0, 2.0)),
    "normal_": ({"mean": 1.0, "std": 2.0}, 1.0, 4.0, None),
    "exponential_": ({"lam": 2.0}, 0.5, 0.25, (0.0, None)),
    "bernoulli_": ({"p": 0.25}, 0.25, 0.1875, (0.0, 1.0)),
    "geometric_": ({"probs": 0.5}, 2.0, 2.0, (1.0, None)),
    "log_normal_": ({"mean": 0.0, "std": 0.25}, np.exp(0.03125),
                    (np.exp(0.0625) - 1) * np.exp(0.0625), (0.0, None)),
    "cauchy_": ({"loc": 1.0, "scale": 0.5}, None, None, None),
}


@pytest.mark.parametrize("name", sorted(INPLACE))
def test_random_inplace_draws(name):
    assert name in RANDOM_INPLACE
    kw, mean, var, support = INPLACE[name]
    tp.seed(14)
    x = tp.zeros([N], "float32")
    out = getattr(x, name)(**kw)
    assert out is x and x.shape == [N] and x.dtype == tp.float32
    a = x.numpy()
    if mean is None:                         # Cauchy: the median and IQR
        q1, med, q3 = np.quantile(a, [0.25, 0.5, 0.75])
        assert abs(med - 1.0) < 0.02 and abs((q3 - q1) - 1.0) < 0.03
    else:
        _moments(a, mean, var, support, name)
    j = pt.zeros([64], "float32")
    getattr(j, name)(**kw)
    y = tp.zeros([64], "bfloat16")
    getattr(y, name)(**kw)
    assert y.dtype == tp.bfloat16 and y.shape == list(j.shape)


@pytest.mark.parametrize("op,args", [
    ("rand", ([4, 8],)), ("randn", ([4, 8],)), ("randint", (0, 9, [16])),
    ("randperm", (16,)), ("uniform", ([32],))])
def test_draws_repeat_under_the_same_seed(op, args):
    tp.seed(5)
    a = getattr(TO, op)(*args).numpy()
    tp.seed(5)
    b = getattr(TO, op)(*args).numpy()
    tp.seed(6)
    c = getattr(TO, op)(*args).numpy()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_top_p_sampling_keeps_the_nucleus():
    probs = np.array([[0.5, 0.3, 0.15, 0.05]] * 4096, np.float32)
    tp.seed(3)
    scores, ids = TO.top_p_sampling(tp.to_tensor(probs), np.full(
        (4096, 1), 0.6, np.float32))
    ids = ids.numpy().reshape(-1)
    assert set(ids) <= {0, 1} and 0.5 < (ids == 0).mean() < 0.75
    np.testing.assert_array_equal(scores.numpy().reshape(-1), probs[0, ids])


def test_shuffle_and_randperm_are_permutations():
    tp.seed(1)
    x = np.arange(100, dtype=np.float32)
    assert sorted(TO.shuffle(tp.to_tensor(x)).numpy()) == list(x)
    assert sorted(TO.randperm(50).numpy()) == list(range(50))


def _installable():
    mods = MODULES | {"paddle_tpu.ops.random", "paddle_tpu.ops.einsum_op"}
    names = set()
    for name in JO._DELEGATED:
        fn = getattr(JO, name, None)
        if fn is not None and _module(fn) in mods:
            names.add(name)
    for base in JO._AUTO_INPLACE:
        fn = getattr(JO, base, None)
        if fn is not None and _module(fn) in mods:
            names.add(base + "_")
    return sorted(names)


@pytest.mark.parametrize("name", _installable())
def test_method_installed(name):
    assert callable(getattr(TTensor, name, None)), f"Tensor.{name} missing"


def test_methods_call_the_module_ops():
    x = np.random.RandomState(0).uniform(-2, 2, (3, 6)).astype(np.float32)
    for pkg in (pt, tp):
        t = pkg.to_tensor(x)
        v, i = t.topk(2)
        np.testing.assert_allclose(v.numpy(), np.sort(x, -1)[:, ::-1][:, :2])
        np.testing.assert_array_equal(t.argmax(axis=1).numpy(),
                                      x.argmax(1))
        np.testing.assert_allclose(t.norm().numpy(), np.linalg.norm(x),
                                   rtol=1e-6)
        np.testing.assert_allclose(t.var(axis=0).numpy(),
                                   x.var(0, ddof=1), rtol=1e-5)
        np.testing.assert_allclose(t.median(axis=1).numpy(),
                                   np.median(x, 1), rtol=1e-6)


@pytest.mark.parametrize("pkg", [pt, tp], ids=["jax", "port"])
def test_median_modes_at_an_even_length(pkg):
    x = pkg.to_tensor(np.array([[4.0, 1.0, 3.0, 2.0],
                                [8.0, 5.0, 7.0, 6.0]], np.float32))
    np.testing.assert_allclose(pkg.median(x, axis=1).numpy(), [2.5, 6.5])
    np.testing.assert_allclose(pkg.median(x, axis=1, mode="min").numpy(),
                               [2.0, 6.0])
    np.testing.assert_allclose(pkg.median(x).numpy(), 4.5)
    np.testing.assert_allclose(pkg.median(x, mode="min").numpy(), 4.0)
    np.testing.assert_allclose(
        pkg.median(x, axis=0, keepdim=True).numpy(), [[6.0, 3.0, 5.0, 4.0]])


def test_median_and_nanmedian_match_jax_over_axes():
    x = np.random.RandomState(3).uniform(-1, 1, (4, 6, 5)).astype(np.float32)
    x[1, 2, 3] = np.nan
    for kw in ({}, {"axis": 1}, {"axis": -1, "keepdim": True},
               {"axis": [0, 2]}):
        for op in ("median", "nanmedian"):
            want = getattr(pt, op)(pt.to_tensor(x), **kw).numpy()
            got = getattr(tp, op)(tp.to_tensor(x), **kw).numpy()
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                       err_msg=f"{op} {kw}")


def test_quantile_matches_jax_over_axes_and_methods():
    x = np.random.RandomState(4).uniform(-1, 1, (5, 8)).astype(np.float32)
    for kw in ({"q": 0.5, "axis": 1}, {"q": [0.1, 0.9], "axis": 0},
               {"q": 0.25, "axis": 1, "keepdim": True,
                "interpolation": "lower"},
               {"q": [0.3, 0.7], "keepdim": True,
                "interpolation": "midpoint"}):
        want = pt.quantile(pt.to_tensor(x), **kw).numpy()
        got = tp.quantile(tp.to_tensor(x), **kw).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=str(kw))


@pytest.mark.parametrize("pkg", [pt, tp], ids=["jax", "port"])
def test_topk_ties_take_the_lower_index_first(pkg):
    x = pkg.to_tensor(np.array([[1.0, 3.0, 3.0, 2.0, 3.0]], np.float32))
    v, i = pkg.topk(x, 2)
    np.testing.assert_array_equal(i.numpy(), [[1, 2]])
    v, i = pkg.topk(x, 2, largest=False)
    np.testing.assert_array_equal(i.numpy(), [[0, 3]])
    assert i.stop_gradient


def test_norm_orders_match_jax():
    x = np.random.RandomState(5).uniform(-2, 2, (3, 4)).astype(np.float32)
    for kw in ({"p": 1, "axis": 1}, {"p": 3, "axis": 0, "keepdim": True},
               {"p": np.inf, "axis": 1}, {"p": -np.inf}, {"p": "fro"},
               {"p": 2}):
        want = pt.linalg.norm(pt.to_tensor(x), **kw).numpy()
        got = tp.linalg.norm(tp.to_tensor(x), **kw).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   err_msg=str(kw))
    np.testing.assert_allclose(
        tp.linalg.norm(tp.to_tensor(x), p="nuc").numpy(),
        np.linalg.norm(x, "nuc"), rtol=1e-5)


def test_dynamic_shape_op_breaks_a_captured_step():
    """``nonzero`` reads the host: inside ``to_static`` on the CPU the
    function still returns what eager returns."""
    x = tp.to_tensor(np.array([0.0, 2.0, 0.0, 3.0], np.float32))

    def f(t):
        return tp.nonzero(t * 1.0)

    static = tp.jit.to_static(f)
    for _ in range(3):
        np.testing.assert_array_equal(static(x).numpy(), [[1], [3]])
