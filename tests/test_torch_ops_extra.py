"""The port's ``ops/{math,manip,linalg}_extra.py`` against the JAX
package's, on the CPU.

- Every ``ops/registry.py`` golden whose reference op is defined in one of
  the three modules (by the resolved function's ``__module__``): the
  port's output against the numpy golden (or the entry's property check)
  and against the JAX package's output on the same numpy inputs, at the
  entry's atol / rtol, with the same dtype name; the ``grad=True`` entries'
  gradients of a weighted sum of the outputs against the JAX package's.
  The factorizations (``lu``, ``ormqr``) come out of the same LAPACK
  routines on both packages' CPU backends.
- The smoke entries (``pca_lowrank``, ``svd_lowrank``) and the aliases:
  shapes and dtypes against the JAX package's.
- Every method name of these modules on the port's ``Tensor``, and the
  aliases living in the modules the reference defines them in.
"""
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.core import dtype as jdtypes
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.ops.registry import REGISTRY
import paddle_tpu_torch as tp
import paddle_tpu_torch.ops as TO
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.core import dtype as tdtypes
from paddle_tpu_torch.core.tensor import Tensor as TTensor

MODULES = {f"paddle_tpu.ops.{m}_extra" for m in ("math", "manip", "linalg")}


def _resolved_module(spec):
    try:
        return getattr(spec.resolve(), "__module__", None)
    except AttributeError:
        return None


SELECTED = sorted(n for n, s in REGISTRY.items()
                  if _resolved_module(s) in MODULES)
GOLDEN = [n for n in SELECTED if REGISTRY[n].kind == "golden"]
GRAD = [n for n in GOLDEN if REGISTRY[n].grad]
SMOKE = [n for n in SELECTED if REGISTRY[n].kind == "smoke"]
ALIAS = [n for n in SELECTED if REGISTRY[n].kind == "alias"]


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
    return getattr(TO, spec.op or name)


def _run(pkg, name, raw, grad=False):
    spec = REGISTRY[name]
    ins = [_wrap(pkg, x, grad) for x in raw]
    return ins, _op(pkg, name)(*ins, **_kwargs(pkg, spec))


def _np(o):
    return np.asarray(o.numpy()) if isinstance(o, (JTensor, TTensor)) \
        else np.asarray(o)


def _close(got, want, spec, what):
    if want.dtype == np.bool_ or got.dtype == np.bool_:
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
    for n in SELECTED:
        by_mod.setdefault(_resolved_module(REGISTRY[n]), []).append(n)
    assert {m: len(v) for m, v in by_mod.items()} == {
        "paddle_tpu.ops.math_extra": 20, "paddle_tpu.ops.manip_extra": 30,
        "paddle_tpu.ops.linalg_extra": 8}
    assert len(GOLDEN) == 54 and len(GRAD) == 20
    assert sorted(SMOKE) == ["pca_lowrank", "svd_lowrank"]
    assert sorted(ALIAS) == ["reverse", "row_stack"]


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_against_numpy_and_jax(name):
    spec = REGISTRY[name]
    raw = spec.sample() if spec.sample else []
    _, out = _run(tp, name, raw)
    _, jout = _run(pt, name, raw)
    if not isinstance(jout, (JTensor, list, tuple)):       # a Python value
        assert out == jout, (name, out, jout)
        return
    outs, jouts = _flat(out), _flat(jout)
    assert len(outs) == len(jouts)
    if spec.check is not None:
        spec.check(raw, out)
    else:
        refs = spec.np_ref(*raw)
        refs = refs if isinstance(refs, (list, tuple)) else [refs]
        for i, (o, r) in enumerate(zip(outs, refs)):
            _close(_np(o), np.asarray(r), spec, f"{name} output {i} vs numpy")
    for i, (o, j) in enumerate(zip(outs, jouts)):
        _close(_np(o), _np(j), spec, f"{name} output {i} vs the JAX package")
        if isinstance(j, JTensor):
            assert tdtypes.dtype_name(o.dtype) == jdtypes.dtype_name(j.dtype), \
                (name, i, o.dtype, j.dtype)


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


@pytest.mark.parametrize("name", SMOKE)
def test_smoke_shape_and_dtype_match_jax(name):
    spec = REGISTRY[name]
    raw = spec.sample() if spec.sample else []
    _, out = _run(tp, name, raw)
    _, jout = _run(pt, name, raw)
    outs, jouts = _flat(out), _flat(jout)
    assert len(outs) == len(jouts)
    for o, j in zip(outs, jouts):
        a, b = _np(o), _np(j)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        assert tdtypes.dtype_name(o.dtype) == jdtypes.dtype_name(j.dtype)
        assert np.isfinite(a).all()


@pytest.mark.parametrize("name", ALIAS)
def test_aliases_against_their_targets_and_jax(name):
    """An alias on its target's golden sample: the port's target's output,
    and the JAX package's alias's."""
    spec = REGISTRY[name]
    target = REGISTRY[spec.alias_of]
    raw = target.sample()
    ins = [_wrap(tp, x) for x in raw]
    got = getattr(TO, name)(*ins, **_kwargs(tp, target))
    want = getattr(TO, spec.alias_of)(*ins, **_kwargs(tp, target))
    jgot = getattr(pt.ops, name)(*[_wrap(pt, x) for x in raw],
                                 **_kwargs(pt, target))
    np.testing.assert_array_equal(_np(got), _np(want))
    _close(_np(got), _np(jgot), spec, name)


def test_lowrank_reconstructs_the_centered_matrix():
    a = np.random.RandomState(3).randn(8, 5).astype(np.float32)
    u, s, v = TO.pca_lowrank(tp.to_tensor(a), q=5)
    c = a - a.mean(0, keepdims=True)
    np.testing.assert_allclose((u.numpy() * s.numpy()) @ v.numpy().T, c,
                               atol=1e-4)
    u, s, v = TO.svd_lowrank(tp.to_tensor(a), q=5)
    np.testing.assert_allclose((u.numpy() * s.numpy()) @ v.numpy().T, a,
                               atol=1e-4)


def test_lu_unpack_and_infos_against_the_reference():
    a = np.random.RandomState(4).randn(2, 4, 4).astype(np.float32)
    res = {}
    for pkg, ops in ((tp, TO), (pt, pt.ops)):
        lu, piv, info = ops.lu(pkg.to_tensor(a), get_infos=True)
        P, L, U = ops.lu_unpack(lu, piv)
        res[pkg] = [_np(t) for t in (lu, piv, info, P, L, U)]
    for x, y in zip(res[tp], res[pt]):
        np.testing.assert_allclose(x, y, atol=1e-5)
    P, L, U = res[tp][3:]
    np.testing.assert_allclose(P @ L @ U, a, atol=1e-5)


def test_histogramdd_and_extras_without_goldens():
    r = np.random.RandomState(5)
    x = r.rand(50, 2).astype(np.float32)
    h, edges = TO.histogramdd(tp.to_tensor(x), bins=4)
    jh, jedges = pt.ops.histogramdd(pt.to_tensor(x), bins=4)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh.numpy()))
    for e, je in zip(edges, jedges):
        np.testing.assert_allclose(e.numpy(), np.asarray(je.numpy()),
                                   rtol=1e-6)
    x2 = tp.to_tensor(np.arange(12, dtype=np.float32).reshape(3, 4))
    assert [t.shape for t in TO.tensor_split(x2, [1, 3], axis=1)] == [
        [3, 1], [3, 2], [3, 1]]
    assert TO.tolist(x2) == np.arange(12).reshape(3, 4).tolist()
    with pytest.raises(TypeError):
        TO.positive(tp.to_tensor(np.array([True])))
    with pytest.raises(ValueError):
        TO.take(x2, tp.to_tensor(np.array([0])), mode="bogus")
    np.testing.assert_array_equal(
        TO.take(x2, tp.to_tensor(np.array([13, -1])), mode="wrap").numpy(),
        [1.0, 11.0])


def test_every_method_name_is_installed():
    names = [n for n in TO._DELEGATED if getattr(TO, n, None) is not None]
    assert names == list(TO._DELEGATED)
    x = tp.to_tensor(np.array([[0.5, -1.0], [2.0, 0.0]], np.float32))
    np.testing.assert_allclose(x.sinc().numpy(), np.sinc(x.numpy()),
                               rtol=1e-6)
    assert x.rank().numpy() == 2 and x.is_floating_point()
    assert x.matrix_transpose().shape == [2, 2]
    assert x.sinc_().numpy().shape == (2, 2)


def test_aliases_live_where_the_reference_defines_them():
    from paddle_tpu_torch.ops import logic, manip_extra, math, math_extra
    assert math_extra.gammaln is math.lgamma and TO.gammaln is math.lgamma
    assert manip_extra.less is logic.less_than and TO.less is logic.less_than
    assert manip_extra.bitwise_invert is logic.bitwise_not
