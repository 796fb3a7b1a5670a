"""The port's core op surface (``paddle_tpu_torch/ops/{creation,math,
manipulation,logic}.py`` and the methods ``ops/__init__.py`` installs on
``Tensor``) against the JAX package's, on the CPU.

- Every ``ops/registry.py`` golden whose reference op is defined in one of
  those four modules (chosen by the resolved function's ``__module__``):
  the port's output against the numpy golden and against the JAX package's
  output on the same numpy inputs, at the entry's atol / rtol, with the
  same dtype name.
- The ``grad=True`` entries among them: the gradients of a weighted sum
  of the outputs against the JAX package's, at the entry's atol / rtol
  (no entry asks for less than 1e-5; both are float32 analytic gradients).
- Every installable method name of the four modules (the reference's
  ``_METHODS``, ``_DELEGATED``, ``_INPLACE`` and ``_AUTO_INPLACE``) is on
  the port's ``Tensor``.
- The in-place semantics of ``test_op_suite.py::test_inplace_semantics``.
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

CORE = {f"paddle_tpu.ops.{m}" for m in
        ("creation", "math", "manipulation", "logic")}


def _module(fn):
    return getattr(fn, "__module__", None)


GOLDEN = sorted(n for n, s in REGISTRY.items()
                if s.kind == "golden" and _module(s.resolve()) in CORE)
GRAD = [n for n in GOLDEN if REGISTRY[n].grad]


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    """New port tensors land on the CPU here; the previous place comes
    back afterwards (the card default, for later files on this worker)."""
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


def _run(pkg, name, raw, grad=False):
    spec = REGISTRY[name]
    op = spec.resolve() if pkg is pt else getattr(TO, spec.op or name)
    ins = [_wrap(pkg, x, grad) for x in raw]
    return ins, op(*ins, **_kwargs(pkg, spec))


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


def test_the_selection_covers_the_four_modules():
    mods = {_module(REGISTRY[n].resolve()) for n in GOLDEN}
    assert mods == CORE and len(GOLDEN) >= 190 and len(GRAD) >= 90


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


def _installable():
    names = set(JO._METHODS)
    for name in JO._DELEGATED:
        fn = getattr(JO, name, None)
        if fn is not None and _module(fn) in CORE:
            names.add(name)
    for name, fn in JO._INPLACE.items():
        if _module(fn) in CORE:
            names.add(name)
    for base in JO._AUTO_INPLACE:
        fn = getattr(JO, base, None)
        if fn is not None and _module(fn) in CORE:
            names.add(base + "_")
    return sorted(names | {"floor_mod_", "set_", "fill_", "zero_",
                           "set_value"})


@pytest.mark.parametrize("name", _installable())
def test_method_installed(name):
    assert callable(getattr(TTensor, name, None)), f"Tensor.{name} missing"


@pytest.mark.parametrize("pkg", [pt, tp], ids=["jax", "port"])
def test_inplace_semantics(pkg):
    x = pkg.to_tensor(np.array([1.0, 4.0, 9.0], np.float32))
    y = x.clone()
    y.sqrt_()
    np.testing.assert_allclose(y.numpy(), np.sqrt(x.numpy()), rtol=1e-6)
    z = pkg.to_tensor(np.array([1.0, 2.0], np.float32))
    z.set_(pkg.to_tensor(np.array([5.0], np.float32)))
    assert z.shape == [1] and float(z.numpy()[0]) == 5.0
