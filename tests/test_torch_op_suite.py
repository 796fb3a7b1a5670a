"""The registry-driven op suite over the port: ``tests/test_op_suite.py``'s
golden, smoke, alias, in-place and finite-difference gradient cases, run
on ``paddle_tpu_torch`` for every one of the 472 ``ops/registry.py``
entries, on the CPU.

- Each entry's op is the port's function of the same name
  (``paddle_tpu_torch.ops.<name>``, or ``paddle_tpu_torch.fft`` /
  ``.signal`` where the entry names ``paddle_tpu.fft`` / ``.signal``).
  The ten entries whose op is defined in ``registry.py`` itself (a lambda
  or a ``_..._smoke`` helper that builds its own inputs: ``einsum``,
  ``bucketize``, ``lu_unpack``, ``index_add``, ``scatter_nd``,
  ``broadcast_shape``, ``as_real``, ``multiplex``, ``is_tensor`` and
  ``istft``) have their twins here, written over the port the same way.
- golden: the port's output against the entry's numpy golden (or its
  golden-by-property ``check``) at the entry's atol / rtol.
- smoke: every float output finite.  alias: both names callable on the
  port.  in-place: the method is on the port's ``Tensor``.
- grad: the port's analytic gradients of a weighted sum of the outputs
  against central finite differences of the port's own op (``op_test``'s
  harness: delta 1e-3 on float32 inputs, atol / rtol 8e-3).
"""
import importlib

import numpy as np
import pytest

from paddle_tpu.ops.registry import REGISTRY, U, I, _scatter_nd_smoke  # noqa: F401
import paddle_tpu_torch as tp
import paddle_tpu_torch.ops as TO
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.core.tensor import Tensor

GOLDEN = sorted(n for n, s in REGISTRY.items() if s.kind == "golden")
SMOKE = sorted(n for n, s in REGISTRY.items() if s.kind == "smoke")
ALIAS = sorted(n for n, s in REGISTRY.items() if s.kind == "alias")
INPLACE = sorted(n for n, s in REGISTRY.items() if s.kind == "inplace")
GRAD = sorted(n for n, s in REGISTRY.items() if s.grad)


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev


# ---- the twins of the ops defined in registry.py ----------------------------
def _lu_unpack_helper(a):
    lu_t, piv = TO.lu(a)
    return TO.lu_unpack(lu_t, piv)


def _index_add_smoke():
    return TO.index_add(tp.to_tensor(U(4, 3)),
                        tp.to_tensor(np.array([0, 2])), 0,
                        tp.to_tensor(np.ones((2, 3), np.float32)))


def _scatter_nd_smoke():
    return TO.scatter_nd(tp.to_tensor(np.array([[1], [3]])),
                         tp.to_tensor(np.ones((2, 3), np.float32)),
                         shape=[5, 3])


def _broadcast_shape_smoke():
    return TO.broadcast_shape([1, 4], [3, 1])


def _as_real_smoke():
    c = TO.as_complex(tp.to_tensor(U(3, 2)))
    return TO.as_real(c)


def _multiplex_smoke():
    ins = [tp.to_tensor(U(3, 4)), tp.to_tensor(U(3, 4, seed=1))]
    return TO.multiplex(ins, tp.to_tensor(I(3, 1, hi=2)))


def _is_tensor_smoke():
    assert TO.is_tensor(tp.to_tensor(U(2)))
    return tp.to_tensor(U(2))


def _istft_roundtrip(x):
    from paddle_tpu_torch import signal
    spec = signal.stft(x, 16)
    return signal.istft(spec, 16, length=x.shape[-1])


TWINS = {
    "einsum": lambda a, b_: TO.einsum("ij,jk->ik", a, b_),
    "bucketize": lambda x, e: TO.bucketize(x, e),
    "lu_unpack": _lu_unpack_helper,
    "index_add": _index_add_smoke,
    "scatter_nd": _scatter_nd_smoke,
    "broadcast_shape": _broadcast_shape_smoke,
    "as_real": _as_real_smoke,
    "multiplex": _multiplex_smoke,
    "is_tensor": _is_tensor_smoke,
    "istft": _istft_roundtrip,
}


def _port_op(spec):
    if spec.name in TWINS:
        return TWINS[spec.name]
    target = spec.op if isinstance(spec.op, str) else spec.name
    if "." in target:
        modname, attr = target.rsplit(".", 1)
        assert modname.split(".")[0] == "paddle_tpu", target
        mod = importlib.import_module("paddle_tpu_torch" + modname[10:])
        return getattr(mod, attr)
    return getattr(TO, target)


def _wrap(x, grad=False):
    if isinstance(x, list):
        return [_wrap(v) for v in x]
    return tp.to_tensor(x, stop_gradient=not grad)


def _kwargs(spec):
    return {k: (tp.to_tensor(v) if isinstance(v, np.ndarray) else v)
            for k, v in spec.kwargs.items()}


def _run(spec):
    raw = spec.sample() if spec.sample else []
    return raw, _port_op(spec)(*[_wrap(x) for x in raw], **_kwargs(spec))


def _flat_outs(out):
    if isinstance(out, (list, tuple)):
        return [o for v in out for o in _flat_outs(v)]
    return [out] if isinstance(out, Tensor) else []


def test_every_entry_resolves_on_the_port():
    assert len(REGISTRY) == 472
    missing = [n for n, s in REGISTRY.items() if s.kind in ("golden", "smoke")
               and not callable(_port_op(s))]
    assert missing == []


@pytest.mark.parametrize("name", GOLDEN)
def test_golden(name):
    spec = REGISTRY[name]
    raw, out = _run(spec)
    if spec.check is not None:
        spec.check(raw, out)
        return
    ref = spec.np_ref(*raw)
    outs = out if isinstance(out, (list, tuple)) else [out]
    refs = ref if isinstance(ref, (list, tuple)) else [ref]
    assert len(outs) >= len(refs), name
    for o, r in zip(outs, refs):
        o_np = np.asarray(o.numpy()) if isinstance(o, Tensor) else np.asarray(o)
        r_np = np.asarray(r)
        if np.iscomplexobj(r_np) or np.iscomplexobj(o_np):
            np.testing.assert_allclose(o_np.astype(np.complex128),
                                       r_np.astype(np.complex128),
                                       atol=spec.atol, rtol=spec.rtol)
        elif r_np.dtype == np.bool_ or o_np.dtype == np.bool_:
            np.testing.assert_array_equal(o_np.astype(bool), r_np.astype(bool))
        elif np.issubdtype(r_np.dtype, np.integer):
            np.testing.assert_array_equal(o_np.astype(np.int64),
                                          r_np.astype(np.int64))
        else:
            np.testing.assert_allclose(o_np.astype(np.float64),
                                       r_np.astype(np.float64),
                                       atol=spec.atol, rtol=spec.rtol)


@pytest.mark.parametrize("name", SMOKE)
def test_smoke(name):
    spec = REGISTRY[name]
    _, out = _run(spec)
    for o in _flat_outs(out):
        a = np.asarray(o.numpy())
        if np.issubdtype(a.dtype, np.floating):
            assert np.isfinite(a).all(), f"{name} produced non-finite output"


@pytest.mark.parametrize("name", ALIAS)
def test_alias(name):
    spec = REGISTRY[name]
    assert callable(getattr(TO, name))
    assert callable(getattr(TO, spec.alias_of))


@pytest.mark.parametrize("name", INPLACE)
def test_inplace_installed(name):
    assert callable(getattr(Tensor, name, None)), f"Tensor.{name} missing"


def _numeric_grad(op, inputs, idx, out_grads, kwargs, delta=1e-3):
    """Central-difference dL/dx[idx], L = sum(op(x) * out_grad)
    (``op_test.numeric_grad`` over the port)."""
    x = inputs[idx].astype(np.float64)
    grad = np.zeros_like(x)
    flat, gflat = x.reshape(-1), grad.reshape(-1)

    def run(xv):
        args = [a.copy() for a in inputs]
        args[idx] = xv.astype(inputs[idx].dtype)
        outs = _flat_outs(op(*[tp.to_tensor(a) for a in args], **kwargs))
        return sum(float((o.numpy().astype(np.float64) * g).sum())
                   for o, g in zip(outs, out_grads))

    for i in range(flat.size):
        orig = flat[i]
        flat[i] = orig + delta
        hi = run(x)
        flat[i] = orig - delta
        lo = run(x)
        flat[i] = orig
        gflat[i] = (hi - lo) / (2 * delta)
    return grad


@pytest.mark.parametrize("name", GRAD)
def test_grad(name):
    spec = REGISTRY[name]
    raw = spec.sample() if spec.sample else []
    if not raw or any(isinstance(x, list) for x in raw):
        pytest.skip("grad check needs plain tensor inputs")
    idx = [i for i, x in enumerate(raw)
           if np.issubdtype(np.asarray(x).dtype, np.floating)]
    op, kwargs = _port_op(spec), _kwargs(spec)
    tensors = [_wrap(x, grad=True) for x in raw]
    outs = _flat_outs(op(*tensors, **kwargs))
    rng = np.random.RandomState(7)
    out_grads = [rng.uniform(0.1, 1.0, o.shape).astype(np.float32)
                 for o in outs]
    tp.autograd.backward(outs, [tp.to_tensor(g) for g in out_grads])
    for i in idx:
        g = tensors[i].grad
        analytic = (g.numpy().astype(np.float64) if g is not None
                    else np.zeros_like(raw[i], np.float64))
        numeric = _numeric_grad(op, raw, i, out_grads, kwargs)
        np.testing.assert_allclose(analytic, numeric, atol=8e-3, rtol=8e-3,
                                   err_msg=f"{name}: grad of input {i}")


@pytest.mark.parametrize("name", GOLDEN + SMOKE)
def test_output_dtype_matches_the_reference(name):
    """The port's outputs carry the JAX package's dtypes (x64 off: 64-bit
    results narrow to 32 bits on both)."""
    import paddle_tpu as pt
    from paddle_tpu.core.tensor import Tensor as JTensor
    spec = REGISTRY[name]
    if spec.op is not None and not isinstance(spec.op, str) \
            or name in TWINS:
        pytest.skip("the op builds its own inputs or is a lambda")
    raw, out = _run(spec)
    jins = [[pt.to_tensor(v) for v in x] if isinstance(x, list)
            else pt.to_tensor(x) for x in raw]
    jkw = {k: (pt.to_tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in spec.kwargs.items()}
    jout = spec.resolve()(*jins, **jkw)

    def flat(o, cls):
        if isinstance(o, (list, tuple)):
            return [v for x in o for v in flat(x, cls)]
        return [o] if isinstance(o, cls) else []
    got = [str(o._buf.dtype).rsplit(".", 1)[-1] for o in flat(out, Tensor)]
    want = [np.dtype(o._data.dtype).name for o in flat(jout, JTensor)]
    if spec.kind == "smoke":
        got, want = got[:len(want)], want[:len(got)]
    assert got == want, (name, got, want)
