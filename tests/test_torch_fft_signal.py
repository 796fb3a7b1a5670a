"""The port's ``fft`` and ``signal`` (``paddle_tpu_torch/{fft,signal}.py``)
against the JAX package's, on the CPU.

- Every ``ops/registry.py`` entry whose op lives in ``paddle_tpu.fft`` or
  ``paddle_tpu.signal`` (26: the 22 ``fft`` names, ``stft``, ``istft``,
  ``frame``, ``overlap_add``): the port's output against the numpy golden
  (or the entry's check) and against the JAX package's output on the same
  inputs, at the entry's atol / rtol, with the same dtype; the gradients
  of the ``grad`` entries against the JAX package's at the same bar.
- Each transform at bf16 and float16: the port raises where ``jnp.fft``
  raises (the real-input transforms), and elsewhere computes in float32 as
  ``jnp.fft`` promotes, equal to the JAX output at 1e-4.
- Options the registry does not reach (``n`` / ``s`` / ``axes`` / ``norm``,
  complex inputs, a Hann window shorter than ``n_fft``, ``normalized``,
  two-sided, ``center=False``, ``pad_mode``, ``frame`` / ``overlap_add``
  over axis 0, the stft round trip of a windowed signal), and the
  gradients of a loss on ``|stft|`` and of ``fft`` / ``rfft`` / ``ihfft2``
  through a complex intermediate, at 1e-4.
- The complex-leaf gradient convention: ``|z|^2`` at ``z = 1 + 2j`` gives
  ``z.grad == 2 - 4j`` on both packages (JAX's convention; torch's own is
  the conjugate), through ``backward``, ``paddle.grad`` and a complex
  cotangent.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.fft as jfft
import paddle_tpu.signal as jsignal
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.ops.registry import REGISTRY
import paddle_tpu_torch as tp
import paddle_tpu_torch.fft as tfft
import paddle_tpu_torch.signal as tsignal
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.core.tensor import Tensor as TTensor

ENTRIES = sorted(n for n, s in REGISTRY.items()
                 if isinstance(s.op, str) and s.op.startswith(
                     ("paddle_tpu.fft.", "paddle_tpu.signal."))
                 or n == "istft")
GRAD = [n for n in ENTRIES if REGISTRY[n].grad]
TOL = dict(atol=1e-4, rtol=1e-4)
rng = np.random.RandomState(0)


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev


def _np(o):
    return np.asarray(o.numpy()) if isinstance(o, (JTensor, TTensor)) \
        else np.asarray(o)


def _port_op(name):
    if name == "istft":
        return lambda x: tsignal.istft(tsignal.stft(x, 16), 16,
                                       length=x.shape[-1])
    mod, attr = REGISTRY[name].op.rsplit(".", 1)
    return getattr({"paddle_tpu.fft": tfft,
                    "paddle_tpu.signal": tsignal}[mod], attr)


def _run(pkg, name, raw, grad=False):
    spec = REGISTRY[name]
    op = spec.resolve() if pkg is pt else _port_op(name)
    ins = [pkg.to_tensor(x, stop_gradient=not grad) for x in raw]
    return ins, op(*ins, **spec.kwargs)


def _dtype(o):
    return str(o._buf.dtype).rsplit(".", 1)[-1] if isinstance(o, TTensor) \
        else np.dtype(o._data.dtype).name


def test_the_selection():
    assert len(ENTRIES) == 26 and GRAD == ["frame", "overlap_add"]


@pytest.mark.parametrize("name", ENTRIES)
def test_entry_against_golden_and_jax(name):
    spec = REGISTRY[name]
    raw = spec.sample() if spec.sample else []
    _, out = _run(tp, name, raw)
    _, jout = _run(pt, name, raw)
    if spec.check is not None:
        spec.check(raw, out)
    else:
        want = np.asarray(spec.np_ref(*raw))
        np.testing.assert_allclose(_np(out).astype(np.complex128),
                                   want.astype(np.complex128),
                                   atol=spec.atol, rtol=spec.rtol)
    np.testing.assert_allclose(_np(out).astype(np.complex128),
                               _np(jout).astype(np.complex128),
                               atol=spec.atol, rtol=spec.rtol)
    assert _dtype(out) == _dtype(jout)


def _grads(pkg, name, raw):
    ins, out = _run(pkg, name, raw, grad=True)
    w = np.random.RandomState(7).uniform(0.5, 1.5, out.shape) \
        .astype(np.float32)
    (out * pkg.to_tensor(w)).sum().backward()
    return [_np(t.grad) for t in ins]


@pytest.mark.parametrize("name", GRAD)
def test_entry_grad_against_jax(name):
    spec = REGISTRY[name]
    raw = spec.sample()
    for g, w in zip(_grads(tp, name, raw), _grads(pt, name, raw)):
        np.testing.assert_allclose(g, w, atol=spec.atol, rtol=spec.rtol)


FFT_NAMES = [n for n in tfft.__all__ if n not in ("fftfreq", "rfftfreq")]
REAL_IN = {"rfft", "rfft2", "rfftn", "ihfft", "ihfft2", "ihfftn"}


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("name", FFT_NAMES)
def test_half_inputs_follow_jnp_fft(name, dtype):
    x = rng.uniform(-2, 2, (4, 8)).astype(np.float32)
    tx = tp.to_tensor(x).astype(dtype)
    jx = pt.to_tensor(x).astype(dtype)
    if name in REAL_IN:
        with pytest.raises(ValueError, match="RFFT input must be float32"):
            getattr(jfft, name)(jx)
        with pytest.raises(ValueError, match="RFFT input must be float32"):
            getattr(tfft, name)(tx)
        return
    out, jout = getattr(tfft, name)(tx), getattr(jfft, name)(jx)
    assert _dtype(out) == _dtype(jout)
    np.testing.assert_allclose(_np(out).astype(np.complex128),
                               _np(jout).astype(np.complex128), **TOL)


@pytest.mark.parametrize("name", sorted(REAL_IN))
def test_real_input_transforms_refuse_complex(name):
    z = (rng.rand(4, 8) + 1j * rng.rand(4, 8)).astype(np.complex64)
    with pytest.raises(ValueError, match="only real valued"):
        getattr(jfft, name)(pt.to_tensor(z))
    with pytest.raises(ValueError, match="only real valued"):
        getattr(tfft, name)(tp.to_tensor(z))


CASES = [
    ("fft", (6, 10), dict(n=12, axis=0, norm="ortho")),
    ("ifft", (6, 10), dict(n=7, norm="forward")),
    ("rfft", (6, 10), dict(n=16, axis=-1, norm="ortho")),
    ("irfft", (6, 10), dict(n=14, axis=0)),
    ("hfft", (6, 10), dict(n=9, norm="forward")),
    ("ihfft", (6, 10), dict(n=12)),
    ("fft2", (3, 6, 10), dict(s=(4, 8), axes=(0, 2), norm="ortho")),
    ("ifft2", (3, 6, 10), dict(axes=(1, 0))),
    ("rfft2", (3, 6, 10), dict(s=(6, 12))),
    ("irfft2", (3, 6, 10), dict(s=(6, 12), norm="forward")),
    ("fftn", (3, 6, 10), dict(axes=(0, 2))),
    ("ifftn", (3, 6, 10), dict(s=(2, 4, 6), norm="ortho")),
    ("rfftn", (3, 6, 10), dict(axes=(1, 2), norm="forward")),
    ("irfftn", (3, 6, 10), dict(s=(4, 8), axes=(0, 1))),
    ("hfft2", (3, 6, 10), dict(s=(4, 12))),
    ("ihfft2", (3, 6, 10), dict(s=(6, 8), norm="ortho")),
    ("hfftn", (3, 6, 10), dict(axes=(0, 2))),
    ("ihfftn", (3, 6, 10), dict(axes=(1, 2), norm="forward")),
    ("fftshift", (6, 10), dict(axes=(0,))),
    ("ifftshift", (6, 10), dict(axes=(1,))),
]


@pytest.mark.parametrize("complex_in", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("name,shape,kw", CASES, ids=[c[0] for c in CASES])
def test_options_against_jax(name, shape, kw, complex_in):
    x = rng.uniform(-2, 2, shape).astype(np.float32)
    if complex_in:
        if name in REAL_IN:
            pytest.skip("real-input transform")
        x = (x + 1j * rng.uniform(-2, 2, shape)).astype(np.complex64)
    out = getattr(tfft, name)(tp.to_tensor(x), **kw)
    jout = getattr(jfft, name)(pt.to_tensor(x), **kw)
    assert _dtype(out) == _dtype(jout) and out.shape == jout.shape
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)


@pytest.mark.parametrize("name,kw", [("fftfreq", dict(n=9, d=0.5)),
                                     ("rfftfreq", dict(n=10, d=2.0)),
                                     ("fftfreq", dict(n=8, dtype="float64"))])
def test_frequencies(name, kw):
    out, jout = getattr(tfft, name)(**kw), getattr(jfft, name)(**kw)
    assert _dtype(out) == _dtype(jout) == "float32"
    np.testing.assert_allclose(_np(out), _np(jout), atol=1e-7, rtol=1e-6)


def _hann(pkg, n):
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)
    return pkg.to_tensor(w.astype(np.float32))


STFT = [
    dict(n_fft=32, hop_length=8),
    dict(n_fft=32, hop_length=8, win_length=24, window=24),
    dict(n_fft=32, window=32, normalized=True),
    dict(n_fft=16, hop_length=4, onesided=False),
    dict(n_fft=16, hop_length=5, center=False),
    dict(n_fft=16, hop_length=4, pad_mode="constant"),
]


def _stft_kw(pkg, kw):
    kw = dict(kw)
    if "window" in kw:
        kw["window"] = _hann(pkg, kw["window"])
    return kw


@pytest.mark.parametrize("kw", STFT, ids=range(len(STFT)))
def test_stft_options_and_gradient(kw):
    x = rng.uniform(-1, 1, (3, 96)).astype(np.float32)
    outs = {}
    for pkg, sig in ((tp, tsignal), (pt, jsignal)):
        t = pkg.to_tensor(x, stop_gradient=False)
        spec = sig.stft(t, **_stft_kw(pkg, kw))
        (spec.abs() ** 2).sum().backward()
        outs[pkg] = (_np(spec), _np(t.grad))
    for got, want in zip(outs[tp], outs[pt]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_stft_of_a_complex_signal():
    x = (rng.rand(2, 64) + 1j * rng.rand(2, 64)).astype(np.complex64)
    out = tsignal.stft(tp.to_tensor(x), 16, onesided=True)
    jout = jsignal.stft(pt.to_tensor(x), 16, onesided=True)
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)


@pytest.mark.parametrize("kw", [dict(n_fft=32, hop_length=8, window=32),
                                dict(n_fft=32, hop_length=8, window=32,
                                     normalized=True),
                                dict(n_fft=16, hop_length=4,
                                     onesided=False)])
def test_istft_round_trip(kw):
    x = rng.uniform(-1, 1, (2, 128)).astype(np.float32)
    res = {}
    for pkg, sig in ((tp, tsignal), (pt, jsignal)):
        skw = _stft_kw(pkg, kw)
        spec = sig.stft(pkg.to_tensor(x), **skw)
        res[pkg] = _np(sig.istft(spec, length=128, **skw))
    np.testing.assert_allclose(res[tp], x, atol=1e-4)
    np.testing.assert_allclose(res[tp], res[pt], **TOL)


def test_frame_and_overlap_add_along_axis_0():
    x = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    f = tsignal.frame(tp.to_tensor(x), 8, 4, axis=0)
    jf = jsignal.frame(pt.to_tensor(x), 8, 4, axis=0)
    assert f.shape == jf.shape
    np.testing.assert_array_equal(_np(f), _np(jf))
    o = tsignal.overlap_add(f, 4, axis=0)
    jo = jsignal.overlap_add(jf, 4, axis=0)
    np.testing.assert_allclose(_np(o), _np(jo), **TOL)


@pytest.mark.parametrize("name", ["fft", "rfft", "ihfft2", "hfftn"])
def test_gradient_through_a_complex_intermediate(name):
    x = rng.uniform(-1, 1, (4, 8)).astype(np.float32)
    grads = []
    for pkg, mod in ((tp, tfft), (pt, jfft)):
        t = pkg.to_tensor(x, stop_gradient=False)
        out = getattr(mod, name)(t)
        loss = (out.abs() ** 2).sum() if out.dtype in (
            pkg.complex64,) else (out * out).sum()
        loss.backward()
        grads.append(_np(t.grad))
    np.testing.assert_allclose(grads[0], grads[1], **TOL)


def test_complex_leaf_gradient_is_the_reference_convention():
    z0 = np.array([1 + 2j], np.complex64)
    for pkg in (tp, pt):
        z = pkg.to_tensor(z0, stop_gradient=False)
        (z * z.conj()).real().sum().backward()
        np.testing.assert_allclose(_np(z.grad), [2 - 4j])
        z = pkg.to_tensor(z0, stop_gradient=False)
        (g,) = pkg.grad((z * z.conj()).real().sum(), z)
        np.testing.assert_allclose(_np(g), [2 - 4j])
        # a complex cotangent: y = c z, cotangent 1 + 1j
        z = pkg.to_tensor(z0, stop_gradient=False)
        y = z * pkg.to_tensor(np.array([3 + 1j], np.complex64))
        (g,) = pkg.grad(y, z, grad_outputs=pkg.to_tensor(
            np.array([1 + 1j], np.complex64)))
        np.testing.assert_allclose(_np(g), [2 + 4j])
