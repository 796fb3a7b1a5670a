"""The port's ``Tensor`` (``paddle_tpu_torch/core``) against the JAX
package's, on the CPU: ``tests/test_tensor.py`` mirrored case by case.

Each case runs the same program on both packages from the same numpy
inputs: the reference test's assertions hold on each, and the values the
program returns are equal across the two (float32 at 1e-6; dtypes by
name, since the port's dtypes are ``torch.dtype`` objects and the
reference's numpy ones — ROADMAP queue 3).  Also here: the dispatch
recorder feeding the ``dispatch_*`` metric families, and the devices and
places."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core import dtype as jdtypes
import paddle_tpu_torch as tp
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.core import dtype as tdtypes

@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev


def _name(pkg, dtype):
    return (jdtypes if pkg is pt else tdtypes).dtype_name(dtype)


def _same(fn):
    """fn(pkg) -> list of values, on both packages, equal across them."""
    got, want = fn(tp), fn(pt)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, str) or isinstance(w, bool) or w is None:
            assert g == w
        else:
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64), rtol=1e-6)


def test_to_tensor_basics():
    def run(pkg):
        t = pkg.to_tensor([[1.0, 2.0], [3.0, 4.0]])
        assert t.shape == [2, 2]
        assert _name(pkg, t.dtype) == "float32"
        assert t.stop_gradient
        assert t.ndim == 2
        assert t.size == 4
        np.testing.assert_array_equal(t.numpy(), [[1, 2], [3, 4]])
        return [t.numpy(), _name(pkg, t.dtype)]
    _same(run)


def test_dtypes():
    def run(pkg):
        i = pkg.to_tensor([1, 2])
        t = pkg.to_tensor([1.0], dtype="bfloat16")
        assert t.dtype == pkg.bfloat16
        t32 = t.astype("float32")
        assert _name(pkg, t32.dtype) == "float32"
        return [_name(pkg, i.dtype), _name(pkg, t.dtype), t32.numpy()]
    _same(run)


def test_port_dtypes_are_torch_dtypes():
    assert tp.bfloat16 is torch.bfloat16 and tp.float32 is torch.float32
    assert tdtypes.convert_dtype("int64") is torch.int32
    assert tdtypes.convert_dtype(np.float64) is torch.float32
    assert tdtypes.convert_dtype("BF16") is torch.bfloat16
    for name in ("bool", "uint8", "int8", "int16", "int32", "int64",
                 "float16", "bfloat16", "float32", "float64", "complex64",
                 "complex128"):
        assert (tdtypes.dtype_name(tdtypes.convert_dtype(name))
                == jdtypes.dtype_name(jdtypes.convert_dtype(name))), name
        assert (tdtypes.is_floating_point(name)
                == jdtypes.is_floating_point(name)), name
        assert tdtypes.is_integer(name) == jdtypes.is_integer(name), name


def test_bfloat16_numpy_round_trip():
    """bf16 ``numpy()`` gives float32 with the values exact (the card's
    machine has no ml_dtypes); ``to_tensor(f32, dtype="bfloat16")`` rounds
    as the reference's cast does."""
    a = np.random.RandomState(0).randn(64).astype(np.float32)
    t = tp.to_tensor(a, dtype="bfloat16")
    got = t.numpy()
    assert got.dtype == np.float32
    want = np.asarray(pt.to_tensor(a, dtype="bfloat16").numpy(), np.float32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tp.to_tensor(got, dtype="bfloat16").numpy(), got)


def test_arithmetic_overloads():
    def run(pkg):
        a = pkg.to_tensor([1.0, 2.0, 3.0])
        b = pkg.to_tensor([4.0, 5.0, 6.0])
        outs = [a + b, a - b, a * 2, 2 * a, a / 2, 2 ** a, 1 - a, -a,
                abs(pkg.to_tensor([-1.0, 2.0]))]
        wants = [[5, 7, 9], [-3, -3, -3], [2, 4, 6], [2, 4, 6],
                 [0.5, 1.0, 1.5], [2, 4, 8], [0, -1, -2], [-1, -2, -3], [1, 2]]
        for o, w in zip(outs, wants):
            np.testing.assert_allclose(o.numpy(), w)
        return [o.numpy() for o in outs]
    _same(run)


def test_weak_scalar_promotion():
    """Python scalars are weakly typed on both: int32 * 2.5 -> float32,
    int32 * 2 -> int32, bf16 * 2 -> bf16, int / int -> float32, bool + 1 ->
    int32; round is half to even; mod takes the divisor's sign, fmod the
    dividend's."""
    def run(pkg):
        i = pkg.to_tensor(np.array([1, -3, 4], np.int32))
        h = pkg.to_tensor([1.5, 2.5], dtype="bfloat16")
        bl = pkg.to_tensor(np.array([True, False]))
        outs = [i * 2.5, i * 2, h * 2, i / pkg.to_tensor(
            np.array([2, 2, 3], np.int32)), bl + 1, bl + bl,
            pkg.round(pkg.to_tensor([0.5, 1.5, 2.5, -0.5])),
            i % 3, pkg.fmod(i, pkg.to_tensor(np.array([3, 3, 3], np.int32)))]
        return [v for o in outs for v in (o.numpy().astype(np.float64),
                                          _name(pkg, o.dtype))]
    _same(run)


def test_matmul_overload():
    def run(pkg):
        a = pkg.to_tensor(np.eye(3, dtype=np.float32))
        b = pkg.to_tensor(np.arange(9, dtype=np.float32).reshape(3, 3))
        np.testing.assert_allclose((a @ b).numpy(), b.numpy())
        return [(a @ b).numpy()]
    _same(run)


def test_comparisons():
    def run(pkg):
        a = pkg.to_tensor([1.0, 2.0, 3.0])
        assert (a > 1.5).numpy().tolist() == [False, True, True]
        assert (a == 2.0).numpy().tolist() == [False, True, False]
        return [(a > 1.5).numpy(), (a == 2.0).numpy(),
                _name(pkg, (a > 1.5).dtype)]
    _same(run)


def test_indexing():
    def run(pkg):
        a = pkg.to_tensor(np.arange(12, dtype=np.float32).reshape(3, 4))
        assert a[0, 0].item() == 0.0
        assert a[-1].shape == [4]
        assert a[:, 1:3].shape == [3, 2]
        assert a[pkg.to_tensor([0, 2])].shape == [2, 4]
        b = a[a > 5.0]  # boolean mask (eager host path)
        assert b.shape == [6]
        return [a[-1].numpy(), a[:, 1:3].numpy(),
                a[pkg.to_tensor([0, 2])].numpy(), b.numpy()]
    _same(run)


def test_setitem():
    def run(pkg):
        a = pkg.to_tensor(np.zeros((3, 3), np.float32))
        a[1, 1] = 5.0
        assert a[1, 1].item() == 5.0
        a[0] = np.ones(3, np.float32)
        np.testing.assert_allclose(a[0].numpy(), [1, 1, 1])
        return [a.numpy()]
    _same(run)


def test_inplace_methods():
    def run(pkg):
        a = pkg.to_tensor([1.0, 2.0])
        a.add_(pkg.to_tensor([1.0, 1.0]))
        np.testing.assert_allclose(a.numpy(), [2, 3])
        a.scale_(scale=2.0)
        np.testing.assert_allclose(a.numpy(), [4, 6])
        a.zero_()
        np.testing.assert_allclose(a.numpy(), [0, 0])
        a.fill_(7.0)
        np.testing.assert_allclose(a.numpy(), [7, 7])
        return [a.numpy()]
    _same(run)


def test_inplace_on_a_trainable_leaf():
    """Under no_grad an in-place update keeps a parameter a trainable leaf
    with its gradient (the optimizer's step); with grad recorded the port
    refuses it, as Paddle does (queue 3: the reference records a node that
    points at the tensor itself)."""
    p = tp.Parameter(np.ones((2, 2), np.float32))
    (p * 3).sum().backward()
    g = p.grad
    with tp.no_grad():
        p.subtract_(p.grad * 0.5)
    np.testing.assert_allclose(p.numpy(), np.full((2, 2), -0.5))
    assert not p.stop_gradient and p.is_leaf
    assert p.grad is g and p.grad is p.grad
    np.testing.assert_allclose(p.grad.numpy(), np.full((2, 2), 3.0))
    with pytest.raises(RuntimeError, match="inplace"):
        p.add_(tp.ones([2, 2]))
    p.clear_grad()
    assert p.grad is None


def test_detach_and_clone():
    def run(pkg):
        a = pkg.to_tensor([1.0], stop_gradient=False)
        b = a * 2
        c = b.detach()
        assert c.stop_gradient and b._grad_node is not None and c._grad_node is None
        d = a.clone()
        assert not d.stop_gradient
        return [c.numpy(), d.numpy(), b.is_leaf, c.is_leaf]
    _same(run)


def test_item_and_scalar():
    def run(pkg):
        t = pkg.to_tensor(3.5)
        assert t.item() == pytest.approx(3.5)
        assert float(t) == pytest.approx(3.5)
        assert t.ndim == 0
        return [t.item(), float(t), int(t), bool(t), f"{t:.2f}"]
    _same(run)


def test_parameter():
    def run(pkg):
        p = pkg.Parameter(np.ones((2, 2), np.float32))
        assert not p.stop_gradient
        assert p.trainable
        assert p.persistable
        return [p.numpy(), repr(p).splitlines()[0]]
    _same(run)


def test_cast_preserves_grad():
    def run(pkg):
        a = pkg.to_tensor([1.0, 2.0], stop_gradient=False)
        b = a.astype("bfloat16")
        assert not b.stop_gradient
        b.sum().backward()
        assert a.grad is not None
        return [a.grad.numpy()]
    _same(run)


def test_stop_gradient_on_non_float_and_non_leaf():
    def run(pkg):
        i = pkg.to_tensor([1, 2])
        assert i.stop_gradient
        x = pkg.to_tensor([1.0, 2.0], stop_gradient=False)
        y = x * 3
        y.stop_gradient = True          # the sweep stops here
        z = (x * 2 + y).sum()
        z.backward()
        return [x.grad.numpy(), (x > 1).stop_gradient, y.stop_gradient]
    _same(run)


def test_repr_and_to():
    def run(pkg):
        t = pkg.to_tensor(np.arange(4, dtype=np.float32).reshape(2, 2))
        return [repr(t), t.to("float16").numpy(), _name(pkg, t.to(
            dtype="float16").dtype), t.cpu().numpy(), t.tolist(),
            t.T.numpy(), len(t), t.numel(), t.element_size()]
    _same(run)


def test_places():
    assert tp.get_device() == "cpu"
    t = tp.to_tensor([1.0])
    assert t.place.is_cpu_place() and not t.place.is_gpu_place()
    assert repr(t.place) == "Place(cpu:0)"
    assert tp.is_compiled_with_cuda()
    assert t.block_until_ready() is t


def test_dispatch_families_count_tensor_adds():
    """With telemetry on, two Tensor adds count dispatch_ops_total{op=add}
    == 2, and dispatch_taped_total counts the one whose input requires
    grad."""
    obs.reset()
    obs.enable()
    try:
        a = tp.to_tensor([1.0, 2.0])
        w = tp.to_tensor([3.0, 4.0], stop_gradient=False)
        a + a
        a + w
    finally:
        obs.disable()
    snap = obs.snapshot(prefix="dispatch_")
    assert obs.DISPATCH_OPS.labels(op="add").value == 2, snap
    assert obs.DISPATCH_TAPED.labels().value == 1, snap
    assert obs.DISPATCH_SECONDS.labels().count >= 2, snap
    from paddle_tpu_torch.core import dispatch
    assert dispatch._state.op_recorder is None
    a + a
    assert obs.DISPATCH_OPS.labels(op="add").value == 2


def test_unported_state_slots_raise():
    """``trace_ctx`` and ``amp_state`` take their owners' objects (a
    ``jit.to_static`` capture context, an ``amp`` autocast state) and give
    them back; ``static_record`` (M13's ``static.program_guard``) still
    refuses anything but its default."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core import dispatch
    from paddle_tpu_torch.jit.to_static import _SpyContext
    assert dispatch._state.trace_ctx is None
    assert dispatch._state.amp_state is None
    assert dispatch._state.static_record is False
    ctx = _SpyContext()
    dispatch._state.trace_ctx = ctx
    try:
        assert dispatch._state.trace_ctx is ctx
        x = tp.to_tensor([1.0, 2.0])          # created under the context
        assert id(x) in ctx.created and not ctx.reads
    finally:
        dispatch._state.trace_ctx = None
    with amp.auto_cast(level="O1"):
        st = dispatch._state.amp_state
        assert isinstance(st, amp.AmpState) and st is amp.amp_state()
    assert dispatch._state.amp_state is None
    dispatch._state.static_record = False     # the default is accepted
    with pytest.raises(NotImplementedError, match="program_guard"):
        dispatch._state.static_record = True


def test_check_nan_inf_flag():
    def run(pkg):
        pkg.set_flags({"FLAGS_check_nan_inf": True})
        try:
            x = pkg.to_tensor([1.0, 0.0])
            with pytest.raises(FloatingPointError, match="'log'"):
                pkg.log(x * 0.0)
            ok = (x + 1).numpy()
        finally:
            pkg.set_flags({"FLAGS_check_nan_inf": False})
        return [ok]
    _same(run)


def test_op_errors_name_the_op():
    def run(pkg):
        with pytest.raises(Exception) as e:
            pkg.matmul(pkg.to_tensor(np.ones((2, 3), np.float32)),
                       pkg.to_tensor(np.ones((2, 3), np.float32)))
        note = "\n".join(getattr(e.value, "__notes__", []))
        assert "dispatching op 'matmul'" in note, note
        return []
    _same(run)


def test_seed_and_rng_state_round_trip():
    """One torch.Generator a device behind Paddle's seed surface: a seed
    replays its draws, and a saved state resumes them."""
    import torch
    from paddle_tpu_torch.core import rng
    tp.seed(3)
    g = rng.next_generator("cpu")
    a = torch.rand(4, generator=g)
    state = tp.get_rng_state()
    b = torch.rand(4, generator=g)
    tp.set_rng_state(state)
    assert torch.equal(torch.rand(4, generator=g), b)
    tp.seed(3)
    assert torch.equal(torch.rand(4, generator=g), a)
    assert tp.get_default_generator().initial_seed() == 3


def test_top_level_names():
    """The reference's top-level names for what is ported; subpackages load
    lazily."""
    for name in ("Tensor", "Parameter", "to_tensor", "no_grad", "enable_grad",
                 "set_grad_enabled", "is_grad_enabled", "grad", "seed",
                 "set_device", "get_device", "is_tensor", "in_dynamic_mode",
                 "bfloat16", "float32", "int64", "bool", "add", "matmul",
                 "reshape", "concat", "where", "logical_and", "zeros",
                 "autograd", "CPUPlace", "get_default_generator"):
        assert hasattr(tp, name), name
        assert hasattr(pt, name), name
    assert tp.is_tensor(tp.to_tensor([1.0])) and not tp.is_tensor(1.0)
    assert tp.in_dynamic_mode()
    assert tp.nn.ClipGradByGlobalNorm is not None          # lazy subpackage
    assert tp.bool is torch.bool
