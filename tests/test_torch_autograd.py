"""The port's autograd (``paddle_tpu_torch/autograd``: torch's tape under
Paddle's semantics) against the JAX package's, on the CPU.

Mirrored case by case: ``tests/test_autograd.py``; the ``nn``-free cases of
``test_double_grad.py`` (second and third order, create_graph grads having
a graph, the Hessian-vector product) and of
``test_functional_autograd.py`` (``jacobian`` / ``hessian``).  The cases
that need ``nn.Linear`` / ``nn.Sequential`` or ``incubate.autograd`` wait
for M2 / M13 (ROADMAP).  Each case runs the same program on both packages
from the same numpy inputs; the reference test's assertions hold on each,
and the returned values agree (float32 at 1e-5).

``retain_graph``: the reference raises on any second sweep over a freed
graph, torch only where a node needs a tensor it saved; the cases pinned
here (a product saves its inputs) agree, the rest is in ROADMAP queue 3.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as tp
from paddle_tpu.autograd import PyLayer as JPyLayer
from paddle_tpu.autograd import hessian as jhessian
from paddle_tpu.autograd import jacobian as jjacobian
from paddle_tpu_torch.autograd import PyLayer as TPyLayer
from paddle_tpu_torch.autograd import hessian as thessian
from paddle_tpu_torch.autograd import jacobian as tjacobian
from paddle_tpu_torch.autograd.backward import backward_split
from paddle_tpu_torch.core import device as tdevice


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev


def _same(fn, rtol=1e-5, atol=0.0):
    got, want = fn(tp), fn(pt)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None or isinstance(w, bool):
            assert g == w
        else:
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64), rtol=rtol,
                                       atol=atol)


def _np(t):
    return None if t is None else np.asarray(t.numpy())


# ---- test_autograd.py ---------------------------------------------------------
def test_simple_backward():
    def run(pkg):
        x = pkg.to_tensor([2.0, 3.0], stop_gradient=False)
        y = (x * x).sum()
        y.backward()
        np.testing.assert_allclose(x.grad.numpy(), [4.0, 6.0])
        return [_np(x.grad)]
    _same(run)


def test_chain_and_accumulate():
    def run(pkg):
        x = pkg.to_tensor(2.0, stop_gradient=False)
        y = x * x + x * 3  # dy/dx = 2x + 3 = 7
        y.backward()
        assert x.grad.item() == pytest.approx(7.0)
        z = x * 5
        z.backward()
        assert x.grad.item() == pytest.approx(12.0)
        return [x.grad.item()]
    _same(run)


def test_clear_grad():
    def run(pkg):
        x = pkg.to_tensor(1.0, stop_gradient=False)
        (x * 2).backward()
        x.clear_grad()
        assert x.grad is None
        (x * 2).backward()
        x.clear_grad(set_to_zero=True)
        return [x.grad.item()]
    _same(run)


def test_branching_graph():
    def run(pkg):
        x = pkg.to_tensor(3.0, stop_gradient=False)
        c = x * 2 + x * 4  # dc/dx = 6
        c.backward()
        assert x.grad.item() == pytest.approx(6.0)
        return [x.grad.item()]
    _same(run)


def test_shared_intermediate():
    def run(pkg):
        x = pkg.to_tensor(2.0, stop_gradient=False)
        h = x * x       # used twice
        y = h * 3 + h * 5  # y = 8x^2, dy/dx = 16x = 32
        y.backward()
        assert x.grad.item() == pytest.approx(32.0)
        return [x.grad.item()]
    _same(run)


def test_stop_gradient_blocks():
    def run(pkg):
        x = pkg.to_tensor(1.0, stop_gradient=False)
        y = pkg.to_tensor(2.0)  # stop_gradient=True
        z = x * y
        z.backward()
        assert x.grad.item() == pytest.approx(2.0)
        assert y.grad is None
        return [x.grad.item(), y.grad]
    _same(run)


def test_no_grad_context():
    def run(pkg):
        x = pkg.to_tensor(1.0, stop_gradient=False)
        with pkg.no_grad():
            y = x * 2
            off = pkg.is_grad_enabled()
        assert y.stop_gradient and y._grad_node is None
        return [off, pkg.is_grad_enabled()]
    _same(run)


def test_one_switch_with_torch():
    """The port's grad mode is torch's: each sees the other's switch."""
    x = tp.to_tensor(1.0, stop_gradient=False)
    with torch.no_grad():
        assert not tp.is_grad_enabled()
        assert (x * 2).stop_gradient
    with tp.no_grad():
        assert not torch.is_grad_enabled()
        with tp.enable_grad():
            assert torch.is_grad_enabled()
            assert not (x * 2).stop_gradient
    with tp.set_grad_enabled(False):
        assert not torch.is_grad_enabled()
    assert torch.is_grad_enabled()


def test_no_grad_decorator():
    def run(pkg):
        @pkg.no_grad()
        def f(t):
            return t * 2
        out = f(pkg.to_tensor(1.0, stop_gradient=False))
        assert out.stop_gradient
        return [out.item()]
    _same(run)


def test_paddle_grad_api():
    def run(pkg):
        x = pkg.to_tensor(2.0, stop_gradient=False)
        y = x * x * x
        (g,) = pkg.grad(y, x)
        assert g.item() == pytest.approx(12.0)
        assert x.grad is None  # pkg.grad must not pollute .grad
        return [g.item(), g.stop_gradient]
    _same(run)


def test_grad_leaves_other_leaves_alone():
    def run(pkg):
        x = pkg.to_tensor([1.0, 2.0], stop_gradient=False)
        w = pkg.to_tensor([3.0, 4.0], stop_gradient=False)
        (gx,) = pkg.grad((x * w).sum(), [x])
        assert w.grad is None and x.grad is None
        return [_np(gx)]
    _same(run)


def test_grad_allow_unused():
    def run(pkg):
        x = pkg.to_tensor(1.0, stop_gradient=False)
        u = pkg.to_tensor(1.0, stop_gradient=False)
        y = x * 2
        with pytest.raises(RuntimeError):
            pkg.grad(y, [x, u])
        y = x * 2  # rebuild: the failed sweep freed the graph (paddle semantics)
        g = pkg.grad(y, [x, u], allow_unused=True)
        assert g[1] is None
        return [g[0].item(), g[1]]
    _same(run)


def test_backward_nonscalar_default_ones():
    def run(pkg):
        x = pkg.to_tensor([1.0, 2.0], stop_gradient=False)
        y = x * 3
        y.backward()
        np.testing.assert_allclose(x.grad.numpy(), [3.0, 3.0])
        return [_np(x.grad)]
    _same(run)


def test_backward_with_grad_tensor():
    def run(pkg):
        x = pkg.to_tensor([1.0, 2.0], stop_gradient=False)
        y = x * x
        y.backward(pkg.to_tensor([1.0, 0.5]))
        np.testing.assert_allclose(x.grad.numpy(), [2.0, 2.0])
        return [_np(x.grad)]
    _same(run)


def test_backward_of_a_tensor_that_stops_gradients_is_a_no_op():
    def run(pkg):
        x = pkg.to_tensor([1.0, 2.0])
        (x * 2).sum().backward()
        return [x.grad]
    _same(run)


def test_retain_graph():
    def run(pkg):
        x = pkg.to_tensor(2.0, stop_gradient=False)
        y = x * x
        y.backward(retain_graph=True)
        y.backward()
        assert x.grad.item() == pytest.approx(8.0)
        with pytest.raises(RuntimeError):
            y.backward()  # graph freed now
        return [x.grad.item()]
    _same(run)


def test_hooks_modify_grad():
    def run(pkg):
        x = pkg.to_tensor(1.0, stop_gradient=False)
        h = x.register_hook(lambda g: g * 10)
        (x * 2).backward()
        assert x.grad.item() == pytest.approx(20.0)
        h.remove()
        x.clear_grad()
        (x * 2).backward()
        assert x.grad.item() == pytest.approx(2.0)
        return [x.grad.item()]
    _same(run)


def test_hook_on_an_intermediate_scales_upstream_grads():
    def run(pkg):
        x = pkg.to_tensor([1.0, 2.0], stop_gradient=False)
        h = x * 3
        h.register_hook(lambda g: g * 0.5)
        (h * h).sum().backward()
        return [_np(x.grad)]
    _same(run)


def test_hook_waits_until_the_tensor_requires_grad():
    def run(pkg):
        x = pkg.to_tensor([1.0, 2.0])
        x.register_hook(lambda g: g * 4)
        x.stop_gradient = False
        (x * x).sum().backward()
        return [_np(x.grad)]
    _same(run)


def test_retain_grads_intermediate():
    def run(pkg):
        x = pkg.to_tensor(2.0, stop_gradient=False)
        h = x * 3
        h.retain_grads()
        y = h * h
        y.backward()
        assert h.grad.item() == pytest.approx(12.0)
        return [h.grad.item(), x.grad.item()]
    _same(run)


def test_grad_is_cached_until_it_changes():
    x = tp.to_tensor([1.0], stop_gradient=False)
    (x * 2).backward()
    g = x.grad
    assert x.grad is g
    (x * 2).backward()              # accumulates into the same buffer
    assert x.grad is g and g.item() == pytest.approx(4.0)
    x.grad = tp.to_tensor([7.0])
    assert x.grad is not g and x.grad.item() == pytest.approx(7.0)


def test_multi_output_op_grad():
    def run(pkg):
        x = pkg.to_tensor(np.arange(6, dtype=np.float32), stop_gradient=False)
        a, b, c = pkg.split(x, 3)
        (a.sum() * 1 + b.sum() * 2 + c.sum() * 3).backward()
        np.testing.assert_allclose(x.grad.numpy(), [1, 1, 2, 2, 3, 3])
        return [_np(x.grad), a._out_slot, c._out_slot]
    _same(run)


def _cube(base):
    class Cube(base):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x * x

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor
            return dy * 3 * x * x
    return Cube


def test_pylayer():
    def run(pkg):
        Cube = _cube(JPyLayer if pkg is pt else TPyLayer)
        x = pkg.to_tensor(2.0, stop_gradient=False)
        y = Cube.apply(x)
        assert y.item() == pytest.approx(8.0)
        y.backward()
        assert x.grad.item() == pytest.approx(12.0)
        return [y.item(), x.grad.item()]
    _same(run)


def test_pylayer_two_inputs_one_without_grad():
    def make(base):
        class Mul(base):
            @staticmethod
            def forward(ctx, a, b, k=1.0):
                ctx.save_for_backward(a, b)
                return a * b * k

            @staticmethod
            def backward(ctx, dy):
                a, b = ctx.saved_tensor
                return dy * b, dy * a
        return Mul

    def run(pkg):
        Mul = make(JPyLayer if pkg is pt else TPyLayer)
        a = pkg.to_tensor([1.0, 2.0], stop_gradient=False)
        b = pkg.to_tensor([3.0, 5.0])
        Mul.apply(a, b, k=2.0).sum().backward()
        return [_np(a.grad), b.grad]
    _same(run)


def test_matmul_grad_matches_reference():
    rng = np.random.RandomState(0)
    a = rng.rand(3, 4).astype(np.float32)
    b = rng.rand(4, 2).astype(np.float32)

    def run(pkg):
        x = pkg.to_tensor(a, stop_gradient=False)
        w = pkg.to_tensor(b, stop_gradient=False)
        (x @ w).sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), np.ones((3, 2)) @ b.T, rtol=1e-5)
        np.testing.assert_allclose(w.grad.numpy(), a.T @ np.ones((3, 2)), rtol=1e-5)
        return [_np(x.grad), _np(w.grad)]
    _same(run)


def test_backward_split_waits_for_pipeline_parallelism():
    """``backward_split`` (the zero-bubble split) since pipeline parallelism
    came: B fills the input's gradient at once and no parameter's; the
    deferred W closures fill the parameters', as the reference's do, and
    both equal the reference's."""
    from paddle_tpu.autograd.backward import backward_split as jsplit
    rng = np.random.RandomState(3)
    w, b = rng.rand(2, 2).astype(np.float32), rng.rand(2).astype(np.float32)
    a = rng.rand(3, 2).astype(np.float32)

    def run(pkg):
        lin = pkg.nn.Linear(2, 2)
        lin.set_state_dict({"weight": pkg.to_tensor(w),
                            "bias": pkg.to_tensor(b)})
        x = pkg.to_tensor(a, stop_gradient=False)
        y = lin(x)
        split = backward_split if pkg is tp else jsplit
        deferred = split([(y * y).mean()], [None],
                         {id(p) for p in lin.parameters()})
        assert x.grad is not None and len(deferred) >= 1
        assert all(p.grad is None for p in lin.parameters())
        gx = _np(x.grad)
        for f in deferred:
            f()
        return [gx] + [_np(p.grad) for p in lin.parameters()]
    _same(run)


# ---- test_double_grad.py (the nn-free cases) ----------------------------------
def test_second_order_polynomial():
    def run(pkg):
        x = pkg.to_tensor(np.array([1.5, -2.0, 3.0], np.float32),
                          stop_gradient=False)
        y = (x ** 3).sum()
        (g1,) = pkg.grad(y, [x], create_graph=True)
        np.testing.assert_allclose(g1.numpy(), 3 * x.numpy() ** 2, rtol=1e-5)
        (g2,) = pkg.grad(g1.sum(), [x])
        np.testing.assert_allclose(g2.numpy(), 6 * x.numpy(), rtol=1e-5)
        return [_np(g1), _np(g2)]
    _same(run)


def test_third_order():
    def run(pkg):
        x = pkg.to_tensor(np.array([1.2], np.float32), stop_gradient=False)
        (g1,) = pkg.grad((x ** 4).sum(), [x], create_graph=True)
        (g2,) = pkg.grad(g1.sum(), [x], create_graph=True)
        (g3,) = pkg.grad(g2.sum(), [x])
        np.testing.assert_allclose(g3.numpy(), [24 * 1.2], rtol=1e-4)
        return [_np(g1), _np(g2), _np(g3)]
    _same(run)


def test_create_graph_grads_have_graph():
    def run(pkg):
        x = pkg.to_tensor(np.array([2.0], np.float32), stop_gradient=False)
        (g,) = pkg.grad((x ** 2).sum(), [x], create_graph=True)
        assert g._grad_node is not None          # differentiable
        (g_plain,) = pkg.grad((x ** 2).sum(), [x])
        assert g_plain._grad_node is None        # first-order: detached
        return [_np(g), _np(g_plain)]
    _same(run)


def test_hessian_vector_product():
    def run(pkg):
        x = pkg.to_tensor(np.array([1.0, 2.0], np.float32),
                          stop_gradient=False)
        v = pkg.to_tensor(np.array([0.5, -1.0], np.float32))
        # f = x0^2 * x1 ; H = [[2*x1, 2*x0], [2*x0, 0]]
        f = (x[0] ** 2) * x[1]
        (g,) = pkg.grad(f, [x], create_graph=True)
        (hv,) = pkg.grad((g * v).sum(), [x])
        H = np.array([[2 * 2.0, 2 * 1.0], [2 * 1.0, 0.0]], np.float32)
        np.testing.assert_allclose(hv.numpy(), H @ v.numpy(), rtol=1e-5)
        return [_np(hv)]
    _same(run)


def test_gradient_penalty_shape_without_nn():
    """The double-backward shape WGAN-GP uses (test_double_grad.py's
    network cases), on a hand-written two-layer net of Parameters."""
    rng = np.random.RandomState(0)
    w1v = (0.5 * rng.randn(4, 8)).astype(np.float32)
    w2v = (0.5 * rng.randn(8, 1)).astype(np.float32)
    xv = rng.rand(3, 4).astype(np.float32)

    def run(pkg):
        w1, w2 = pkg.Parameter(w1v), pkg.Parameter(w2v)
        x = pkg.to_tensor(xv, stop_gradient=False)
        out = (pkg.tanh(x @ w1) @ w2).sum()
        (gx,) = pkg.grad(out, [x], create_graph=True)
        gp = ((gx ** 2).sum(axis=1).sqrt() - 1.0).pow(2).mean()
        gp.backward()
        return [gp.item(), _np(w1.grad), _np(w2.grad)]
    _same(run, rtol=1e-4, atol=1e-6)


# ---- test_functional_autograd.py (jacobian / hessian) -------------------------
def _t(pkg, a, stop_gradient=False):
    t = pkg.to_tensor(np.asarray(a, np.float32))
    t.stop_gradient = stop_gradient
    return t


def _jac(pkg):
    return jjacobian if pkg is pt else tjacobian


def _hess(pkg):
    return jhessian if pkg is pt else thessian


def test_jacobian_matches_analytic_linear():
    A = np.array([[1., 2., 3.], [4., 5., 6.]], np.float32)

    def run(pkg):
        x = _t(pkg, [1., -1., 2.])
        J = _jac(pkg)(pkg.to_tensor(A) @ x, x)
        np.testing.assert_allclose(J.numpy(), A, atol=1e-6)
        return [_np(J)]
    _same(run)


def test_jacobian_elementwise_nonlinear():
    def run(pkg):
        x = _t(pkg, [0.5, 1.0, 2.0])
        J = _jac(pkg)(x * x * x, x)
        np.testing.assert_allclose(J.numpy(),
                                   np.diag(3 * np.array([0.25, 1.0, 4.0])),
                                   rtol=1e-5)
        return [_np(J)]
    _same(run)


def test_jacobian_multiple_xs_and_ys():
    def run(pkg):
        x1, x2 = _t(pkg, [1.0, 2.0]), _t(pkg, [3.0])
        y1 = (x1 * 2).sum() + x2[0]
        y2 = x1[0] * x2[0]
        out = _jac(pkg)([y1, y2], [x1, x2])
        np.testing.assert_allclose(out[0][0].numpy(), [[2., 2.]])
        np.testing.assert_allclose(out[0][1].numpy(), [[1.]])
        np.testing.assert_allclose(out[1][0].numpy(), [[3., 0.]])
        np.testing.assert_allclose(out[1][1].numpy(), [[1.]])
        return [_np(o) for row in out for o in row]
    _same(run)


def test_jacobian_batched():
    xv = np.random.RandomState(0).randn(4, 3)

    def run(pkg):
        xb = _t(pkg, xv)
        J = _jac(pkg)(xb * xb, xb, batch_axis=0)
        assert J.shape == [4, 3, 3]
        for b in range(4):
            np.testing.assert_allclose(J.numpy()[b],
                                       np.diag(2 * xb.numpy()[b]), rtol=1e-5)
        return [_np(J)]
    _same(run)


def test_jacobian_unused_input_gives_zeros():
    def run(pkg):
        x1, x2 = _t(pkg, [1.0, 2.0]), _t(pkg, [3.0, 4.0])
        out = _jac(pkg)((x1 * x1).sum(), [x1, x2])
        np.testing.assert_allclose(out[1].numpy(), [[0., 0.]])
        return [_np(out[0]), _np(out[1])]
    _same(run)


def test_hessian_quadratic_form():
    Q = np.array([[2., 1.], [1., 4.]], np.float32)

    def run(pkg):
        x = _t(pkg, [1.0, -2.0])
        H = _hess(pkg)(0.5 * (x @ pkg.to_tensor(Q) @ x), x)
        np.testing.assert_allclose(H.numpy(), Q, atol=1e-5)
        return [_np(H)]
    _same(run)


def test_hessian_matches_finite_difference():
    x0 = np.array([0.7, -1.3], np.float32)
    eps = 1e-3

    def val(v):   # float64 reference (f32 FD noise swamps eps^2)
        v = v.astype(np.float64)
        return (v ** 3).sum() + v[0] * v[1]
    num = np.zeros((2, 2))
    for i in range(2):
        for j in range(2):
            pp = x0.copy(); pp[i] += eps; pp[j] += eps
            pm = x0.copy(); pm[i] += eps; pm[j] -= eps
            mp = x0.copy(); mp[i] -= eps; mp[j] += eps
            mm = x0.copy(); mm[i] -= eps; mm[j] -= eps
            num[i, j] = (val(pp) - val(pm) - val(mp) + val(mm)) / (4 * eps * eps)

    def run(pkg):
        t = _t(pkg, x0)
        H = _hess(pkg)((t * t * t).sum() + (t[0] * t[1]), t).numpy()
        np.testing.assert_allclose(H, num, atol=1e-2)
        return [H]
    _same(run)


def test_hessian_batched():
    xv = np.random.RandomState(0).randn(3, 2)

    def run(pkg):
        xb = _t(pkg, xv)
        H = _hess(pkg)((xb * xb).sum(axis=1), xb, batch_axis=0)
        assert H.shape == [3, 2, 2]
        for b in range(3):
            np.testing.assert_allclose(H.numpy()[b], 2 * np.eye(2), atol=1e-5)
        return [_np(H)]
    _same(run)


def test_hessian_non_scalar_raises():
    def run(pkg):
        x = _t(pkg, [1.0, 2.0])
        with pytest.raises(ValueError):
            _hess(pkg)(x * x, x)
        return []
    _same(run)
