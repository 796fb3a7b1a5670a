"""``paddle_tpu_torch.amp`` against the JAX package's ``paddle_tpu.amp`` on
the CPU: the O1 / O2 cast of every list entry both packages dispatch (the
output dtype the reference's gives, the values at the bf16 bar: 2e-2 of
the largest element), ``decorate``, ``GradScaler`` with an inf gradient
(step skipped, scale halved) and its ``state_dict`` round trip, the
low-precision op audit (``TestLowPrecisionAudit``'s twin), the list names
against the ops each package dispatches, and an O1 + ``GradScaler`` step
captured by ``jit.to_static``."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.amp as jamp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as tp
import paddle_tpu_torch.amp as tamp
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.core.dtype import dtype_name as tname
from paddle_tpu.core.dtype import dtype_name as jname

REPO = Path(__file__).resolve().parent.parent
BF16_BAR = 2e-2


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev


def _rand(shape, seed, lo=0.1, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


_LBL = np.array([0, 3, 1, 4], np.int64)
_IDS = np.array([[0, 2], [1, 3]], np.int64)
# op name -> (call(pkg, F, *inputs), input shapes, input range)
CASES = {
    "matmul": (lambda P, F, a, b: P.matmul(a, b), [(4, 8), (8, 3)], None),
    "bmm": (lambda P, F, a, b: P.bmm(a, b), [(2, 4, 8), (2, 8, 3)], None),
    "mv": (lambda P, F, a, b: P.mv(a, b), [(4, 8), (8,)], None),
    "linear": (lambda P, F, x, w, b: F.linear(x, w, b),
               [(4, 8), (8, 3), (3,)], None),
    "addmm": (lambda P, F, i, a, b: P.addmm(i, a, b),
              [(4, 3), (4, 8), (8, 3)], None),
    "embedding": (lambda P, F, w: F.embedding(P.to_tensor(_IDS), w),
                  [(5, 4)], None),
    "scaled_dot_product_attention": (
        lambda P, F, q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), [(1, 128, 1, 64)] * 3, None),
    "flash_attention": (
        lambda P, F, q, k, v: F.flash_attention(q, k, v, causal=True)[0],
        [(1, 128, 1, 64)] * 3, None),
    "cross_entropy": (lambda P, F, x: F.cross_entropy(x, P.to_tensor(_LBL)),
                      [(4, 5)], None),
    "nll_loss": (lambda P, F, x: F.nll_loss(x, P.to_tensor(_LBL)),
                 [(4, 5)], None),
    "log_softmax": (lambda P, F, x: F.log_softmax(x, axis=-1), [(4, 5)],
                    None),
    "pow": (lambda P, F, x: P.pow(x, 2.0), [(4, 5)], None),
    "cumsum": (lambda P, F, x: P.cumsum(x, axis=0), [(4, 5)], None),
    "cumprod": (lambda P, F, x: P.cumprod(x, dim=0), [(4, 5)], None),
    "logsumexp": (lambda P, F, x: P.logsumexp(x), [(4, 5)], None),
    "sum": (lambda P, F, x: P.sum(x), [(4, 5)], None),
    "erfinv": (lambda P, F, x: P.erfinv(x), [(4, 5)], (-0.5, 0.5)),
    "layer_norm": (lambda P, F, x, w, b: F.layer_norm(x, [8], w, b),
                   [(4, 8), (8,), (8,)], None),
    "rms_norm": (lambda P, F, x, w: F.rms_norm(x, w), [(4, 8), (8,)], None),
    "batch_norm": (lambda P, F, x, m, v: F.batch_norm(x, m, v),
                   [(4, 3), (3,), (3,)], None),
    "group_norm": (lambda P, F, x: F.group_norm(x, 2), [(2, 4, 3, 3)], None),
    "instance_norm": (lambda P, F, x: F.instance_norm(x), [(2, 3, 4, 4)],
                      None),
    "mse_loss": (lambda P, F, a, b: F.mse_loss(a, b), [(4, 5)] * 2, None),
    "l1_loss": (lambda P, F, a, b: F.l1_loss(a, b), [(4, 5)] * 2, None),
    "bce_with_logits": (
        lambda P, F, a, b: F.binary_cross_entropy_with_logits(a, b),
        [(4, 5)] * 2, None),
    "binary_cross_entropy": (lambda P, F, a, b: F.binary_cross_entropy(a, b),
                             [(4, 5)] * 2, None),
    "kl_div": (lambda P, F, a, b: F.kl_div(a, b), [(4, 5)] * 2, None),
    "einsum": (lambda P, F, a, b: P.einsum("ij,jk->ik", a, b),
               [(4, 8), (8, 3)], None),
    "p_norm": (lambda P, F, x: P.linalg.norm(x, p=3, axis=1), [(4, 5)],
               None),
}
for _name in ("exp", "log", "log2", "log10", "log1p", "expm1", "square",
              "sqrt", "rsqrt", "erf"):
    CASES[_name] = ((lambda n: lambda P, F, x: getattr(P, n)(x))(_name),
                    [(4, 5)], None)


def _run(pkg, name, level, in_dtype):
    call, shapes, rng = CASES[name]
    lo, hi = rng or (0.1, 1.0)
    F = JF if pkg is pt else TF
    amp = jamp if pkg is pt else tamp
    ins = [pkg.to_tensor(_rand(s, i, lo, hi)).astype(in_dtype)
           for i, s in enumerate(shapes)]
    with amp.auto_cast(level=level):
        out = call(pkg, F, *ins)
    name_of = jname if pkg is pt else tname
    return name_of(out.dtype), np.asarray(out.astype("float32").numpy())


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_each_list_entry_casts_as_the_reference(name, in_dtype, level):
    jd, jv = _run(pt, name, level, in_dtype)
    td, tv = _run(tp, name, level, in_dtype)
    assert td == jd, f"{name} {level} on {in_dtype}: {td} vs {jd}"
    top = max(float(np.abs(jv).max()), 1e-6)
    assert np.abs(tv - jv).max() <= BF16_BAR * top, name
    if level == "O1" and name in tamp.WHITE_LIST:
        assert td == "bfloat16"
    if level == "O1" and name in tamp.BLACK_LIST:
        assert td == "float32"


def _dispatched(root):
    """{op name: modules (relative to the package) that dispatch it}."""
    out = {}
    base = REPO / root
    for f in base.rglob("*.py"):
        for n in ast.walk(ast.parse(f.read_text())):
            if isinstance(n, ast.Call) and n.args \
                    and isinstance(n.args[0], ast.Constant) \
                    and isinstance(n.args[0].value, str):
                fn = n.func.id if isinstance(n.func, ast.Name) else getattr(
                    n.func, "attr", None)
                if fn in ("apply_op", "_unary", "_binary", "defop"):
                    out.setdefault(n.args[0].value, set()).add(
                        str(f.relative_to(base)))
    return out


# entries neither package dispatches under that name (``mm`` dispatches as
# ``matmul`` in both; the conv functionals and the others are Paddle op
# names the reference's lists carry over)
DEAD = {"mm", "conv1d", "conv2d", "conv3d", "conv1d_transpose",
        "conv2d_transpose", "conv3d_transpose", "norm", "mean_all",
        "softmax_grad_blk", "softmax_with_cross_entropy"}


def test_list_entries_name_the_ops_the_port_dispatches():
    """The lists are the reference's, and each entry the reference
    dispatches from a module the port has is dispatched by the port under
    the same name (an entry that matched no port op would cast nothing)."""
    assert tamp.WHITE_LIST == jamp.WHITE_LIST
    assert tamp.BLACK_LIST == jamp.BLACK_LIST
    ref, port = _dispatched("paddle_tpu"), _dispatched("paddle_tpu_torch")
    waiting = {}
    for name in sorted(tamp.WHITE_LIST | tamp.BLACK_LIST):
        if name in DEAD:
            assert name not in ref and name not in port, name
            continue
        mods = ref[name]
        if any((REPO / "paddle_tpu_torch" / m).exists() for m in mods):
            assert name in port, f"{name} ({sorted(mods)}) is not dispatched"
        else:
            waiting[name] = sorted(mods)
    # nothing waits for a module the port does not have
    assert waiting == {}
    # every entry both dispatch is exercised by the cast test above
    assert set(CASES) == (tamp.WHITE_LIST | tamp.BLACK_LIST) - DEAD \
        - set(waiting)


# the units of amp/__init__.py that differ from the reference's: the
# scaler's state lives on the device (its scale and counts, the fused
# unscale and found-inf test), and the casts test torch tensors
DIVERGENT = {"__doc__", "maybe_cast_inputs", "_device_scalar", "_unscale",
             "active_loss_scale", "GradScaler", "GradScaler.__init__",
             "GradScaler.scale", "GradScaler.unscale_", "GradScaler.update",
             "GradScaler.get_loss_scaling", "GradScaler.set_init_loss_scaling",
             "GradScaler.state_dict", "GradScaler.load_state_dict"}


def test_amp_is_the_reference_s_but_its_listed_divergences():
    from _torch_copies import differing_units
    got = {u for u in differing_units("amp/__init__.py")
           if not u.startswith("statement ")}
    assert got == DIVERGENT


def test_o2_casts_everything_but_the_black_list_and_custom_lists():
    x = _rand((4, 8), 0)
    for pkg, amp in ((pt, jamp), (tp, tamp)):
        name_of = jname if pkg is pt else tname
        a = pkg.to_tensor(x)
        with amp.auto_cast(level="O2"):
            assert name_of((a + a).dtype) == "bfloat16"        # not listed
            assert name_of(pkg.exp(a).dtype) == "float32"      # black: kept
        with amp.auto_cast(level="O1", custom_black_list={"matmul"}):
            assert name_of(pkg.matmul(a, a.T).dtype) == "float32"
        with amp.auto_cast(level="O1", custom_white_list={"exp"}):
            assert name_of(pkg.exp(a).dtype) == "bfloat16"
        with amp.auto_cast(enable=False):
            assert name_of(pkg.matmul(a, a.T).dtype) == "float32"
        assert amp.amp_state() is None


def test_decorate_o2_casts_parameters_and_sets_master_weights():
    pt.seed(0)
    jl = jnn.Linear(4, 3)
    tl = tnn.Linear(4, 3)
    tl.set_state_dict({k: np.asarray(v.numpy())
                       for k, v in jl.state_dict().items()})
    outs = {}
    for pkg, amp, lin in ((pt, jamp, jl), (tp, tamp, tl)):
        opt = pkg.optimizer.AdamW(learning_rate=0.1,
                                  parameters=lin.parameters())
        m2, o2 = amp.decorate(lin, opt, level="O2")
        assert m2 is lin and o2 is opt and opt._multi_precision
        name_of = jname if pkg is pt else tname
        assert {name_of(p.dtype) for p in lin.parameters()} == {"bfloat16"}
        assert amp.decorate(lin, level="O1") is lin
        x = pkg.to_tensor(_rand((2, 4), 1))
        with amp.auto_cast(level="O2"):
            loss = (lin(x) ** 2).mean()
        loss.backward()
        opt.step()
        outs[pkg.__name__] = np.asarray(lin.weight.astype("float32").numpy())
    np.testing.assert_allclose(outs["paddle_tpu_torch"], outs["paddle_tpu"],
                               rtol=BF16_BAR, atol=1e-3)


def _inf_step(pkg, amp, init=2.0 ** 10):
    pt.seed(0)
    jl = jnn.Linear(4, 2)
    lin = jl if pkg is pt else tnn.Linear(4, 2)
    if pkg is tp:
        lin.set_state_dict({k: np.asarray(v.numpy())
                            for k, v in jl.state_dict().items()})
    opt = pkg.optimizer.SGD(learning_rate=0.1, parameters=lin.parameters())
    scaler = amp.GradScaler(init_loss_scaling=init, incr_every_n_steps=2)
    w0 = np.asarray(lin.weight.numpy()).copy()
    x = pkg.to_tensor(_rand((3, 4), 2))
    loss = (lin(x) ** 2).mean()
    scaler.scale(loss).backward()
    g = np.asarray(lin.weight.grad.numpy()).copy()
    g[0, 0] = np.inf
    lin.weight.grad = pkg.to_tensor(g)
    scaler.step(opt)                # found inf: skipped, scale halved
    skipped = np.array_equal(np.asarray(lin.weight.numpy()), w0)
    after_inf = scaler.get_loss_scaling()
    opt.clear_grad()
    for _ in range(2):              # two good steps: the scale doubles
        loss = (lin(x) ** 2).mean()
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
    return (skipped, after_inf, scaler.get_loss_scaling(),
            scaler.state_dict(), np.asarray(lin.weight.numpy()))


def test_grad_scaler_skips_an_inf_step_and_halves_the_scale():
    j = _inf_step(pt, jamp)
    t = _inf_step(tp, tamp)
    assert t[0] and j[0]                       # the inf step was skipped
    assert t[1] == j[1] == 2.0 ** 9            # scale halved
    assert t[2] == j[2] == 2.0 ** 10           # doubled after two good steps
    assert t[3] == j[3]                        # state_dict, key by key
    np.testing.assert_allclose(t[4], j[4], rtol=1e-5, atol=1e-6)


def test_grad_scaler_state_dict_round_trip_and_getters():
    for amp in (jamp, tamp):
        s = amp.GradScaler(init_loss_scaling=512.0, incr_every_n_steps=7,
                           decr_every_n_nan_or_inf=3)
        s.set_init_loss_scaling(64.0)
        sd = s.state_dict()
        s2 = amp.GradScaler()
        s2.load_state_dict(sd)
        assert s2.get_loss_scaling() == 64.0
        assert {k: sd[k] for k in ("scale", "good_steps", "bad_steps")} == {
            k: s2.state_dict()[k] for k in ("scale", "good_steps",
                                            "bad_steps")}
        assert s.is_enable() and s.is_use_dynamic_loss_scaling()
        off = amp.GradScaler(enable=False)
        assert off.get_loss_scaling() == 1.0 and not off.is_enable()
        assert amp.is_bfloat16_supported() and amp.is_float16_supported()
    assert tamp.GradScaler().state_dict() == jamp.GradScaler().state_dict()


def test_active_loss_scale_tracks_the_scaling_window():
    lin = tnn.Linear(4, 2)
    opt = tp.optimizer.SGD(learning_rate=0.1, parameters=lin.parameters())
    s = tamp.GradScaler(init_loss_scaling=8.0)
    assert tamp.active_loss_scale() == 1.0
    loss = lin(tp.to_tensor(_rand((3, 4), 3))).sum()
    s.scale(loss).backward()
    assert tamp.active_loss_scale() == 8.0
    s.step(opt)
    assert tamp.active_loss_scale() == 1.0


def test_grad_scaler_refuses_a_row_sparse_gradient():
    class SelectedRows:             # the reference's row-sparse gradient
        rows, values, height = None, None, 0

    class P:
        grad = SelectedRows()

    class Opt:
        _parameter_list = [P()]

    with pytest.raises(NotImplementedError, match="SelectedRows"):
        tamp.GradScaler().unscale_(Opt())


class TestLowPrecisionAudit:
    def test_audit_records_low_precision_ops(self):
        rng = np.random.RandomState(0)
        seen = {}
        for pkg, amp, nn in ((pt, jamp, jnn), (tp, tamp, tnn)):
            pkg.set_flags({"FLAGS_low_precision_op_list": 1})
            amp.clear_low_precision_op_list()
            try:
                lin = nn.Linear(4, 4)
                x = pkg.to_tensor(rng.rand(2, 4).astype(np.float32))
                with amp.auto_cast(level="O1"):
                    lin(x)
                    pkg.exp(x)               # black: f32, not audited
                ops_seen = amp.low_precision_op_list()
                assert any("linear" in k or "matmul" in k for k in ops_seen), \
                    ops_seen
                seen[pkg.__name__] = ops_seen
            finally:
                pkg.set_flags({"FLAGS_low_precision_op_list": 0})
                amp.clear_low_precision_op_list()
            assert amp.low_precision_op_list() == {}
        assert seen["paddle_tpu_torch"] == seen["paddle_tpu"]


def test_o1_grad_scaler_step_captured_matches_eager_and_jax():
    """An O1 + GradScaler train step under ``jit.to_static`` (the found-inf
    test is a value guard) against the same step eager and the JAX
    package's eager step, on the same weights, at the bf16 bar."""
    pt.seed(0)
    jl = jnn.Linear(8, 4)
    sd = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    rng = np.random.RandomState(5)
    xs = [rng.rand(16, 8).astype(np.float32) for _ in range(4)]
    ys = [rng.rand(16, 4).astype(np.float32) for _ in range(4)]
    runs = {}
    for tag, pkg, amp, nn in (("static", tp, tamp, tnn),
                              ("eager", tp, tamp, tnn),
                              ("jax", pt, jamp, jnn)):
        lin = jl if pkg is pt else nn.Linear(8, 4)
        if pkg is tp:
            lin.set_state_dict(sd)
        opt = pkg.optimizer.AdamW(learning_rate=1e-2,
                                  parameters=lin.parameters())
        scaler = amp.GradScaler(init_loss_scaling=2.0 ** 8)

        def step(x, y, lin=lin, opt=opt, scaler=scaler, amp=amp):
            with amp.auto_cast(level="O1"):
                loss = ((lin(x) - y) ** 2).mean()
            scaler.scale(loss).backward()
            scaler.step(opt)
            opt.clear_grad()
            return loss

        fn = tp.jit.to_static(step) if tag == "static" else step
        runs[tag] = [float(np.asarray(fn(pkg.to_tensor(x),
                                         pkg.to_tensor(y)).numpy()))
                     for x, y in zip(xs, ys)]
        runs[tag + "_w"] = np.asarray(lin.weight.numpy())
        if tag == "static":
            (group,) = fn._cache.values()
            assert not group.eager_only
            assert group.variants[-1].guard_kinds == ("bool",)
            assert scaler.get_loss_scaling() == 2.0 ** 8
    np.testing.assert_allclose(runs["static"], runs["eager"], rtol=1e-6)
    np.testing.assert_allclose(runs["static_w"], runs["eager_w"], rtol=1e-6)
    np.testing.assert_allclose(runs["static"], runs["jax"], rtol=BF16_BAR)
    np.testing.assert_allclose(runs["static_w"], runs["jax_w"], rtol=BF16_BAR,
                               atol=1e-3)
