"""Op dispatch — the single chokepoint every operator goes through:
counterpart of ``paddle_tpu/core/dispatch.py``.

Reference analog: the generated `xxx_ad_func` layer (fluid/eager/auto_code_generator/
generator/eager_gen.py) + phi kernel dispatch (phi/core/kernel_factory.h:326). Here
an op is a function over torch tensors, and torch's autograd is the tape;
dispatch:

  1. unwraps Tensor args to their torch buffers,
  2. runs the fn — with grad recorded when grad mode is on and an input
     requires grad, under ``torch.no_grad()`` otherwise,
  3. wraps outputs in Tensors: 64-bit outputs narrow to 32 bits (the
     reference's JAX runs with x64 off), and non-float outputs stop
     gradients, as ``_FLOAT_KINDS`` does in the reference.

The port's grad mode IS torch's (``torch.is_grad_enabled()``): one switch,
so ``torch.no_grad()`` and ``paddle_tpu_torch.no_grad()`` are the same.

``_State`` keeps the reference's slots.  ``trace_ctx`` belongs to program
capture (``jit.to_static``): while it is set, Tensor reads, writes,
creation and host conversions go through it, and in its echo mode an op
returns shape-only placeholders without running.  ``amp_state`` belongs to
autocast (``amp``): while it is set, an op's float inputs are cast by the
O1 / O2 lists.  ``static_record`` (``static.program_guard``) is not
ported: setting it to anything but its default raises.
"""
from __future__ import annotations

import threading
import time
from typing import Callable

import torch

from .tensor import Tensor, _wrap
from . import flags, sharding
from .dtype import NARROW

# Process-wide metrics recorder (observability.enable()). Thread-locals are
# seeded from it on first access, so apply_op keeps exactly ONE
# instrumentation branch for both the profiler and the metrics registry.
_metrics_recorder = None


def _unported(slot, default, owner):
    """A _State slot whose owner is not ported: reads give the default,
    writes of anything else raise."""
    def get(self):
        return default

    def set_(self, value):
        if value is not default and value != default:
            raise NotImplementedError(
                f"_State.{slot} belongs to {owner}, which the port does not "
                "have yet")
    return property(get, set_)


class _State(threading.local):
    static_record = _unported("static_record", False, "static.program_guard (M13)")

    def __init__(self):
        self.trace_ctx = None          # active program-capture context (jit/)
        self.amp_state = None          # active autocast state (amp/)
        self.op_recorder = _metrics_recorder   # host-op instrumentation hook


_state = _State()


def in_echo() -> bool:
    """True inside a break-stitched step's echo pass (``jit/to_static.py``):
    the replayed program already did the step's work, so code that writes
    state outside ``apply_op`` (an optimizer's update, a loss scaler)
    returns without doing it."""
    tc = _state.trace_ctx
    return tc is not None and tc.mode == "echo"


class _FanoutRecorder:
    """Fans one dispatch record out to several recorders (profiler + metrics
    active at once) without a second branch in apply_op."""

    __slots__ = ("recorders",)

    def __init__(self, recorders):
        self.recorders = tuple(recorders)

    def record(self, name, dt, **kw):
        for r in self.recorders:
            r.record(name, dt, **kw)


def compose_recorders(*recorders):
    """None-pruning composition: 0 -> None, 1 -> it, n -> fan-out."""
    recs = tuple(r for r in recorders if r is not None)
    if not recs:
        return None
    if len(recs) == 1:
        return recs[0]
    return _FanoutRecorder(recs)


def metrics_recorder():
    """The process-wide metrics recorder (None while telemetry is off)."""
    return _metrics_recorder


def set_metrics_recorder(rec):
    """Install/remove the process-wide metrics recorder.

    New threads inherit it on first dispatch-state access; the calling
    thread's slot is rewritten in place, preserving a profiler recorder
    stacked on top of the previous metrics recorder."""
    global _metrics_recorder
    prev = _metrics_recorder
    _metrics_recorder = rec
    cur = _state.op_recorder
    if isinstance(cur, _FanoutRecorder):
        keep = [r for r in cur.recorders if r is not prev]
    elif cur is None or cur is prev:
        keep = []
    else:
        keep = [cur]
    _state.op_recorder = compose_recorders(*keep, rec)


def grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool) -> bool:
    prev = torch.is_grad_enabled()
    torch.set_grad_enabled(mode)
    return prev


def unwrap(x):
    """Tensor -> underlying torch tensor (trace-aware read)."""
    if isinstance(x, Tensor):
        tc = _state.trace_ctx
        if tc is not None:
            return tc.on_read(x)
        return x._buf
    return x


def _requires_grad(args) -> bool:
    if not torch.is_grad_enabled():
        return False
    for a in args:
        if isinstance(a, Tensor) and a._buf.requires_grad:
            return True
    return False


def _wrap_out(o, arrays, taped):
    """An op output as a Tensor: narrowed to 32 bits, and never the same
    torch object as an input (two Tensors must not share autograd flags)."""
    for a in arrays:
        if o is a:
            o = o.view_as(o) if taped else o.detach()
            break
    if sharding.DTensor is not None and isinstance(o, sharding.DTensor):
        o = sharding.settle(o)
    narrow = NARROW.get(o.dtype)
    if narrow is not None:
        o = o.to(narrow)
    return _wrap(o)


def apply_op(name: str, fn: Callable, *inputs, out_treedef_hint=None):
    """Run op `fn` over `inputs` (Tensors/tensors, the differentiable
    positions).

    Returns Tensor or tuple-of-Tensors mirroring fn's output structure.
    Attrs must be closed over inside `fn`.
    """
    rec = _state.op_recorder
    if rec is not None:
        t0 = time.perf_counter()
        try:
            return _apply_op_inner(name, fn, *inputs)
        finally:
            # facts the registry aggregates (autocast/tape/lift counts) are
            # re-derived here, on the instrumented path only, so the fast
            # path stays untouched
            rec.record(name, time.perf_counter() - t0,
                       amp=_state.amp_state is not None,
                       lifted=_state.trace_ctx is not None,
                       taped=_requires_grad(inputs))
    return _apply_op_inner(name, fn, *inputs)


def _apply_op_inner(name, fn, *inputs):
    tc = _state.trace_ctx
    if tc is None:
        arrays = tuple(a._buf if isinstance(a, Tensor) else a for a in inputs)
    elif tc.mode == "echo":
        # break-stitched replay (jit/to_static.py): the captured program
        # already ran; hand back shape-only placeholders with zero compute
        return tc.on_op_echo(name, inputs)
    else:
        # spy or capture: reads go through the context, which records
        # them (spy) or checks them against the spy's (capture)
        arrays = tuple(tc.on_read(a) if isinstance(a, Tensor) else a
                       for a in inputs)
    if sharding._gathered:
        arrays = sharding.gather_inputs(inputs, arrays)
    if _state.amp_state is not None:
        from ..amp import maybe_cast_inputs
        arrays = maybe_cast_inputs(name, arrays)
    taped = _requires_grad(inputs)
    try:
        if taped or not torch.is_grad_enabled():
            outs = fn(*arrays)
        else:
            with torch.no_grad():
                outs = fn(*arrays)
    except Exception as e:   # op-attributed errors (ref error summary)
        _attach_op_note(e, name, arrays)
        raise
    single = not isinstance(outs, (tuple, list))
    outs_t = (outs,) if single else outs
    if flags.flag("check_nan_inf"):
        _check_nan_inf(name, outs_t)
    wrapped = [_wrap_out(o, arrays, taped) for o in outs_t]
    if tc is not None:
        # op-tape hook: the capture records each dispatch so the echo pass
        # of a break-stitched signature can validate + placeholder it
        tc.on_op(name, single, wrapped)
    return wrapped[0] if single else tuple(wrapped)


def _op_error_note(name, arrays):
    """One-line op attribution appended to dispatch failures (analog of the
    reference's error summary with op name + input metas)."""
    metas = ", ".join(
        f"{tuple(getattr(a, 'shape', ()))}:{getattr(a, 'dtype', type(a).__name__)}"
        for a in arrays[:6])
    more = "..." if len(arrays) > 6 else ""
    return f"[paddle_tpu_torch] raised while dispatching op '{name}' ({metas}{more})"


def _attach_op_note(e, name, arrays):
    note = _op_error_note(name, arrays)
    if hasattr(e, "add_note"):           # PEP 678, python >= 3.11
        e.add_note(note)
    else:                                # 3.10: fold into the message instead
        e.args = ((f"{e.args[0]}\n{note}",) + e.args[1:]) if e.args else (note,)


def _check_nan_inf(name, outs):
    """FLAGS_check_nan_inf debug path (fluid/eager/nan_inf_utils.cc analog):
    a float output holding nan or inf raises (level 0) or is reported."""
    for o in outs:
        if isinstance(o, torch.Tensor) and (o.is_floating_point()
                                            or o.is_complex()):
            if not bool(torch.isfinite(o.detach()).all()):
                msg = f"nan/inf detected in output of op '{name}'"
                if flags.flag("check_nan_inf_level") == 0:
                    raise FloatingPointError(msg)
                print(f"[check_nan_inf] {msg}")  # graftlint: disable=no-adhoc-telemetry


def defop(name: str):
    """Decorator: define an op by its tensor-level implementation.

    @defop("tanh")
    def tanh(x): return torch.tanh(x)

    The wrapped callable takes Tensors (or anything tensor-like) positionally
    for differentiable inputs and keyword attrs, and routes through apply_op.
    """
    def deco(fn):
        def op(*args, **kwargs):
            if kwargs:
                f = lambda *arrs: fn(*arrs, **kwargs)
            else:
                f = fn
            return apply_op(name, f, *args)
        op.__name__ = name
        op.__qualname__ = name
        op.raw = fn
        return op
    return deco
