"""Program capture — paddle.jit.to_static: counterpart of
``paddle_tpu/jit/to_static.py`` (reference: python/paddle/jit/api.py:197 +
the SOT bytecode frontend python/paddle/jit/sot/).

Capture exploits the port's trace-transparent eager core as the
reference's does: every op goes through one dispatch chokepoint, and
Tensor state reads / writes / creation / host conversions go through the
active trace context (``core/dispatch.py`` ``_state.trace_ctx``):

  call 1 (SPY)     — runs eagerly at full fidelity while recording which
                     external tensors the function READS (params, buffers,
                     optimizer moments, the rate) and WRITES (rebinding
                     writes, ``.grad`` writes), which had a ``.grad`` when
                     the step began and which have one when it ends, and
                     the scalar events (bool/int guards, float/numpy
                     breaks).
  call 2 (CAPTURE) — on the card, re-runs the SAME python under a capture
                     context into ONE CUDA graph (``jit/capture.py``
                     ``CapturedProgram``, no warm-up run: the spy was it):
                     forward, backward, clipping, the optimizer update and
                     ``clear_grad``; the call's result is the graph's first
                     replay.
  call 3+ (REPLAY) — the graph replays; the python body does not run.

Where the reference's program is a pure function of its lifted inputs, a
graph reads and writes fixed addresses:

* Tensor arguments are copied into static buffers before each replay.
* External state is read and written where it lives: the optimizer
  writes its updates into the leaves in place.  A REBINDING write (a
  Tensor's ``_data`` set to a new buffer) is copied back into the storage
  the graph reads at the end of the step, and the Tensor is bound to that
  storage again.  Every external Tensor the spy saw read must keep its
  buffer between calls, or the call re-spies (``MissedCapture``).
* Gradients: a ``.grad`` present when the step begins (accumulation with
  ``clear_grad`` outside the step) is staged into a static buffer, the
  graph's input; a ``.grad`` present when it ends is copied into a static
  buffer, the graph's output, and bound after each replay; the others are
  None after each call.  A call whose tensors hold gradients other than
  the spy saw re-spies.
* Generators: the port's default generator of the device is registered
  with the graph, so each replay draws fresh numbers (dropout).

Guards (the SOT guard analog): arg treedef + shapes/dtypes/device +
static-arg values — a new signature re-spies.  A bool()/int() conversion
of a tensor inside the step is a VALUE GUARD: the capture substitutes the
spy's value (specializing the graph on that branch) and writes the
traced value into a static output.  After a replay the guard values are
read (one device->host read a call, only for a guarded variant) and
checked; on divergence the step's state writes are rolled back from a
snapshot the graph took when it began (guarded and break-stitched variants
copy every external tensor they may write — parameters, moments, the
rate, staged gradients — at their start), and a variant specialized on
the new values is looked up or captured.  Each variant is one graph; all
variants of a ``StaticFunction`` share one graph memory pool.

float() conversions and .numpy() reads are STITCHED breaks, not
de-compilations: the captured program writes each value into a static
output, and after the replay an ECHO pass re-runs the python with every op
dispatch short-circuited to shape-only placeholders (meta tensors): zero
device compute, but the python between breaks (logging, metric appends,
f-strings) runs with the TRUE per-call values.  Code that writes state
outside ``apply_op`` does nothing in the echo (``core.dispatch.in_echo``:
``backward``, an optimizer's ``step``, ``GradScaler``).  The step's
gradients commit only after the echo confirms the op sequence matched the
capture; a divergence (tensor ops conditioned on a broken-out value) rolls
the state back, runs the call eagerly once and pins the signature
eager-only — loudly, never silently wrong.

On the CPU nothing is captured: each call runs the same capture-context
body on the same static buffers (as ``CapturedProgram`` does), with the
same guards, snapshot, rollback and commits.  Breaks there hand the body
the true values directly, and the op sequence is checked against the
capture's as the body runs, where the card's echo checks it after the
replay; so a metric hook runs once a call on both.

Restrictions as in the reference (documented, checked): a value read at a
break must not feed back into tensor computation; a TENSOR kept past the
step (``history.append(loss)`` inside the fn) is an echo placeholder on
the card's steady-state calls, and any later host read raises.  Host work
the graph cannot hold (LBFGS's host line search) raises ``GraphBreak``
while capturing, and the signature stays eager, logged.  Work a capture
cannot record raises on the card; nothing falls back silently.

Shapes are static per signature; variable seq-len is handled by bucketing
above (SURVEY §7).
"""
from __future__ import annotations

import functools
import logging
import weakref

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..core.tensor import Tensor, _wrap
from ..core.dispatch import _state
from .. import observability as _obs
from .capture import CapturedProgram, graph_pool

logger = logging.getLogger("paddle_tpu_torch.jit")

__all__ = ["to_static", "not_to_static", "StaticFunction", "scan_steps",
           "ScanStaticFunction", "MissedCapture", "EchoMismatch",
           "GraphBreak", "EchoPlaceholderTensor"]


class GraphBreak(RuntimeError):
    """Host work inside the step that a graph cannot hold (the reference's
    jax concretization errors): raised while capturing; the signature
    stays eager."""


_BREAKS = (GraphBreak,)


class MissedCapture(Exception):
    """Replay/compile saw state the spy pass didn't record. ``permanent=True``
    marks deterministic rejections (e.g. scan_steps restrictions) that re-spying
    can never fix — the signature goes eager-only immediately."""

    def __init__(self, msg, permanent=False):
        super().__init__(msg)
        self.permanent = permanent


class EchoMismatch(Exception):
    """The echo pass diverged from the traced op sequence: the python path
    depends on a float()/.numpy() break value in a way that changes which ops
    run.  The compiled result is untrustworthy for this call — state was NOT
    committed; the caller falls back to eager and pins the signature there."""


_GUARD_KINDS = ("bool", "int")
_BREAK_KINDS = ("float", "numpy")


class EchoPlaceholderTensor(Tensor):
    """Shape-only stand-in the echo pass returns from every short-circuited
    op dispatch (its buffer is a meta tensor, never data). User code that
    smuggles one past the step — ``history.append(loss)`` inside the
    captured fn, read outside it — gets a pointed error on any host read.
    Inside echo passes reads still route through the active trace context
    like any Tensor."""

    __slots__ = ()

    def _post_echo_error(self):
        return RuntimeError(
            "host read of an echo-pass placeholder Tensor: this value was "
            "produced inside a to_static/scan_steps step and carries no "
            "data outside the call that made it. Read it inside the step "
            "(float()/.numpy() there are stitched breaks) or return it "
            "from the step function — see the break-stitching notes in "
            "paddle_tpu_torch/jit/to_static.py.")

    def numpy(self):
        if _state.trace_ctx is None:
            raise self._post_echo_error()
        return super().numpy()

    def _convert_scalar(self, kind, caster):
        if _state.trace_ctx is None:
            raise self._post_echo_error()
        return super()._convert_scalar(kind, caster)


def _placeholder(shape, dtype, stop_gradient):
    t = EchoPlaceholderTensor.__new__(EchoPlaceholderTensor)
    buf = torch.empty(shape, dtype=dtype, device="meta")
    if not stop_gradient and (buf.is_floating_point() or buf.is_complex()):
        buf.requires_grad_(True)
    t._buf = buf
    t._sg = stop_gradient
    t._grad_buf = None
    t.name = None
    t.persistable = False
    t._retain_grad = False
    t._hooks = None
    t._replay_node = None
    return t


def _is_tensor(x):
    return isinstance(x, Tensor)


def _host(buf):
    """A torch tensor's host copy as ``Tensor.numpy`` makes it."""
    return _wrap(buf)._host()


def _leaf_with_grad(t):
    b = t._buf
    return b.requires_grad and b.grad_fn is None


class _SpyContext:
    """Eager pass-through that records external reads + writes + scalar
    events (bool/int guards, float/numpy breaks), and which external
    tensors had a ``.grad`` when first touched."""

    mode = "spy"

    def __init__(self):
        self.reads: dict[int, Tensor] = {}
        self.writes: dict[int, Tensor] = {}
        self.grad_reads: dict[int, Tensor] = {}
        self.grad_writes: dict[int, Tensor] = {}
        self.had_grad: dict[int, bool] = {}
        self.created: set[int] = set()
        self.created_refs: list = []
        # ordered (kind, concrete value): bool/int -> guards, float/numpy ->
        # breaks; one stream so the capture/echo can verify the exact sequence
        self.events: list[tuple[str, object]] = []

    def _first_touch(self, t):
        k = id(t)
        if k not in self.had_grad:
            self.had_grad[k] = t._buf.grad is not None
        return k

    def on_scalar(self, t, kind, caster):
        # read through on_read so a tensor consumed ONLY via bool()/int()/
        # float() is still recorded as an external read
        v = caster(self.on_read(t).detach())
        self.events.append((kind, v))
        return v

    def on_materialize(self, t):
        """Full-array host read (Tensor.numpy()): a break event."""
        self.on_read(t)
        arr = t._host()
        self.events.append(("numpy", arr))
        return arr

    def on_create(self, t):
        self.created.add(id(t))
        self.created_refs.append(weakref.ref(t))

    def lazy_state(self):
        """Persistable tensors the spy call created that are still alive:
        state made on first use (optimizer accumulators, the master
        weights), external from the next call on."""
        return [t for t in (r() for r in self.created_refs)
                if t is not None and t.persistable]

    def on_read(self, t):
        if id(t) not in self.created:
            self.reads.setdefault(self._first_touch(t), t)
        return t._buf

    def on_write(self, t, value):
        if id(t) not in self.created:
            self.writes.setdefault(self._first_touch(t), t)
        return False

    def on_grad_read(self, t):
        # a pre-existing grad read before any write this step (gradient
        # accumulation with clear_grad outside the captured fn) is external
        # state: record it so the capture stages it as a program input
        if id(t) not in self.created and id(t) not in self.grad_writes:
            self.grad_reads.setdefault(self._first_touch(t), t)
        return t._grad_value()

    def on_grad_write(self, t, value):
        if id(t) not in self.created:
            self.grad_writes.setdefault(self._first_touch(t), t)
        return False

    def on_op(self, name, single, outs):
        pass


class _CaptureContext:
    """The step re-run into the program: reads of the call's arguments go
    to the static buffers, reads of persistable state the spy did not see
    raise ``MissedCapture`` (state created lazily by the spy call), guards
    substitute the spy's values and emit their traced ones, breaks emit
    theirs, rebinding writes are recorded for write-back, and the op tape
    is recorded (and, on the CPU, checked against the capture's)."""

    mode = "capture"

    def __init__(self, entry, arg_map):
        self.entry = entry
        self.arg_map = arg_map                # id(arg Tensor) -> static Tensor
        self.created: set[int] = set()
        self.plan = entry.events
        self.plan_idx = 0
        self.guard_outs: list[torch.Tensor] = []
        self.break_outs: list[torch.Tensor] = []
        self.op_tape: list[tuple] = []
        self.writeback: dict[int, tuple] = {}  # id -> (Tensor, its buffer)
        # on the CPU the body itself checks the op sequence the echo checks
        # on the card, from its second run on
        self.check_tape = entry.op_tape if entry.live and entry.break_kinds \
            and entry.op_tape else None

    def on_create(self, t):
        self.created.add(id(t))

    def on_read(self, t):
        k = id(t)
        a = self.arg_map.get(k)
        if a is not None:
            return a._buf
        if t.persistable and k not in self.created \
                and k not in self.entry.known_ids:
            raise MissedCapture(
                f"persistable tensor {t.name or k!r} read during capture was "
                "not captured in the spy pass")
        return t._buf

    def on_write(self, t, value):
        k = id(t)
        if k not in self.created and k not in self.writeback:
            if k not in self.entry.write_ids:
                raise MissedCapture(
                    f"tensor {t.name or k!r} rebound during capture was not "
                    "written in the spy pass")
            self.writeback[k] = (t, t._buf)
        return False

    def on_grad_read(self, t):
        return t._grad_value()

    def on_grad_write(self, t, value):
        return False

    def _next_event(self, kind):
        i = self.plan_idx
        if i >= len(self.plan) or self.plan[i][0] != kind:
            raise MissedCapture(
                "scalar-conversion sequence diverged from the spy pass")
        self.plan_idx += 1
        return self.plan[i][1]

    def on_scalar(self, t, kind, caster):
        planned = self._next_event(kind)
        val = self.on_read(t).detach().reshape(())
        if kind == "bool":
            self.guard_outs.append((val != 0).to(torch.int64))
        elif kind == "int":
            self.guard_outs.append(val.to(torch.int64))   # trunc toward zero
        else:
            # float break: ride out in the traced dtype (an f32 round trip
            # would be observable for int64 counters); float() happens on
            # the host in the echo, or here on the CPU
            self.break_outs.append(val)
            if self.entry.live:
                return caster(val)
        return planned

    def on_materialize(self, t):
        planned = self._next_event("numpy")
        buf = self.on_read(t).detach()
        self.break_outs.append(buf)
        return _host(buf) if self.entry.live else planned

    def on_op(self, name, single, outs):
        i = len(self.op_tape)
        if self.check_tape is not None and (
                i >= len(self.check_tape) or self.check_tape[i][0] != name):
            raise EchoMismatch(
                f"op #{i} diverged from the capture (expected "
                f"{self.check_tape[i][0] if i < len(self.check_tape) else 'end'}"
                f", got '{name}') — tensor ops appear to depend on a "
                "float()/.numpy() break value")
        self.op_tape.append((name, single, tuple(
            (tuple(o._buf.shape), o._buf.dtype, o.stop_gradient)
            for o in outs)))

    def write_back(self):
        """Copy each rebinding write into the storage the program reads,
        and bind the Tensor to that storage again."""
        with torch.no_grad():
            for t, orig in self.writeback.values():
                new = t._buf
                if new is orig:
                    continue
                if new.shape != orig.shape or new.dtype != orig.dtype:
                    raise MissedCapture(
                        f"state tensor {t.name or id(t)!r} changes shape/dtype"
                        " inside the step; a captured step needs stable state",
                        permanent=True)
                orig.copy_(new)
        self.unbind()

    def unbind(self):
        for t, orig in self.writeback.values():
            new = t._buf
            if new is not orig:
                if new.grad_fn is None and new.grad is not None \
                        and orig.requires_grad:
                    orig.grad = new.grad
                t._buf = orig


class _EchoContext:
    """Per-call python re-execution for break-stitched signatures: every op
    dispatch short-circuits to a shape-only placeholder (zero device compute),
    scalar guards replay their validated values, and float()/.numpy() breaks
    hand the python the TRUE values the captured program just produced — so
    logging/metric side effects between breaks run once per call with correct
    data.  Reads of real tensors (args, params) return their buffers; writes
    are no-ops (the caller commits program outputs afterwards)."""

    mode = "echo"

    def __init__(self, entry, guard_ints, break_vals):
        self.op_tape = entry.op_tape
        self.op_idx = 0
        self.plan = entry.scalar_plan          # ordered kinds
        self.plan_idx = 0
        self._guards = iter(guard_ints)        # pre-validated == actual
        self._breaks = iter(break_vals)

    def on_create(self, t):
        pass

    def on_read(self, t):
        return t._buf          # placeholder -> meta tensor, real -> buffer

    def on_write(self, t, value):
        return True

    def on_grad_read(self, t):
        return t._grad_value()

    def on_grad_write(self, t, value):
        return True

    def _next_kind(self, kind):
        i = self.plan_idx
        if i >= len(self.plan) or self.plan[i] != kind:
            raise EchoMismatch(
                f"scalar-conversion #{i} diverged from the trace "
                f"(expected {self.plan[i] if i < len(self.plan) else 'end'}, "
                f"got {kind})")
        self.plan_idx += 1

    def on_scalar(self, t, kind, caster):
        self._next_kind(kind)
        if kind == "bool":
            return bool(next(self._guards))
        if kind == "int":
            return int(next(self._guards))
        return float(next(self._breaks))

    def on_materialize(self, t):
        self._next_kind("numpy")
        return np.asarray(next(self._breaks))

    def on_op_echo(self, name, inputs):
        """Dispatch interception: validate against the capture's op tape and
        return placeholder outputs without executing anything."""
        i = self.op_idx
        if i >= len(self.op_tape) or self.op_tape[i][0] != name:
            raise EchoMismatch(
                f"op #{i} diverged from the trace (expected "
                f"{self.op_tape[i][0] if i < len(self.op_tape) else 'end'}, "
                f"got '{name}') — tensor ops appear to depend on a "
                "float()/.numpy() break value")
        self.op_idx += 1
        _, single, out_meta = self.op_tape[i]
        outs = [_placeholder(shape, dt, sg) for shape, dt, sg in out_meta]
        return outs[0] if single else tuple(outs)

    def finish(self):
        if self.op_idx != len(self.op_tape) or self.plan_idx != len(self.plan):
            raise EchoMismatch(
                "echo pass ended early: fewer ops/scalar reads than the "
                "trace recorded")


_NP_DTYPE = {torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8,
             torch.int16: np.int16, torch.int32: np.int32,
             torch.int64: np.int64, torch.float16: np.float16,
             torch.float32: np.float32, torch.float64: np.float64}


def _pack(entry, guards, breaks):
    """The guard and break values as one byte vector (one host read a
    call); the layout goes on the entry.  bf16 / fp8 breaks ride as float32
    (exact), as ``Tensor.numpy`` gives them."""
    parts, layout = [], []
    for kind, v in [("guard", g) for g in guards] + [("break", b)
                                                      for b in breaks]:
        if v.dtype not in _NP_DTYPE:
            v = v.float()
        v = v.reshape(-1).contiguous()
        parts.append(v.view(torch.uint8) if v.dtype != torch.bool
                     else v.to(torch.uint8))
        layout.append((kind, _NP_DTYPE[v.dtype], v.numel()))
    entry.pack_layout = layout
    entry.break_shapes = [tuple(b.shape) for b in breaks]
    return torch.cat(parts) if parts else None


def _unpack(entry, packed):
    raw = packed.cpu().numpy().tobytes()
    guards, breaks, off = [], [], 0
    shapes = iter(entry.break_shapes)
    for kind, dt, n in entry.pack_layout:
        nbytes = n * np.dtype(dt).itemsize
        v = np.frombuffer(raw[off:off + nbytes], dtype=dt)
        off += nbytes
        if kind == "guard":
            guards.append(int(v[0]))
        else:
            breaks.append(v.reshape(next(shapes)).copy())
    return tuple(guards), breaks


class _CacheEntry:
    """One variant: the spy's record and its program (``compiled``)."""

    def __init__(self):
        self.compiled = None
        self.guard_kinds = ()
        self.guard_ints = ()     # specialized guard values, int-normalized
        self.scalar_plan = ()    # ordered kinds of ALL scalar events
        self.break_kinds = ()    # float/numpy break kinds, in order
        self.op_tape = ()        # (name, single, out_meta) from the capture
        self.events = ()
        self.pack_layout = ()
        self.break_shapes = ()
        self.out_spec = None
        self.out_mask = ()
        self.out_consts = {}
        self.live = True


class _SigGroup:
    """All compiled variants for one argument signature. Multiple variants
    exist only when the fn has value guards (data-dependent branches): one
    per branch-combination actually taken."""
    __slots__ = ("variants", "eager_only", "last", "guard_warned")

    MAX_VARIANTS = 8

    def __init__(self):
        self.variants: list[_CacheEntry] = []
        self.eager_only = False
        self.last: _CacheEntry | None = None
        self.guard_warned = False


def _guard_ints(events):
    return tuple(int(v) for k, v in events if k in _GUARD_KINDS)


def _sig_key(leaves, treedef):
    parts = [str(treedef)]
    for l in leaves:
        if isinstance(l, Tensor):
            b = l._buf
            parts.append(f"T{tuple(b.shape)}:{b.dtype}:{l.stop_gradient}:"
                         f"{b.device}")
        else:
            try:
                parts.append(f"S{hash(l)}")
            except TypeError:
                parts.append(f"S{repr(l)}")
    return "|".join(parts)


def _arg_tensor(buf, leaf):
    """A Tensor over a static argument buffer, as the call's argument."""
    t = _wrap(buf.detach())
    if not leaf.stop_gradient:
        t.stop_gradient = False
    t.name = leaf.name
    return t


def _device_of(tensors):
    for t in tensors:
        if t._buf.device.type == "cuda":
            return t._buf.device
    return torch.device("cpu")


class StaticFunction:
    # state the fn CREATES on its first run (optimizer accumulators,
    # master weights) is external from the next run on: a spy that made
    # some, or a capture that reads state the spy did not see, re-spies.
    # Bounded so non-idempotent state creation can't re-spy forever.
    MAX_SPY_ATTEMPTS = 3

    def __init__(self, function, input_spec=None, build_strategy=None, backend=None,
                 full_graph=False, donate_state=True):
        self._fn = function
        self._cache: dict[str, _SigGroup] = {}
        self._spy_attempts: dict[str, int] = {}
        self._pool = None
        self._obs_fn = getattr(function, "__name__", "?")
        try:
            functools.update_wrapper(self, function)
        except AttributeError:
            pass

    @property
    def function(self):
        return self._fn

    def __get__(self, instance, owner):
        if instance is None:
            return self
        return functools.partial(self.__call__, instance)

    def __call__(self, *args, **kwargs):
        if _state.trace_ctx is not None:
            return self._fn(*args, **kwargs)  # nested capture: inline
        leaves, treedef = tree_flatten((args, kwargs))
        key = _sig_key(leaves, treedef)
        group = self._cache.get(key)
        if group is None:
            return self._spy(key, leaves, treedef)
        if group.eager_only:
            _obs.JIT_EVENTS.inc(event="eager_call", fn=self._obs_fn)
            return self._fn(*args, **kwargs)
        entry = group.last if group.last is not None else group.variants[0]
        tried: set[int] = set()
        while True:
            tried.add(id(entry))
            try:
                result, actual = self._run(entry, leaves)
            except EchoMismatch as e:
                # the python's op sequence depends on a break value: the
                # compiled form cannot be trusted. Its writes were rolled
                # back — run this call eagerly (correct values, correct side
                # effects; pre-mismatch side effects may repeat once) and
                # pin the signature eager so this cannot loop silently.
                logger.warning(
                    "to_static: %s; falling back to eager and pinning this "
                    "signature eager-only. Hoist the break-dependent branch "
                    "out of the step (or use bool()/int(), which "
                    "re-specialize).", e)
                _obs.JIT_EVENTS.inc(event="echo_mismatch", fn=self._obs_fn)
                group.eager_only = True
                return self._fn(*args, **kwargs)
            except GraphBreak as e:
                logger.info("to_static: graph break (%s); signature stays "
                            "eager", e)
                group.eager_only = True
                return self._fn(*args, **kwargs)
            except MissedCapture as e:
                group.variants = [v for v in group.variants if v is not entry]
                group.last = None
                attempts = self._spy_attempts.get(key, 0) + \
                    getattr(e, "at_capture", False)
                self._spy_attempts[key] = attempts
                if e.permanent or attempts >= self.MAX_SPY_ATTEMPTS:
                    logger.warning("to_static: %s; signature stays eager", e)
                    group.eager_only = True
                    return self._fn(*args, **kwargs)
                if getattr(e, "at_capture", False):
                    # state the spy call created (lazy accumulators) is
                    # external from this call on: re-spy with it in place
                    logger.info("to_static: %s; re-spying (attempt %d)", e,
                                attempts)
                else:
                    logger.warning("to_static: capture miss (%s); "
                                   "re-tracing", e)
                _obs.JIT_EVENTS.inc(event="retrace", fn=self._obs_fn)
                if not group.variants:
                    del self._cache[key]
                return self._spy(key, leaves, treedef)
            if actual is None or actual == entry.guard_ints:
                group.last = entry
                _obs.JIT_EVENTS.inc(event="cache_hit", fn=self._obs_fn)
                return result
            # guard divergence: this step took a different branch. The actual
            # guard values are trustworthy only up to (and including) the
            # first mismatch — after it the program followed the wrong path.
            k = next(i for i, (a, b) in enumerate(zip(actual, entry.guard_ints))
                     if a != b)
            prefix = actual[:k + 1]
            nxt = next((v for v in group.variants
                        if id(v) not in tried
                        and v.guard_ints[:k + 1] == prefix), None)
            if nxt is None:
                logger.info("to_static: guard divergence at #%d; specializing "
                            "a new variant", k)
                _obs.JIT_EVENTS.inc(event="guard_divergence",
                                    fn=self._obs_fn)
                return self._spy(key, leaves, treedef)
            entry = nxt

    # ---- pass 1: eager spy ---------------------------------------------------
    def _spy_run(self, ctx, leaves, treedef):
        """The spy: the fn run eagerly under ``ctx``.  On the card it runs
        on the capture stream, in the device's capture turn, so it also
        warms what the capture needs there (the GEMM libraries' per-stream
        workspaces, the kernels' first-use host steps)."""
        dev = _device_of([l for l in leaves if isinstance(l, Tensor)])
        prev = _state.trace_ctx
        _state.trace_ctx = ctx
        try:
            args, kwargs = tree_unflatten(leaves, treedef)
            if dev.type != "cuda":
                return self._fn(*args, **kwargs)
            from .capture import _capture_lock, _capture_stream
            with _capture_lock(dev):
                main = torch.cuda.current_stream(dev)
                side = _capture_stream(dev)
                side.wait_stream(main)
                try:
                    with torch.cuda.stream(side):
                        return self._fn(*args, **kwargs)
                finally:
                    main.wait_stream(side)
        finally:
            _state.trace_ctx = prev

    def _spy(self, key, leaves, treedef):
        _obs.JIT_EVENTS.inc(event="capture", fn=self._obs_fn)
        group = self._cache.get(key)
        if group is None:
            group = self._cache[key] = _SigGroup()
        if len(group.variants) >= _SigGroup.MAX_VARIANTS:
            logger.warning(
                "to_static: %d guard-specialized variants for one signature; "
                "marking it eager-only", len(group.variants))
            group.eager_only = True
            args, kwargs = tree_unflatten(leaves, treedef)
            return self._fn(*args, **kwargs)
        ctx = _SpyContext()
        result = self._spy_run(ctx, leaves, treedef)
        entry = _CacheEntry()
        entry.treedef = treedef
        entry.guard_kinds = tuple(k for k, _ in ctx.events
                                  if k in _GUARD_KINDS)
        entry.guard_ints = _guard_ints(ctx.events)
        entry.scalar_plan = tuple(k for k, _ in ctx.events)
        entry.break_kinds = tuple(k for k, _ in ctx.events
                                  if k in _BREAK_KINDS)
        entry.events = tuple(ctx.events)
        group.variants.append(entry)
        group.last = entry
        try:
            self._compile(entry, leaves, ctx)
        except MissedCapture as e:
            attempts = self._spy_attempts.get(key, 0) + 1
            self._spy_attempts[key] = attempts
            group.variants.remove(entry)
            group.last = None
            if getattr(e, "permanent", False):
                logger.info("to_static: %s; signature stays eager", e)
                group.eager_only = True
            elif attempts < self.MAX_SPY_ATTEMPTS:
                logger.info("to_static: %s; re-spying on next call "
                            "(attempt %d)", e, attempts)
                if not group.variants:
                    del self._cache[key]
            else:
                logger.warning("to_static: %s after %d spy attempts; "
                               "signature stays eager", e, attempts)
                group.eager_only = True
        else:
            if entry.break_kinds:
                logger.info(
                    "to_static: signature compiled with %d stitched graph "
                    "break(s) (float()/.numpy() reads): the step stays one "
                    "captured program; a per-call echo pass replays the "
                    "python with true break values (plus one device->host "
                    "read and a snapshot of the state it writes).",
                    len(entry.break_kinds))
            if entry.guard_kinds and not group.guard_warned:
                # the guard check is a device->host read per call, and a
                # guarded variant snapshots the state it writes so that a
                # diverged replay can be rolled back. Once per SIGNATURE
                group.guard_warned = True
                logger.warning(
                    "to_static: signature compiled with %d value guard(s) "
                    "(bool()/int() on tensors): every call pays a "
                    "device->host guard read and a snapshot of the state "
                    "the step writes. Hoist the branch out of the step (or "
                    "precompute it) for the guard-free fast path.",
                    len(entry.guard_kinds))
            if ctx.grad_writes:
                # train-step pattern (fn ran backward internally): replayed
                # outputs are detached, so detach the spy outputs too — this
                # frees the spy tape immediately instead of holding the whole
                # step's activations until the caller drops the result
                for leaf in tree_flatten(result)[0]:
                    if isinstance(leaf, Tensor):
                        leaf.detach_()
        return result

    # ---- the program ---------------------------------------------------------
    @staticmethod
    def _no_lazy_state(spy):
        lazy = spy.lazy_state()
        if lazy:
            # the next call would capture against state this spy did not
            # see as external (the bench's "spy attempt 1 (lazy state)")
            raise MissedCapture(
                f"the spy call created {len(lazy)} persistable state "
                f"tensor(s) ({lazy[0].name or id(lazy[0])!r}, ...)")

    def _compile(self, entry, leaves, spy):
        """Build the variant's program from the spy's record (captured at
        its first run on the card)."""
        self._no_lazy_state(spy)
        self._bind_state(entry, leaves, spy)
        entry.compiled = self._program(entry, self._body(entry))

    def _bind_state(self, entry, leaves, spy, stacked=None):
        """The spy's record as the variant's static state: argument
        buffers, the external tensors it reads and writes, gradient
        buffers in and out, and the snapshot a guarded or break-stitched
        variant (or any run on the CPU) takes."""
        entry.tensor_pos = [i for i, l in enumerate(leaves)
                            if isinstance(l, Tensor)]
        entry.template = list(leaves)
        src = stacked if stacked is not None else leaves
        entry.arg_leaves = [leaves[i] for i in entry.tensor_pos]
        entry.arg_bufs = [src[i]._buf.detach().clone()
                          for i in entry.tensor_pos]
        arg_ids = {id(l) for l in leaves if isinstance(l, Tensor)}
        entry.read_list = [t for k, t in spy.reads.items() if k not in arg_ids]
        entry.read_bufs = [t._buf for t in entry.read_list]
        writes = [t for k, t in spy.writes.items() if k not in arg_ids]
        entry.write_ids = {id(t) for t in writes}
        entry.known_ids = {id(t) for t in entry.read_list} | entry.write_ids
        managed = {}
        for t in entry.read_list:
            if _leaf_with_grad(t):
                managed[id(t)] = t
        for d in (spy.grad_reads, spy.grad_writes):
            for k, t in d.items():
                if k not in arg_ids:
                    managed[k] = t
        entry.grad_managed = list(managed.values())
        entry.grad_in = [(t, torch.empty_like(t._buf, requires_grad=False))
                         for t in entry.grad_managed
                         if spy.had_grad.get(id(t))]
        stage = {id(t): s for t, s in entry.grad_in}
        entry.grad_out = [(t, stage.get(id(t)) if id(t) in stage
                           else torch.empty_like(t._buf, requires_grad=False))
                          for t in entry.grad_managed
                          if t._buf.grad is not None]
        entry.grad_out_ids = {id(t) for t, _ in entry.grad_out}
        dev = _device_of(entry.arg_leaves + entry.read_list)
        entry.device = dev
        entry.live = dev.type != "cuda"
        if entry.guard_kinds or entry.break_kinds or entry.live:
            seen, srcs = set(), []
            for b in ([t._buf for t in entry.read_list
                       if t.persistable or _leaf_with_grad(t)]
                      + [t._buf for t in writes] + [s for _, s in entry.grad_in]):
                if id(b) not in seen:
                    seen.add(id(b))
                    srcs.append(b.detach())
            entry.snap_src = srcs
            entry.snap_bak = [torch.empty_like(b) for b in srcs]
        else:
            entry.snap_src = entry.snap_bak = []

    def _program(self, entry, body):
        dev = entry.device
        gens = []
        if dev.type == "cuda":
            if self._pool is None:
                self._pool = graph_pool(dev)
            # the port's generator of this card, if a draw made it: each
            # replay then draws fresh numbers (dropout)
            from ..core.rng import default_generator
            gens += [g for d, g in default_generator()._gens.items()
                     if d.type == "cuda"
                     and (d.index or 0) == (dev.index or 0)]
        return CapturedProgram(body, {}, pool=self._pool,
                               name=f"to_static:{self._obs_fn}", warm=False,
                               device=dev, generators=gens)

    def _snapshot(self, entry):
        if entry.snap_src:
            with torch.no_grad():
                torch._foreach_copy_(entry.snap_bak, entry.snap_src)

    @staticmethod
    def _restore(entry):
        """Roll the state the step wrote back to the snapshot."""
        if entry.snap_src:
            with torch.no_grad():
                torch._foreach_copy_(entry.snap_src, entry.snap_bak)

    def _run_step(self, entry, bufs):
        """One pass of the fn under a capture context over the argument
        buffers ``bufs``: returns (the context, the fn's result)."""
        new_leaves = list(entry.template)
        arg_map = {}
        for j, i in enumerate(entry.tensor_pos):
            t = _arg_tensor(bufs[j], entry.arg_leaves[j])
            new_leaves[i] = t
            arg_map[id(entry.arg_leaves[j])] = t
        ctx = _CaptureContext(entry, arg_map)
        prev = _state.trace_ctx
        _state.trace_ctx = ctx
        try:
            args, kwargs = tree_unflatten(new_leaves, entry.treedef)
            result = self._fn(*args, **kwargs)
            ctx.write_back()
        except BaseException:
            ctx.unbind()
            raise
        finally:
            _state.trace_ctx = prev
        if ctx.plan_idx != len(entry.events):
            raise MissedCapture(
                "replay consumed fewer scalar conversions than the spy "
                "pass recorded")
        if ctx.check_tape is not None and len(ctx.op_tape) != len(ctx.check_tape):
            raise EchoMismatch(
                "the step ended early: fewer ops than the capture recorded")
        return ctx, result

    def _grads_out(self, entry):
        """Copy each step-end gradient into its static output buffer."""
        with torch.no_grad():
            for t, buf in entry.grad_out:
                g = t._buf.grad
                if g is None:
                    raise MissedCapture(
                        f"grad of {t.name or id(t)!r} was set at the end of "
                        "the spy pass but not of the captured step")
                if g is not buf:
                    buf.copy_(g)
        for t in entry.grad_managed:
            if id(t) not in entry.grad_out_ids and t._buf.grad is not None:
                raise MissedCapture(
                    f"grad of {t.name or id(t)!r} is set at the end of the "
                    "captured step but was not at the end of the spy pass")

    def _outputs(self, entry, result):
        out_leaves, out_spec = tree_flatten(result)
        outs, mask, consts = [], [], {}
        for j, l in enumerate(out_leaves):
            if isinstance(l, Tensor):
                outs.append(l._buf.detach())
                mask.append(True)
            else:
                mask.append(False)
                consts[j] = l
        entry.out_spec, entry.out_mask, entry.out_consts = out_spec, mask, consts
        return outs

    def _body(self, entry):
        def body(_buffers):
            self._snapshot(entry)
            ctx, result = self._run_step(entry, entry.arg_bufs)
            outs = self._outputs(entry, result)
            self._grads_out(entry)
            if not entry.op_tape:
                entry.op_tape = tuple(ctx.op_tape)
            packed = _pack(entry, ctx.guard_outs, ctx.break_outs)
            return (*outs, packed)
        return body

    def _check(self, entry, leaves):
        """The state the program was captured against is the state this
        call holds: the same buffers, gradients where the spy found them."""
        for t, b in zip(entry.read_list, entry.read_bufs):
            if t._buf is not b:
                raise MissedCapture(
                    f"tensor {t.name or id(t)!r} was rebound since the "
                    "capture")
        staged = {id(t) for t, _ in entry.grad_in}
        for t in entry.grad_managed:
            if (t._buf.grad is not None) != (id(t) in staged):
                raise MissedCapture(
                    f"grad of {t.name or id(t)!r} is "
                    f"{'set' if t._buf.grad is not None else 'None'} now "
                    "but was not at capture time")

    def _stage(self, entry, leaves):
        """Copy the call's arguments and staged gradients into the
        program's buffers; returns what to put back if the call fails."""
        with torch.no_grad():
            for buf, i in zip(entry.arg_bufs, entry.tensor_pos):
                buf.copy_(leaves[i]._buf)
        pre = [(t, t._buf.grad) for t in entry.grad_managed]
        with torch.no_grad():
            for t, s in entry.grad_in:
                g = t._buf.grad
                if g is not s:
                    s.copy_(g)
                    t._buf.grad = s
                t._grad_buf = None
        return pre

    @staticmethod
    def _unstage(pre):
        for t, g in pre:
            t._buf.grad = g
            t._grad_buf = None

    @staticmethod
    def _commit(entry):
        outs = dict((id(t), b) for t, b in entry.grad_out)
        for t in entry.grad_managed:
            t._buf.grad = outs.get(id(t))
            t._grad_buf = None

    def _launch(self, entry, leaves):
        """Check, stage and launch the program: (its outputs, the staged
        state to put back)."""
        self._check(entry, leaves)
        prog = entry.compiled
        ran_before = prog.ready
        pre = self._stage(entry, leaves)
        try:
            outs = prog.launch()
        except BaseException as e:
            # on the CPU the body ran (and snapshotted first); a capture
            # on the card ran nothing
            if entry.live or ran_before:
                self._restore(entry)
            self._unstage(pre)
            if isinstance(e, MissedCapture) and not ran_before:
                e.at_capture = True
            raise
        if not ran_before:
            from . import _code_level_value
            if _code_level_value() > 0:
                print(f"to_static {self._obs_fn}: captured program, "  # graftlint: disable=no-adhoc-telemetry (code_level dump)
                      f"{len(entry.op_tape)} ops:\n" + "\n".join(
                          f"  {n} -> {[m[0] for m in meta]}"
                          for n, _, meta in entry.op_tape))
        return outs, pre

    def _run(self, entry, leaves):
        """Run the variant's program. Returns (result, actual_guard_values);
        actual is None for guard-free entries. The step's gradients COMMIT
        only when the guards match (or there are none) AND, for
        break-stitched entries on the card, after the echo pass confirms
        the python still follows the captured op sequence — a diverged run
        is rolled back from its snapshot, leaving all framework state as it
        was so the caller can re-run another variant or fall back to
        eager."""
        outs, pre = self._launch(entry, leaves)
        *out_bufs, packed = outs
        actual = None
        if packed is not None:
            guard_vals, break_vals = _unpack(entry, packed)
            if entry.guard_kinds:
                actual = guard_vals
                if actual != entry.guard_ints:
                    self._restore(entry)
                    self._unstage(pre)
                    return None, actual
            if entry.break_kinds and not entry.live:
                try:
                    self._echo(entry, leaves, guard_vals, break_vals)
                except EchoMismatch:
                    self._restore(entry)
                    self._unstage(pre)
                    raise
        self._commit(entry)
        return self._result(entry, out_bufs), actual

    @staticmethod
    def _result(entry, out_bufs):
        bufs = iter(out_bufs)
        out_leaves = [_wrap(next(bufs).clone()) if m else entry.out_consts[j]
                      for j, m in enumerate(entry.out_mask)]
        return tree_unflatten(out_leaves, entry.out_spec)

    def _echo(self, entry, leaves, guard_ints, break_vals):
        """Re-run the python with op dispatches short-circuited so side
        effects between breaks observe the true per-call values.  Any
        divergence or failure raises EchoMismatch BEFORE state commits."""
        ctx = _EchoContext(entry, guard_ints, break_vals)
        prev = _state.trace_ctx
        _state.trace_ctx = ctx
        try:
            args, kwargs = tree_unflatten(leaves, entry.treedef)
            self._fn(*args, **kwargs)
            ctx.finish()
        except EchoMismatch:
            raise
        except Exception as e:
            raise EchoMismatch(
                f"echo pass failed ({type(e).__name__}: {e})") from e
        finally:
            _state.trace_ctx = prev


class ScanStaticFunction(StaticFunction):
    """K steps per dispatched call: the fn is captured once at per-step shapes
    and replayed as ONE program that runs it K times over the leading axis
    of every tensor argument.

    On the card the K steps are unrolled into one CUDA graph: one replay
    issues the K steps' launches from the device, and the graph's pool
    gives each step the blocks the step before it freed (one step's
    activations at a time, not K).  On the CPU the same body runs each
    call.

    Semantics: each tensor argument is stacked on axis 0 ([K, ...]); the fn
    runs K times in order; outputs come back stacked on axis 0. External
    state (params, optimizer moments, the rate) is written in place by each
    step, so K optimizer updates really happen. The FIRST call with a new
    signature runs all K slices eagerly (the spy) and is slow; subsequent
    calls are a single replay.

    Restrictions (checked at capture; violations fall back to an eager
    per-slice loop): no value guards (bool()/int() data-dependent branches)
    and no pre-existing grads read — the step must be self-contained (grads
    produced and consumed/cleared within one call). Grads left set at step
    end hold the LAST slice's values, matching a per-slice eager loop only
    when each step overwrites rather than accumulates across steps.

    ``unroll`` is accepted for the reference's signature; the graph holds
    every step unrolled already.
    """

    def __init__(self, function, input_spec=None, build_strategy=None,
                 backend=None, full_graph=False, donate_state=True, unroll=1):
        super().__init__(function, input_spec, build_strategy, backend,
                         full_graph, donate_state)
        self._unroll = max(1, int(unroll))

    def __call__(self, *args, **kwargs):
        leaves, treedef = tree_flatten((args, kwargs))
        k = self._k_of(leaves)
        if _state.trace_ctx is not None:   # nested capture: inline eagerly
            return self._eager_scan(leaves, treedef, k)
        key = _sig_key(leaves, treedef)
        group = self._cache.get(key)
        if group is None:
            return self._spy_scan(key, leaves, treedef, k)
        if group.eager_only:
            _obs.JIT_EVENTS.inc(event="eager_call", fn=self._obs_fn)
            return self._eager_scan(leaves, treedef, k)
        entry = group.variants[0]
        try:
            result, _ = self._run(entry, leaves)
            _obs.JIT_EVENTS.inc(event="cache_hit", fn=self._obs_fn)
            return result
        except GraphBreak as e:
            logger.info("to_static[scan]: graph break (%s); signature stays "
                        "eager", e)
            group.eager_only = True
            return self._eager_scan(leaves, treedef, k)
        except MissedCapture as e:
            group.variants = [v for v in group.variants if v is not entry]
            group.last = None
            if e.permanent:
                logger.info("to_static[scan]: %s; signature stays eager", e)
                group.eager_only = True
                return self._eager_scan(leaves, treedef, k)
            logger.warning("to_static[scan]: capture miss (%s); re-tracing",
                           e)
            _obs.JIT_EVENTS.inc(event="retrace", fn=self._obs_fn)
            if not group.variants:
                del self._cache[key]
            return self._spy_scan(key, leaves, treedef, k)

    @staticmethod
    def _k_of(leaves):
        ks = {l._buf.shape[0] for l in leaves
              if isinstance(l, Tensor) and l._buf.ndim > 0}
        scalars = [l for l in leaves
                   if isinstance(l, Tensor) and l._buf.ndim == 0]
        if scalars or len(ks) != 1 or 0 in ks:
            raise ValueError(
                "scan_steps: every tensor argument must be stacked on one "
                f"shared non-empty leading (step) dim; got leading dims "
                f"{sorted(ks)}"
                + (" plus scalar tensor args" if scalars else ""))
        return ks.pop()

    @staticmethod
    def _slice(leaves, i):
        # read through the dispatch unwrap so a nested capture (outer spy or
        # capture) records/lifts the argument read instead of baking in the
        # concrete capture-time buffer
        from ..core.dispatch import unwrap
        out = []
        for l in leaves:
            if isinstance(l, Tensor):
                t = _wrap(unwrap(l)[i].detach())
                if not l.stop_gradient:
                    t.stop_gradient = False
                t.name = l.name
                l = t
            out.append(l)
        return out

    def _eager_scan(self, leaves, treedef, k):
        results = []
        for i in range(k):
            args, kwargs = tree_unflatten(self._slice(leaves, i), treedef)
            results.append(self._fn(*args, **kwargs))
        return self._stack_results(results)

    @staticmethod
    def _stack_results(results):
        flat0, rtree = tree_flatten(results[0])
        cols = [tree_flatten(r)[0] for r in results]
        stacked = []
        for j, leaf in enumerate(flat0):
            if isinstance(leaf, Tensor):
                stacked.append(_wrap(torch.stack(
                    [c[j]._buf.detach() for c in cols])))
            elif isinstance(leaf, torch.Tensor):
                # raw tensor leaf: stack to match the captured path, which
                # returns it as [K, ...]
                stacked.append(torch.stack([c[j] for c in cols]))
            else:
                stacked.append(cols[-1][j])
        return tree_unflatten(stacked, rtree)

    def _spy_scan(self, key, leaves, treedef, k):
        # slice 0 runs under the spy (records reads/writes, builds the
        # program); the remaining slices run eagerly so the spying call
        # still performs all K steps with exact per-slice semantics
        self._pending = (k, leaves)
        results = [self._spy(key, self._slice(leaves, 0), treedef)]
        for i in range(1, k):
            args, kwargs = tree_unflatten(self._slice(leaves, i), treedef)
            results.append(self._fn(*args, **kwargs))
        return self._stack_results(results)

    def _compile(self, entry, leaves, spy):
        if entry.events:
            raise MissedCapture(
                "scan_steps does not support value-guarded (bool()/int()) "
                "branches or stitched breaks (float()/.numpy()) inside the "
                "step — hoist host reads out of the scanned region",
                permanent=True)
        self._no_lazy_state(spy)
        k, stacked = self._pending
        self._bind_state(entry, leaves, spy, stacked=stacked)
        if entry.grad_in:
            raise MissedCapture(
                "scan_steps requires a self-contained step (no pre-existing "
                "grads read; clear grads inside the step or use to_static)",
                permanent=True)
        entry.k = k

        def body(_buffers):
            self._snapshot(entry)
            steps = []
            for i in range(entry.k):
                _, result = self._run_step(
                    entry, [b[i] for b in entry.arg_bufs])
                steps.append(self._outputs(entry, result))
            self._grads_out(entry)
            return (*[torch.stack([s[j] for s in steps])
                      for j in range(len(steps[0]))], None)

        entry.compiled = self._program(entry, body)


def scan_steps(function=None, donate_state=True, unroll=1):
    """Capture ``function`` to run K steps per dispatched call as one
    program — call the result with every tensor argument stacked on a
    leading [K, ...] axis; outputs come back stacked the same way and K
    optimizer updates really happen. See :class:`ScanStaticFunction` for
    semantics and restrictions. On the card the K steps replay from one
    CUDA graph, so the host issues one launch for K steps."""
    def wrap(f):
        if isinstance(f, ScanStaticFunction):
            return f
        if isinstance(f, StaticFunction):
            f = f.function
        return ScanStaticFunction(f, donate_state=donate_state,
                                  unroll=unroll)
    if function is not None:
        return wrap(function)
    return wrap


def to_static(function=None, input_spec=None, build_strategy=None, backend=None,
              full_graph=False, **kwargs):
    """paddle.jit.to_static decorator/wrapper."""
    def wrap(f):
        if isinstance(f, StaticFunction):
            return f
        from ..nn.layer.layers import Layer
        if isinstance(f, Layer):
            layer = f
            sf = StaticFunction(layer.forward, input_spec)
            layer.forward = sf
            layer._static_function = sf
            return layer
        return StaticFunction(f, input_spec)
    if function is not None:
        return wrap(function)
    return wrap


def not_to_static(fn):
    fn._not_to_static = True
    return fn
