"""Eager Tensor: counterpart of ``paddle_tpu/core/tensor.py``.

Analog of the reference's eager Tensor (paddle/fluid/pybind/eager.cc:1477
binding over phi::DenseTensor, autograd meta fluid/eager/autograd_meta.h:61).
A ``Tensor`` wraps a ``torch.Tensor`` (``_buf``); it is not a torch.Tensor
subclass and defines no ``__torch_function__``.  Torch's autograd is the
tape, so the autograd state lives on the buffer:

- ``stop_gradient`` (default True, like Paddle) is, for a float tensor,
  the inverse of ``_buf.requires_grad`` (a non-float tensor keeps a plain
  flag and never takes part in autograd).  Setting it True on a non-leaf
  detaches ``_buf``: the reference's sweep stops there too.
- ``_grad_node`` is ``_buf.grad_fn`` and ``_out_slot`` its
  ``output_nr``; ``is_leaf`` means no ``grad_fn``.
- ``.grad`` is ``_buf.grad``, wrapped once and cached (``_grad_buf``), so
  ``x.grad is x.grad`` until the gradient is replaced.
- Hooks are torch tensor hooks; a hook registered while the tensor stops
  gradients waits on ``_hooks`` until it requires one.

Values are rebound, never written in place (``_data``'s setter): an
in-place Paddle method computes out of place and rebinds ``_buf``, as the
reference does over immutable jax arrays, so no torch in-place op touches
a leaf that requires grad.  A trainable leaf stays one across a rebind
made without a graph (an optimizer update under ``no_grad``), keeping its
accumulated gradient and hooks.

State access routes through the active program-capture context
(``dispatch._state.trace_ctx``, set by ``jit.to_static``) as the
reference's does: ``_data`` reads and writes, ``.grad`` reads and writes,
creation, and the host conversions (``bool`` / ``int`` are value guards,
``float`` / ``numpy`` stitched breaks).  Without a context each access
costs one ``None`` check.
"""
from __future__ import annotations

import weakref
from typing import Optional

import numpy as np
import torch

from . import dtype as dtypes, sharding
from .device import Place, _parse, current_device


def _differentiable(buf) -> bool:
    return buf.is_floating_point() or buf.is_complex()


def _host_buf(data, dtype=None, device=None) -> torch.Tensor:
    """Host data (numpy, Python scalars and lists) as a torch tensor on
    ``device`` (the current place when None): float64 becomes the default
    dtype, other 64-bit types narrow to 32 bits."""
    if isinstance(data, torch.Tensor):
        buf = data.detach()
    else:
        a = np.asarray(data)
        if dtype is None and a.dtype == np.float64:
            dtype = dtypes.get_default_dtype()
        if a.dtype.kind not in "biufc":        # bfloat16 / float8 (ml_dtypes)
            a = a.astype(np.float32)
        buf = torch.from_numpy(np.array(a))      # a copy, as device_put
    dt = dtypes.convert_dtype(dtype) if dtype is not None else \
        dtypes.NARROW.get(buf.dtype)
    dev = _parse(device) if device is not None else (
        buf.device if isinstance(data, torch.Tensor) else current_device())
    return buf.to(device=dev, dtype=dt)


def _conj(g):
    """Between the reference's complex convention and torch's: JAX's
    cotangents and gradients of complex tensors are the conjugates of
    torch's (``|z|^2`` at ``z`` gives ``2 conj(z)`` there, ``2 z`` here)."""
    return g.conj().resolve_conj() if g is not None and g.is_complex() else g


def _wrap(buf: torch.Tensor) -> "Tensor":
    """A Tensor around an op's output buffer, its autograd state as is."""
    t = Tensor.__new__(Tensor)
    t._buf = buf
    t._sg = True
    t._grad_buf = t._grad_src = None
    t.name = None
    t.persistable = False
    t._retain_grad = False
    t._hooks = None
    t._replay_node = None
    tc = _state.trace_ctx
    if tc is not None:
        tc.on_create(t)
    return t


def _torch_hook(hook):
    """A Paddle hook (Tensor -> Tensor or None) as a torch tensor hook."""
    def run(g):
        out = hook(_wrap(g))
        if out is None:
            return None
        return out._buf if isinstance(out, Tensor) else torch.as_tensor(
            np.asarray(out), dtype=g.dtype, device=g.device)
    return run


class Tensor:
    __slots__ = (
        "_buf", "_sg", "_grad_buf", "_grad_src", "name", "persistable",
        "_retain_grad", "_hooks", "_replay_node", "__weakref__",
    )

    def __init__(self, data, stop_gradient: bool = True, name: Optional[str] = None,
                 persistable: bool = False):
        self._buf = _host_buf(data)
        self._sg = True
        self._grad_buf = self._grad_src = None
        self._replay_node = None
        self.name = name
        self.persistable = persistable
        self._retain_grad = False
        self._hooks: Optional[list] = None
        if not stop_gradient:
            self.stop_gradient = False
        tc = _state.trace_ctx
        if tc is not None:
            tc.on_create(self)

    # -- data access: reads return the buffer; writes rebind it (see the
    # module docstring).  Under program capture (paddle_tpu_torch.jit)
    # both go through the context first.
    @property
    def _data(self):
        tc = _state.trace_ctx
        if tc is not None:
            return tc.on_read(self)
        return self._buf

    @_data.setter
    def _data(self, value):
        tc = _state.trace_ctx
        if tc is not None and tc.on_write(self, value):
            return
        old = self._buf
        new = value if isinstance(value, torch.Tensor) else torch.as_tensor(
            np.asarray(value), device=old.device)
        if sharding.is_sharded(new) and old.grad_fn is None:
            # a leaf rebound to its placement (``p._data =
            # shard_tensor(p, ...)._data``) stays a leaf, as in the reference
            new = new.detach()
        if new.grad_fn is None:
            new = new.detach()           # never share a buffer object
            if old.requires_grad and old.grad_fn is None \
                    and _differentiable(new):
                new.requires_grad_(True)
                g = old.grad
                if g is not None and g.shape == new.shape \
                        and g.dtype == new.dtype and g.device == new.device:
                    new.grad = g
        self._buf = new
        if self._hooks:
            for entry in self._hooks:
                if entry[1] is not None:
                    entry[1].remove()
                    entry[1] = None
            self._attach_hooks()
        if self._retain_grad and new.grad_fn is not None:
            new.retain_grad()

    # ---- autograd state ------------------------------------------------------
    @property
    def stop_gradient(self) -> bool:
        b = self._buf
        return not b.requires_grad if _differentiable(b) else self._sg

    @stop_gradient.setter
    def stop_gradient(self, value):
        b = self._buf
        if not _differentiable(b):
            self._sg = bool(value)
        elif value:
            if b.requires_grad:
                if b.grad_fn is None:
                    b.requires_grad_(False)
                else:
                    self._buf = b.detach()
        elif not b.requires_grad:
            b.requires_grad_(True)
            self._attach_hooks()

    @property
    def _grad_node(self):
        return self._buf.grad_fn

    @property
    def _out_slot(self) -> int:
        return self._buf.output_nr

    @property
    def grad(self):
        tc = _state.trace_ctx
        if tc is not None:
            return tc.on_grad_read(self)
        return self._grad_value()

    def _grad_value(self):
        """``.grad`` as the eager reader sees it (the contexts read it so)."""
        b = self._buf
        if b.grad_fn is not None and not b.retains_grad:
            return None
        g = b.grad
        if g is None:
            self._grad_buf = self._grad_src = None
            return None
        if g.is_complex():
            return _wrap(_conj(g))
        c = self._grad_buf
        src = self._grad_src
        if c is not None and src is not None and src() is g \
                and c._buf is not g \
                and c._buf.shape == g.shape and c._buf.dtype == g.dtype:
            # the reader rebound the gradient it was handed
            # (``p.grad.set_value(...)``): that value is the gradient now
            b.grad = g = c._buf
        if c is None or c._buf is not g:
            c = self._grad_buf = _wrap(g)
        if src is None or src() is not g:
            # a weak reference: a dropped gradient is freed at once
            self._grad_src = weakref.ref(g)
        return c

    @grad.setter
    def grad(self, value):
        tc = _state.trace_ctx
        if tc is not None and tc.on_grad_write(self, value):
            return
        g = None if value is None else (
            value._buf if isinstance(value, Tensor) else torch.as_tensor(
                np.asarray(value), dtype=self._buf.dtype,
                device=self._buf.device))
        if g is not None and g.is_complex():
            # stored in torch's convention, read back in the reference's
            g, value = _conj(g), None
        self._buf.grad = g
        self._grad_buf = value if isinstance(value, Tensor) else None

    # ---- metadata ------------------------------------------------------------
    @property
    def shape(self) -> list:
        return list(self._buf.shape)

    @property
    def ndim(self) -> int:
        return self._buf.ndim

    @property
    def dtype(self):
        return self._buf.dtype

    @property
    def size(self) -> int:
        return self._buf.numel()

    @property
    def place(self) -> Place:
        return Place(self._buf.device)

    @property
    def is_leaf(self) -> bool:
        return self._buf.grad_fn is None

    @property
    def T(self) -> "Tensor":
        return self.transpose(list(range(self.ndim))[::-1])

    def numel(self) -> int:
        return self.size

    def element_size(self) -> int:
        return self._buf.element_size()

    def dim(self) -> int:
        return self.ndim

    def is_dist(self) -> bool:
        return sharding.is_sharded(self._buf)

    # ---- host interop --------------------------------------------------------
    def numpy(self) -> np.ndarray:
        """Host copy.  bfloat16 and float8 come back as float32 with the
        values exact: the card's machine has no ``ml_dtypes``.  Under
        program capture this is a stitched BREAK event (jit/to_static.py):
        the captured program writes the value into a static output, and the
        per-call echo pass hands the caller the true array."""
        tc = _state.trace_ctx
        if tc is not None:
            return tc.on_materialize(self)
        return self._host()

    def _host(self) -> np.ndarray:
        b = sharding.full(self._buf.detach())
        if b.dtype in (dtypes.bfloat16, dtypes.float8_e4m3fn,
                       dtypes.float8_e5m2):
            b = b.float()
        return b.cpu().resolve_conj().resolve_neg().numpy()

    def item(self, *args):
        return self.numpy().item(*args)

    def tolist(self):
        return self.numpy().tolist()

    def __len__(self) -> int:
        if self.ndim == 0:
            raise TypeError("len() of a 0-D tensor")
        return self._buf.shape[0]

    def _convert_scalar(self, kind, caster):
        """Host scalar conversion.  Under program capture this is a GUARD
        point (bool / int: the captured program writes the value into a
        static output and the runtime re-specializes when a call's value
        diverges) or a BREAK (float), see jit/to_static.py."""
        tc = _state.trace_ctx
        if tc is not None:
            return tc.on_scalar(self, kind, caster)
        return caster(self._buf.detach())

    def __bool__(self) -> bool:
        return self._convert_scalar("bool", bool)

    def __int__(self) -> int:
        return self._convert_scalar("int", int)

    def __float__(self) -> float:
        # a float guard would re-specialize on every distinct value, so under
        # capture this is a stitched BREAK (the value rides out of the
        # program; the echo pass returns the true per-call float)
        return self._convert_scalar("float", float)

    def __index__(self) -> int:
        return self._convert_scalar("int", int)

    def __format__(self, spec):
        if self.ndim == 0:
            tc = _state.trace_ctx
            if tc is not None:
                return format(np.asarray(tc.on_materialize(self)).item(), spec)
            return format(self.item(), spec)
        return str(self)

    # ---- autograd surface ----------------------------------------------------
    def backward(self, grad_tensor=None, retain_graph: bool = False):
        from ..autograd.backward import backward as _backward
        _backward([self], [grad_tensor], retain_graph=retain_graph)

    def _attach_hooks(self):
        """Put every waiting hook on the buffer, once it requires grad."""
        b = self._buf
        if b.requires_grad:
            for entry in self._hooks or ():
                if entry[1] is None:
                    entry[1] = b.register_hook(_torch_hook(entry[0]))
            if self._retain_grad and b.grad_fn is not None:
                b.retain_grad()

    def register_hook(self, hook):
        """Register a gradient hook; returns a removable handle (eager hook analog
        of fluid/eager/hooks.h)."""
        if self._hooks is None:
            self._hooks = []
        entry = [hook, None]
        self._hooks.append(entry)
        self._attach_hooks()
        hooks = self._hooks

        class _Handle:
            def remove(self_inner):
                if entry in hooks:
                    hooks.remove(entry)
                if entry[1] is not None:
                    entry[1].remove()
                    entry[1] = None
        return _Handle()

    def retain_grads(self):
        self._retain_grad = True
        self._attach_hooks()

    def clear_grad(self, set_to_zero: bool = False):
        tc = _state.trace_ctx
        if tc is not None and tc.on_grad_write(self, None):
            return
        b = self._buf
        if b.grad_fn is not None and not b.retains_grad:
            return
        if set_to_zero and b.grad is not None:
            b.grad = torch.zeros_like(b.grad)
        else:
            b.grad = None
        self._grad_buf = None

    def clear_gradient(self, set_to_zero: bool = False):
        self.clear_grad(set_to_zero)

    def detach(self) -> "Tensor":
        t = _wrap(self._data.detach())
        t.name = self.name
        return t

    def detach_(self) -> "Tensor":
        self._buf = self._buf.detach()
        self._sg = True
        return self

    # ---- conversion / movement ----------------------------------------------
    def to(self, *args, **kwargs) -> "Tensor":
        device = kwargs.pop("device", None)
        dtype = kwargs.pop("dtype", None)
        kwargs.pop("blocking", None)     # copies are ordered on the stream
        for a in args:
            if isinstance(a, (Place, torch.device)) or (
                    isinstance(a, str) and (a in ("cpu", "gpu", "cuda", "tpu")
                                            or ":" in a)):
                device = a
            else:
                dtype = a
        out = self
        if dtype is not None:
            out = out.astype(dtype)
        if device is not None:
            from .dispatch import apply_op
            dev = _parse(device)
            out = apply_op("to", lambda a: a.to(dev), out)
            out.name = self.name
        return out

    def cpu(self) -> "Tensor":
        return self.to(device="cpu")

    def cuda(self, *a, **k) -> "Tensor":
        return self.to(device="gpu")

    def pin_memory(self) -> "Tensor":
        return self

    def contiguous(self) -> "Tensor":
        return self

    def is_contiguous(self) -> bool:
        return True

    # astype installed by ops package (differentiable cast); cast = alias.

    # ---- misc ----------------------------------------------------------------
    def get_tensor(self):
        return self

    def value(self):
        return self

    def block_until_ready(self) -> "Tensor":
        if self._buf.is_cuda:
            torch.cuda.synchronize(self._buf.device)
        return self

    def _copy_from(self, other: "Tensor"):
        self._data = other._buf if isinstance(other, Tensor) else \
            torch.as_tensor(np.asarray(other), device=self._buf.device)

    def copy_(self, other, blocking: bool = True) -> "Tensor":
        self._copy_from(other)
        return self

    def __repr__(self):
        data = self.numpy()
        return (f"Tensor(shape={self.shape}, dtype={dtypes.dtype_name(self.dtype)}, "
                f"place={self.place}, stop_gradient={self.stop_gradient},\n"
                f"       {np.array2string(data, prefix='       ')})")

    __str__ = __repr__

    # Elementwise __eq__ is installed by ops.logic; keep identity hashing so
    # Tensors can key dicts (optimizer state, reducers) like Paddle's Tensor.
    __hash__ = object.__hash__

    # numpy interop
    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr


# id(Parameter) -> weakref to it: how ``autograd.backward_split`` finds the
# parameters of the ids it is given
_live_params = {}


class Parameter(Tensor):
    """Trainable tensor (python/paddle/base/framework.py Parameter analog)."""

    __slots__ = ("trainable", "optimize_attr", "regularizer", "need_clip", "is_distributed")

    def __init__(self, data, name=None, trainable=True):
        super().__init__(data, stop_gradient=not trainable, name=name, persistable=True)
        self.trainable = trainable
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True
        self.is_distributed = False
        key = id(self)
        _live_params[key] = weakref.ref(
            self, lambda _, k=key: _live_params.pop(k, None))

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()


from .dispatch import _state  # noqa: E402  (dispatch imports this module)
