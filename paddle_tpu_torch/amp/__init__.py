"""AMP — autocast + GradScaler: counterpart of ``paddle_tpu/amp/__init__.py``
(reference: python/paddle/amp/auto_cast.py:1029, grad_scaler.py:657; C++
autocast state imperative/amp_auto_cast.h:29).

Autocast is a dispatch-level dtype cast per the O1 white / black lists:
while ``auto_cast`` is active, ``apply_op`` hands an op's float inputs to
:func:`maybe_cast_inputs` before it runs (inside the op's tape, so the
casts are differentiated).  The lists hold the names the port's ops
dispatch under, which are the reference's; a name neither package
dispatches matches nothing in either (``tests/test_torch_amp.py`` holds
every entry to the ops of both packages).

``GradScaler`` keeps its loss scale and its good / bad step counts on the
device, as 0-d tensors (the optimizer's rate is kept so too), and updates
them there: a step captured by ``jit.to_static`` reads and advances them
on every replay.  Its found-inf test is one ``bool()`` of a port Tensor,
so under capture it is a value guard, never a host read of the card.
"""
from __future__ import annotations

import contextlib

import torch

from ..core.device import current_device
from ..core.dispatch import _state, apply_op, in_echo
from ..core import dtype as dtypes
from ..core.tensor import Tensor, _wrap

__all__ = ["WHITE_LIST", "BLACK_LIST", "AmpState", "amp_state", "auto_cast",
           "amp_guard", "decorate", "GradScaler", "maybe_cast_inputs",
           "low_precision_op_list", "clear_low_precision_op_list",
           "active_loss_scale", "is_bfloat16_supported",
           "is_float16_supported"]

# O1 lists (reference: python/paddle/amp/amp_lists.py WHITE_LIST/BLACK_LIST)
WHITE_LIST = {
    "matmul", "mm", "bmm", "mv", "linear", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "einsum",
    "scaled_dot_product_attention", "flash_attention", "addmm", "embedding",
}
BLACK_LIST = {
    "cross_entropy", "softmax_with_cross_entropy", "nll_loss", "log_softmax",
    "exp", "log", "log2", "log10", "log1p", "expm1", "pow", "square", "sqrt",
    "rsqrt", "p_norm", "norm", "cumsum", "cumprod", "logsumexp", "erf", "erfinv",
    "sum", "mean_all", "softmax_grad_blk",
    "layer_norm", "rms_norm", "batch_norm", "group_norm", "instance_norm",
    "mse_loss", "l1_loss", "bce_with_logits", "binary_cross_entropy", "kl_div",
}


class AmpState:
    __slots__ = ("enable", "dtype", "level", "white", "black")

    def __init__(self, enable, dtype, level, white, black):
        self.enable = enable
        self.dtype = dtype
        self.level = level
        self.white = white
        self.black = black


def amp_state():
    return _state.amp_state


# FLAGS_low_precision_op_list audit (reference: common/flags.cc:55 +
# paddle.amp.debugging collect_operator_stats): {op_name: low-precision runs}
_low_precision_ops: dict = {}


def low_precision_op_list():
    """Ops that ran with inputs cast to the low dtype while the
    FLAGS_low_precision_op_list flag was non-zero."""
    return dict(_low_precision_ops)


def clear_low_precision_op_list():
    _low_precision_ops.clear()


def maybe_cast_inputs(op_name, arrays):
    """Called by dispatch: cast float tensors per autocast policy."""
    st = _state.amp_state
    if st is None or not st.enable:
        return arrays
    low = st.dtype
    if st.level == "O2":
        target = None if op_name in st.black else low
    else:  # O1
        if op_name in st.white:
            target = low
        elif op_name in st.black:
            target = torch.float32
        else:
            target = None  # follow inputs
    if target is None:
        return arrays
    if target == low:
        from ..core import flags as _flags
        if _flags.flag("low_precision_op_list"):
            _low_precision_ops[op_name] = _low_precision_ops.get(op_name,
                                                                 0) + 1
    out = []
    for a in arrays:
        if isinstance(a, torch.Tensor) and a.is_floating_point() \
                and a.dtype != target:
            out.append(a.to(target))
        else:
            out.append(a)
    return tuple(out)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None, level="O1",
              dtype="bfloat16", use_promote=True):
    """paddle.amp.auto_cast (reference: amp/auto_cast.py:1029)."""
    white = set(WHITE_LIST)
    black = set(BLACK_LIST)
    if custom_white_list:
        white |= set(custom_white_list)
        black -= set(custom_white_list)
    if custom_black_list:
        black |= set(custom_black_list)
        white -= set(custom_black_list)
    prev = _state.amp_state
    _state.amp_state = AmpState(enable, dtypes.convert_dtype(dtype), level, white, black)
    try:
        yield
    finally:
        _state.amp_state = prev


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16", master_weight=None,
             save_dtype=None):
    """paddle.amp.decorate — O2 casts parameters to the low dtype (master weights
    kept in f32 inside the optimizer accumulators automatically)."""
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        for m in model_list:
            m.to(dtype=dtype)
        for opt in ([optimizers] if optimizers is not None and
                    not isinstance(optimizers, (list, tuple)) else (optimizers or [])):
            opt._multi_precision = True
    if optimizers is None:
        return models
    return models, optimizers


def _device_scalar(value, dtype, name):
    t = _wrap(torch.tensor(value, dtype=dtype, device=current_device()))
    t.persistable = True
    t.name = name
    return t


def _unscale(scale, *grads):
    """(each gradient / scale in float32, cast back to its dtype, ...,
    whether every unscaled float32 value is finite)."""
    inv = 1.0 / scale
    outs, finite = [], []
    for g in grads:
        u = g.to(torch.float32) * inv
        finite.append(torch.isfinite(u).all())
        outs.append(u.to(g.dtype))
    return (*outs, torch.stack(finite).all())


class GradScaler:
    """reference: python/paddle/amp/grad_scaler.py:657 (base AmpScaler:62).

    Dynamic loss scaling; for bf16 the scale may stay 1.0, but the API
    surface (scale/step/update/minimize/unscale_) is preserved.  The scale
    and the step counts are 0-d tensors on the current place (see the
    module docstring); ``state_dict`` reads them back as Python numbers.
    """

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16, incr_ratio=2.0,
                 decr_ratio=0.5, incr_every_n_steps=2000, decr_every_n_nan_or_inf=1,
                 use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale_t = _device_scalar(
            float(init_loss_scaling) if enable else 1.0, torch.float32,
            "loss_scaling")
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_t = _device_scalar(0, torch.int32, "good_steps")
        self._bad_t = _device_scalar(0, torch.int32, "bad_steps")
        self._found_inf = False
        self._unscaled = False

    def scale(self, var):
        global _active_scaler
        _active_scaler = self if self._enable else None
        if not self._enable:
            return var
        return var * self._scale_t

    def unscale_(self, optimizer):
        global _active_scaler
        _active_scaler = None   # grads are unscaled from here on
        if not self._enable:
            return
        params, grads = [], []
        for p in optimizer._parameter_list:
            g = p.grad
            if g is None:
                continue
            if not isinstance(g, (Tensor, torch.Tensor)):
                raise NotImplementedError(
                    f"GradScaler.unscale_: a {type(g).__name__} gradient "
                    "(row-sparse SelectedRows) comes with core/selected_rows.py"
                    " (M13), which the port does not have yet")
            params.append(p)
            grads.append(g)
        found_inf = False
        if grads:
            *outs, finite = apply_op("check_finite_and_unscale", _unscale,
                                     self._scale_t, *grads)
            for p, g, o in zip(params, grads, outs):
                p.grad = o if isinstance(g, Tensor) else o._buf
            # one bool() of a Tensor: a value guard under jit.to_static
            found_inf = not bool(finite)
        self._found_inf = found_inf
        self._unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def update(self):
        global _active_scaler
        _active_scaler = None   # the scaled-backward window is over
        if not (self._enable and self._dynamic):
            self._unscaled = False
            return
        if not in_echo():       # the replayed program already updated them
            with torch.no_grad():
                s = self._scale_t._data
                good, bad = self._good_t._data, self._bad_t._data
                if self._found_inf:
                    bad.add_(1)
                    good.zero_()
                    hit = bad >= self._decr_every
                    s.copy_(torch.where(
                        hit, torch.clamp(s * self._decr_ratio, min=1.0), s))
                    bad.masked_fill_(hit, 0)
                else:
                    good.add_(1)
                    bad.zero_()
                    hit = good >= self._incr_every
                    s.copy_(torch.where(hit, s * self._incr_ratio, s))
                    good.masked_fill_(hit, 0)
        self._found_inf = False
        self._unscaled = False

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return float(self._scale_t)

    def set_init_loss_scaling(self, v):
        self._scale_t._data.fill_(float(v))

    def state_dict(self):
        return {"scale": float(self._scale_t), "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio, "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every,
                "good_steps": int(self._good_t), "bad_steps": int(self._bad_t)}

    def load_state_dict(self, sd):
        self._scale_t._data.fill_(float(sd.get("scale", float(self._scale_t))))
        self._good_t._data.fill_(int(sd.get("good_steps", 0)))
        self._bad_t._data.fill_(int(sd.get("bad_steps", 0)))


def is_bfloat16_supported(device=None):
    return True


def is_float16_supported(device=None):
    return True


# last enabled scaler that scaled a loss this process; lets out-of-band grad
# consumers (e.g. distributed.ps_sparse.PsEmbedding's backward-hook push)
# unscale gradients they receive mid-backward, before unscale_() has run
_active_scaler = None


def active_loss_scale() -> float:
    """Loss-scale factor currently applied to gradients flowing in backward
    (1.0 when no enabled GradScaler has scaled a loss)."""
    if _active_scaler is not None and _active_scaler._enable:
        return float(_active_scaler._scale_t)
    return 1.0
