"""nn.Layer base: counterpart of ``paddle_tpu/nn/layer/layers.py``
(reference: python/paddle/nn/layer/layers.py:354).

Parameters/buffers/sublayers registries with __setattr__ magic, hooks, state_dict,
train/eval, dtype movement: the reference's module with torch in JAX's
place.  Parameters are port Tensors over torch leaves.  ``set_state_dict``
copies into each tensor in place (numpy arrays or Tensors in, cast to the
tensor's dtype); ``to(dtype=, device=)`` rebinds each floating buffer, so
every Parameter stays the same object and a trainable leaf, and an
optimizer built before the cast keeps updating it.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ...core.tensor import Tensor, Parameter, _host_buf
from ...core import dtype as dtypes
from ..initializer import (Initializer, XavierUniform, Constant, ParamAttr, _resolve,
                           Uniform)
import math


class HookRemoveHelper:
    def __init__(self, hooks, hook_id):
        self._hooks, self._id = hooks, hook_id

    def remove(self):
        self._hooks.pop(self._id, None)


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        object.__setattr__(self, "_parameters", OrderedDict())
        object.__setattr__(self, "_buffers", OrderedDict())
        object.__setattr__(self, "_sub_layers", OrderedDict())
        self._non_persistable_buffer_names = set()
        self._forward_pre_hooks = OrderedDict()
        self._forward_post_hooks = OrderedDict()
        self._hook_id = 0
        self.training = True
        self._dtype = dtypes.convert_dtype(dtype)
        self._name_scope = name_scope or self.__class__.__name__.lower()

    # ---- attribute magic -----------------------------------------------------
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        if isinstance(value, Parameter) and params is not None:
            params[name] = value
            self.__dict__.pop(name, None)
            return
        layers = self.__dict__.get("_sub_layers")
        if isinstance(value, Layer) and layers is not None:
            layers[name] = value
            self.__dict__.pop(name, None)
            return
        bufs = self.__dict__.get("_buffers")
        if bufs is not None and name in bufs:
            bufs[name] = value
            return
        if params is not None and name in params:
            if value is None:
                del params[name]
            else:
                params[name] = value
            return
        if layers is not None and name in layers:
            if value is None:
                del layers[name]
            else:
                layers[name] = value
            return
        object.__setattr__(self, name, value)

    def __getattr__(self, name):
        for store in ("_parameters", "_buffers", "_sub_layers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(f"'{type(self).__name__}' object has no attribute '{name}'")

    def __delattr__(self, name):
        for store in ("_parameters", "_buffers", "_sub_layers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                del d[name]
                return
        object.__delattr__(self, name)

    # ---- parameter creation --------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        if attr is False:
            return None
        dtype = dtypes.convert_dtype(dtype) or self._dtype
        if default_initializer is None:
            default_initializer = Constant(0.0) if is_bias else XavierUniform()
        pattr, init = _resolve(attr, default_initializer)
        if pattr is None:
            return None
        data = init(shape, dtype)
        p = Parameter(data, name=pattr.name, trainable=pattr.trainable)
        p.optimize_attr["learning_rate"] = pattr.learning_rate
        p.regularizer = pattr.regularizer
        p.need_clip = pattr.need_clip
        return p

    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter, Parameter):
            parameter = Parameter(parameter._data if isinstance(parameter, Tensor)
                                  else parameter)
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name, sublayer):
        self._sub_layers[str(name)] = sublayer
        return sublayer

    def register_buffer(self, name, tensor, persistable=True):
        if tensor is not None and not isinstance(tensor, Tensor):
            tensor = Tensor(tensor)
        if tensor is not None:
            tensor.persistable = persistable
        self._buffers[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names.add(name)
        return tensor

    # ---- traversal -----------------------------------------------------------
    def named_parameters(self, prefix="", include_sublayers=True):
        seen = set()
        for name, p in self._parameters.items():
            if p is not None and id(p) not in seen:
                seen.add(id(p))
                yield (f"{prefix}.{name}" if prefix else name), p
        if include_sublayers:
            for lname, layer in self._sub_layers.items():
                if layer is None:
                    continue
                sub_prefix = f"{prefix}.{lname}" if prefix else lname
                for n, p in layer.named_parameters(sub_prefix):
                    if id(p) not in seen:
                        seen.add(id(p))
                        yield n, p

    def parameters(self, include_sublayers=True):
        return [p for _, p in self.named_parameters(include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True):
        for name, b in self._buffers.items():
            if b is not None:
                yield (f"{prefix}.{name}" if prefix else name), b
        if include_sublayers:
            for lname, layer in self._sub_layers.items():
                if layer is None:
                    continue
                sub_prefix = f"{prefix}.{lname}" if prefix else lname
                yield from layer.named_buffers(sub_prefix)

    def buffers(self, include_sublayers=True):
        return [b for _, b in self.named_buffers(include_sublayers=include_sublayers)]

    def named_sublayers(self, prefix="", include_self=False):
        if include_self:
            yield prefix, self
        for name, layer in self._sub_layers.items():
            if layer is None:
                continue
            sub_prefix = f"{prefix}.{name}" if prefix else name
            yield from layer.named_sublayers(sub_prefix, include_self=True)

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def children(self):
        return iter(l for l in self._sub_layers.values() if l is not None)

    def named_children(self):
        return iter((n, l) for n, l in self._sub_layers.items() if l is not None)

    def apply(self, fn):
        for layer in self.children():
            layer.apply(fn)
        fn(self)
        return self

    # ---- modes ---------------------------------------------------------------
    def train(self):
        self.training = True
        for l in self.children():
            l.train()
        return self

    def eval(self):
        self.training = False
        for l in self.children():
            l.eval()
        return self

    # ---- hooks ---------------------------------------------------------------
    def register_forward_pre_hook(self, hook):
        self._hook_id += 1
        self._forward_pre_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_pre_hooks, self._hook_id)

    def register_forward_post_hook(self, hook):
        self._hook_id += 1
        self._forward_post_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_post_hooks, self._hook_id)

    # ---- call ----------------------------------------------------------------
    def __call__(self, *inputs, **kwargs):
        for hook in self._forward_pre_hooks.values():
            out = hook(self, inputs)
            if out is not None:
                inputs = out if isinstance(out, tuple) else (out,)
        outputs = self.forward(*inputs, **kwargs)
        for hook in self._forward_post_hooks.values():
            out = hook(self, inputs, outputs)
            if out is not None:
                outputs = out
        return outputs

    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def extra_repr(self):
        return ""

    def __repr__(self):
        extra = self.extra_repr()
        lines = []
        for name, layer in self._sub_layers.items():
            mod_str = repr(layer)
            mod_str = "\n".join("  " + l for l in mod_str.split("\n"))
            lines.append(f"  ({name}): {mod_str.strip()}")
        main = f"{type(self).__name__}({extra}"
        if lines:
            return main + "\n" + "\n".join(lines) + "\n)"
        return main + ")"

    # ---- state dict ----------------------------------------------------------
    def _named_persistable_buffers(self, prefix=""):
        """Like named_buffers but consults each OWNING layer's non-persistable set."""
        for name, b in self._buffers.items():
            if b is not None and name not in self._non_persistable_buffer_names:
                yield (f"{prefix}.{name}" if prefix else name), b
        for lname, layer in self._sub_layers.items():
            if layer is None:
                continue
            sub_prefix = f"{prefix}.{lname}" if prefix else lname
            yield from layer._named_persistable_buffers(sub_prefix)

    def state_dict(self, destination=None, include_sublayers=True, use_hook=True,
                   structured_name_prefix=""):
        dest = destination if destination is not None else OrderedDict()
        for name, p in self.named_parameters(prefix=structured_name_prefix.rstrip(".")):
            dest[name] = p
        for name, b in self._named_persistable_buffers(structured_name_prefix.rstrip(".")):
            dest[name] = b
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        own = self.state_dict()
        missing, unexpected = [], []
        for name, value in state_dict.items():
            if name not in own:
                unexpected.append(name)
                continue
            target = own[name]
            v = value._data if isinstance(value, Tensor) else \
                _host_buf(value, device=target._data.device)
            if tuple(v.shape) != tuple(target._data.shape):
                raise ValueError(
                    f"shape mismatch for {name}: checkpoint {tuple(v.shape)} vs "
                    f"model {tuple(target._data.shape)}")
            with torch.no_grad():
                target._data.copy_(v)
        for name in own:
            if name not in state_dict:
                missing.append(name)
        return missing, unexpected

    load_dict = set_state_dict

    # ---- dtype/device movement ----------------------------------------------
    def to(self, device=None, dtype=None, blocking=None):
        if dtype is not None:
            dt = dtypes.convert_dtype(dtype)
            self._dtype = dt
            for p in self.parameters():
                if dtypes.is_floating_point(p.dtype):
                    p._data = p._data.detach().to(dt)
            for b in self.buffers():
                if b is not None and dtypes.is_floating_point(b.dtype):
                    b._data = b._data.detach().to(dt)
            for l in self.sublayers(include_self=False):
                l._dtype = dt
        if device is not None:
            from ...core.device import _parse
            dev = _parse(device)
            for t in list(self.parameters()) + list(self.buffers()):
                if t is not None:
                    t._data = t._data.detach().to(dev)
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def bfloat16(self):
        return self.to(dtype="bfloat16")

    def float(self):
        return self.to(dtype="float32")

    def half(self):
        return self.to(dtype="float16")

    def clear_gradients(self, set_to_zero=False):
        for p in self.parameters():
            p.clear_grad(set_to_zero)

    def full_name(self):
        return self._name_scope
