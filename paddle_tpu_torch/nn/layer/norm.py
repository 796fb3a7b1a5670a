"""Normalization layers (reference: python/paddle/nn/layer/norm.py)."""
from __future__ import annotations

import numpy as np

from .layers import Layer
from .. import functional as F
from ..initializer import Constant
from ...core.tensor import Tensor


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None, bias_attr=None,
                 name=None):
        super().__init__()
        self._normalized_shape = ([normalized_shape] if isinstance(normalized_shape, int)
                                  else list(normalized_shape))
        self._epsilon = epsilon
        self.weight = self.create_parameter(self._normalized_shape, attr=weight_attr,
                                            default_initializer=Constant(1.0))
        self.bias = self.create_parameter(self._normalized_shape, attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}, epsilon={self._epsilon}"


class RMSNorm(Layer):
    """rms_norm is a first-class op in the reference (phi/kernels/rms_norm_kernel.h)."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None, name=None):
        super().__init__()
        self._hidden_size = hidden_size if isinstance(hidden_size, int) else hidden_size[-1]
        self._epsilon = epsilon
        self.weight = self.create_parameter([self._hidden_size], attr=weight_attr,
                                            default_initializer=Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self._epsilon)

    def extra_repr(self):
        return f"hidden_size={self._hidden_size}, epsilon={self._epsilon}"


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter([num_features], attr=weight_attr,
                                            default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr, is_bias=True)
        self.register_buffer("_mean", Tensor(np.zeros(num_features, np.float32),
                                             persistable=True))
        self.register_buffer("_variance", Tensor(np.ones(num_features, np.float32),
                                                 persistable=True))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight, self.bias,
                            training=self.training, momentum=self._momentum,
                            epsilon=self._epsilon, data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCL", use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr, bias_attr,
                         "NCHW" if data_format in ("NCL", "NC") else "NHWC",
                         use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCDHW", use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr, bias_attr,
                         "NCHW" if data_format == "NCDHW" else "NHWC", use_global_stats)


class SyncBatchNorm(_BatchNormBase):
    """Batch statistics reduced across devices (reference:
    python/paddle/nn/layer/norm.py SyncBatchNorm): needs the port's
    collectives (M12), so it is refused."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SyncBatchNorm needs cross-device collectives, which the port "
            "does not have yet (M12)")

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        raise NotImplementedError(
            "SyncBatchNorm needs cross-device collectives, which the port "
            "does not have yet (M12)")


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None):
        super().__init__()
        self._num_groups, self._num_channels = num_groups, num_channels
        self._epsilon, self._data_format = epsilon, data_format
        self.weight = self.create_parameter([num_channels], attr=weight_attr,
                                            default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_channels], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight, self.bias,
                            self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None):
        super().__init__()
        self._epsilon, self._data_format = epsilon, data_format
        if weight_attr is False:
            self.weight = None
            self.bias = None
        else:
            self.weight = self.create_parameter([num_features], attr=weight_attr,
                                                default_initializer=Constant(1.0))
            self.bias = self.create_parameter([num_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon, data_format=self._data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


class SpectralNorm(Layer):
    """W / sigma(W) via power iteration (reference: nn/layer/norm.py
    SpectralNorm:1272; phi spectral_norm kernel). forward(weight) -> weight
    normalized by its leading singular value; u/v persist as buffers and the
    power iterations run under stop_gradient (matching the reference kernel,
    which treats u/v as constants in the backward)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 name=None, dtype="float32"):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = epsilon
        self._shape = list(weight_shape)
        h = int(weight_shape[dim])
        w = int(np.prod(weight_shape)) // h
        import torch
        from ...core.device import current_device
        from ...core.dtype import convert_dtype
        from ...core.rng import next_generator
        dev = current_device()
        gen = next_generator(dev)
        dt = convert_dtype(dtype)
        u = torch.randn(h, generator=gen, device=dev)
        v = torch.randn(w, generator=gen, device=dev)
        self.register_buffer("weight_u",
                             Tensor((u / torch.linalg.vector_norm(u)).to(dt)))
        self.register_buffer("weight_v",
                             Tensor((v / torch.linalg.vector_norm(v)).to(dt)))

    def forward(self, x):
        from ...core.dispatch import apply_op, unwrap
        import torch
        dim, iters, eps = self._dim, self._power_iters, self._eps

        def f(w0, u0, v0):
            perm = [dim] + [i for i in range(w0.ndim) if i != dim]
            # iterate in f32 for stability; return in the weight's dtype
            m = w0.permute(perm).reshape(w0.shape[dim], -1).float()
            u, v = u0.float(), v0.float()
            with torch.no_grad():
                for _ in range(iters):
                    v = m.T @ u
                    v = v / (torch.linalg.vector_norm(v) + eps)
                    u = m @ v
                    u = u / (torch.linalg.vector_norm(u) + eps)
            sigma = (u @ (m @ v)).to(w0.dtype)
            return w0 / sigma, u.to(u0.dtype), v.to(v0.dtype)

        out, u2, v2 = apply_op("spectral_norm", f, x, self.weight_u,
                               self.weight_v)
        self.weight_u._data = unwrap(u2)
        self.weight_v._data = unwrap(v2)
        return out
