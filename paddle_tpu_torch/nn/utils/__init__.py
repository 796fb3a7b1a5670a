"""nn.utils: counterpart of ``paddle_tpu/nn/utils/__init__.py`` (reference:
python/paddle/nn/utils/): the parameters flattened into one vector and
back.  The vector is a new tensor outside the autograd graph, as the
reference's; writing it back keeps each parameter a trainable leaf."""
import torch

from ...core.tensor import Tensor


def parameters_to_vector(parameters, name=None):
    return Tensor(torch.cat([p._data.reshape(-1) for p in parameters]))


def vector_to_parameters(vec, parameters, name=None):
    offset = 0
    for p in parameters:
        n = p.size
        p._data = vec._data[offset:offset + n].reshape(p._data.shape).to(
            p._data.dtype)
        offset += n
