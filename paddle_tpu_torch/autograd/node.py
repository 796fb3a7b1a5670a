"""Autograd tape node: counterpart of ``paddle_tpu/autograd/node.py``.

Analog of GradNodeBase (fluid/eager/grad_node_info.h:197).  The reference
records its own ``GradNode`` (a ``jax.vjp`` pullback and the input Tensors)
for every dispatched op; in the port torch's autograd records the graph,
and a Tensor's ``_grad_node`` is its buffer's ``grad_fn``: a
``torch.autograd.graph.Node``.  Saved tensors are torch's, checked by
version counter; the port never writes a saved buffer in place (in-place
Paddle methods rebind, see ``core/tensor.py``).
"""
from __future__ import annotations

import torch

GradNode = torch.autograd.graph.Node

