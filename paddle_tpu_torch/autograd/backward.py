"""Reverse-mode entry points: counterpart of ``paddle_tpu/autograd/backward.py``.

Analog of egr::Backward / RunBackward (fluid/eager/backward.cc:439,:105).
The reference sweeps its own tape; here torch's engine does, and these
functions map Paddle's semantics onto it:

- a root that stops gradients is skipped (torch would raise);
- a non-scalar root's cotangent defaults to ones (torch refuses one);
- ``paddle.grad`` leaves every ``.grad`` alone and returns Tensors,
  differentiable under ``create_graph``; an input that received no gradient
  raises unless ``allow_unused``.

Torch raises on a second sweep over a freed graph only where a node needs
a tensor it saved; the reference raises on any second sweep.

``backward_split`` is the zero-bubble pipeline's split of a backward
into B (the gradients of the graph's other leaves, now) and W (the
parameters' gradients, deferred): B is ``torch.autograd.backward`` with
``inputs`` restricted to the non-parameter leaves and the graph retained,
so the engine skips every weight edge; W sweeps the same graph again with
``inputs`` the parameters, which recomputes the activation gradients
between the roots and each parameter (B's work) once more.

Under a break-stitched echo pass (jit/to_static.py) ``backward`` is a
no-op: the replayed program already produced every grad; the echo's
placeholder tensors carry no tape.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor, _wrap


def _cotangent(t: Tensor, g):
    b = t._buf
    if g is None:
        return torch.ones_like(b)
    if isinstance(g, Tensor):
        return g._buf
    return torch.as_tensor(np.asarray(g), dtype=b.dtype, device=b.device)


def backward(tensors, grad_tensors=None, retain_graph=False,
             create_graph=False, defer_param_ids=None):
    """paddle.autograd.backward analog: accumulate into the ``.grad`` of
    every leaf that requires grad (and of tensors with retain_grads())."""
    from ..core.dispatch import in_echo
    if in_echo():
        return None
    if defer_param_ids is not None:
        return backward_split(tensors, grad_tensors, defer_param_ids)
    tensors = tensors if isinstance(tensors, (list, tuple)) else [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    elif not isinstance(grad_tensors, (list, tuple)):
        grad_tensors = [grad_tensors]
    roots, cots = [], []
    for t, g in zip(tensors, grad_tensors):
        if not t._buf.requires_grad:
            continue
        roots.append(t._buf)
        cots.append(_cotangent(t, g))
    if roots:
        torch.autograd.backward(roots, cots, retain_graph=retain_graph,
                                create_graph=create_graph)


def _roots(tensors, grad_tensors):
    tensors = tensors if isinstance(tensors, (list, tuple)) else [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    elif not isinstance(grad_tensors, (list, tuple)):
        grad_tensors = [grad_tensors]
    roots, cots = [], []
    for t, g in zip(tensors, grad_tensors):
        if t._buf.requires_grad:
            roots.append(t._buf)
            cots.append(_cotangent(t, g))
    return roots, cots


def _graph_leaves(roots):
    """The leaf tensors (``AccumulateGrad`` variables) the roots' graph
    reaches, in discovery order."""
    leaves, seen = [], set()
    stack = [r.grad_fn for r in roots]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        v = getattr(fn, "variable", None)
        if v is not None:
            leaves.append(v)
        stack.extend(f for f, _ in fn.next_functions)
    return leaves


def backward_split(tensors, grad_tensors=None, param_ids=frozenset()):
    """Zero-bubble B-phase backward: accumulate the gradients of every leaf
    the graph reaches except the parameters whose ids are in ``param_ids``
    now (B), and return the deferred W closures that accumulate those
    parameters' gradients (the reference's contract; see the module doc for
    what W recomputes)."""
    from ..core.dispatch import in_echo
    from ..core.tensor import _live_params
    if in_echo():
        return []
    roots, cots = _roots(tensors, grad_tensors)
    if not roots:
        return []
    pbufs = set()
    for i in param_ids:
        ref = _live_params.get(i)
        p = ref() if ref is not None else None
        if p is not None:
            pbufs.add(id(p._buf))
    leaves = _graph_leaves(roots)
    w_in = [v for v in leaves if id(v) in pbufs]
    b_in = [v for v in leaves if id(v) not in pbufs]
    if b_in:
        torch.autograd.backward(roots, cots, inputs=b_in,
                                retain_graph=bool(w_in))
    if not w_in:
        return []

    def w():
        torch.autograd.backward(roots, cots, inputs=w_in)
    return [w]


def grad(outputs, inputs, grad_outputs=None, retain_graph=None, create_graph=False,
         only_inputs=True, allow_unused=False, no_grad_vars=None):
    """paddle.grad analog (python/paddle/autograd/__init__.py) over
    ``torch.autograd.grad``: ``.grad`` of no tensor changes."""
    if not only_inputs:
        raise NotImplementedError(
            "paddle.grad(only_inputs=False) is not supported")
    outputs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if grad_outputs is not None and not isinstance(grad_outputs, (list, tuple)):
        grad_outputs = [grad_outputs]
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    roots, cots = [], []
    for t, g in zip(outputs, grad_outputs):
        if t._buf.requires_grad:
            roots.append(t._buf)
            cots.append(_cotangent(t, g))
    want = [i for i, t in enumerate(inputs) if t._buf.requires_grad]
    res = [None] * len(inputs)
    if roots and want:
        gs = torch.autograd.grad(
            roots, [inputs[i]._buf for i in want], cots,
            retain_graph=bool(retain_graph) or create_graph,
            create_graph=create_graph, allow_unused=True)
        for i, g in zip(want, gs):
            res[i] = g
    if not allow_unused and any(g is None for g in res):
        raise RuntimeError(
            "one of the input tensors received no gradient; pass "
            "allow_unused=True to get None instead")
    return [None if g is None else _wrap(g) for g in res]
