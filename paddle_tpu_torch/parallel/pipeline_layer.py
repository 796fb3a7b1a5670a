"""PipelineLayer container + PipelineParallel 1F1B schedule: counterpart of
``paddle_tpu/parallel/pipeline_layer.py`` (reference:
fleet/meta_parallel/parallel_layers/pp_layers.py:258 PipelineLayer,
fleet/meta_parallel/pipeline_parallel.py:255 PipelineParallel, 1F1B
forward_backward_pipeline:575, interleave PipelineParallelWithInterleave:1179).

Every schedule is one op list a stage, ``("F" | "B", microbatch, virtual
chunk)``, and one runner (``_Schedule``) runs them.  Stage boundaries are
tape detach points (each chunk's forward starts from a fresh leaf, so its
backward runs alone given the output cotangent).  In one process every
stage runs here, as on the reference's single controller: the boundary
tensors wait in a dict, and an op runs once its input is there.  Under a
launched job whose hybrid topology has a 'pp' degree equal to
``num_stages`` (one process a rank), each rank keeps and runs only its own
chunks: activations go forward and their gradients come back by
point-to-point sends and receives over the 'pp' group, in the schedule's
order; a weight two stages share (a tied embedding and head, a
``SharedLayerDesc``) lives on both, its gradient all-reduced between them
before the optimizer steps, where the reference shares one array, the
global-norm clip sums its norm over the stages, each weight once, and a
loss scaler's skip is agreed over the stages.

Schedules:
  * FThenB (GPipe)   — all M forwards, then all M backwards; M live microbatches
                       (``pipeline_configs["schedule_mode"] = "FThenB"``).
  * 1F1B             — warmup of (num_stages-1) forwards, then steady-state
                       one-forward-one-backward, then drain; at most
                       `num_stages` live microbatches regardless of M.
  * interleave (VPP) — layers split into num_stages × V chunks assigned
                       round-robin (stage s owns chunks s, s+P, s+2P, …);
                       1F1B at chunk granularity.
  * ZB-H1            — 1F1B with each backward split into B now and the
                       weight gradients W deferred (``backward_split``).

The homogeneous stacked-stage SPMD path (one program per stage rank,
``mesh_ppermute`` between ticks) lives in pipeline.py.
"""
from __future__ import annotations

import contextlib
from collections import deque

import numpy as np
import torch

from ..core.tensor import Tensor, _wrap
from ..nn.layer.layers import Layer
from ..nn.layer.container import LayerList
from .. import ops


class LayerDesc:
    """Lazy layer description (reference pp_layers.py LayerDesc)."""

    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    """Weight-shared layer across stages (reference pp_layers.py SharedLayerDesc).
    On a single-controller mesh the same Parameter object is simply reused."""

    def __init__(self, key, layer_func, forward_func=None, shared_weight_attr="weight",
                 *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


def _segment_uniform(n_items, n_parts):
    """Even split of n_items into n_parts contiguous bounds."""
    per = int(np.ceil(n_items / n_parts)) if n_items else 0
    return [(min(i * per, n_items), min((i + 1) * per, n_items))
            for i in range(n_parts)]


class PipelineLayer(Layer):
    """Stage-partitioned layer container.

    seg_method:
      * "uniform"            — split the raw layer list evenly.
      * "layer:ClassName"    — count only layers of that class when balancing
                               (reference SegmentLayers with method
                               "layer:TransformerBlock"); leading non-matching
                               layers (embedding) join the first chunk, trailing
                               ones (final norm / head) join the last.
    """

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0, recompute_ctx=None,
                 num_virtual_pipeline_stages=None):
        super().__init__()
        self._loss_fn = loss_fn
        self._topo = topology
        self._num_stages = num_stages or (topology.get_dim("pp") if topology else 1)
        self._num_virtual = num_virtual_pipeline_stages or 1
        self._recompute_interval = recompute_interval
        self._seg_method = seg_method
        descs = list(layers)
        built = []
        self._shared = {}
        for d in descs:
            if isinstance(d, SharedLayerDesc):
                if d.layer_name in self._shared:
                    src = self._shared[d.layer_name]
                    layer = d.build_layer()
                    # tie the shared weight to the first occurrence
                    setattr(layer, d.shared_weight_attr,
                            getattr(src, d.shared_weight_attr))
                else:
                    layer = d.build_layer()
                    self._shared[d.layer_name] = layer
                built.append((layer, d.forward_func))
            elif isinstance(d, LayerDesc):
                built.append((d.build_layer(), None))
            elif isinstance(d, Layer):
                built.append((d, None))
            elif callable(d):
                built.append((d, None))
            else:
                raise TypeError(f"bad pipeline layer desc {d!r}")
        self.run_functions = built
        reg = LayerList([l for l, _ in built if isinstance(l, Layer)])
        self._layers_list = reg
        self._chunk_bounds = self._segment(self._num_stages * self._num_virtual)
        self._pin_exempt = set()   # ids of params shared across stages (tied)
        self._stage = None         # this rank's stage in a launched job
        self._replicas = set()     # its copies of weights an earlier stage owns

    # ---- partitioning --------------------------------------------------------
    def _segment(self, n_parts):
        n = len(self.run_functions)
        m = self._seg_method
        if isinstance(m, str) and m.startswith("layer:"):
            cls_name = m.split(":", 1)[1]
            idxs = [i for i, (l, _) in enumerate(self.run_functions)
                    if type(l).__name__ == cls_name]
            if not idxs:
                return _segment_uniform(n, n_parts)
            if len(idxs) % n_parts != 0:
                raise ValueError(
                    f"cannot split {len(idxs)} {cls_name} layers into "
                    f"{n_parts} equal pipeline chunks")
            per = len(idxs) // n_parts
            bounds = []
            for p in range(n_parts):
                a = 0 if p == 0 else idxs[p * per]
                b = n if p == n_parts - 1 else idxs[(p + 1) * per]
                bounds.append((a, b))
            return bounds
        return _segment_uniform(n, n_parts)

    @property
    def num_chunks(self):
        return len(self._chunk_bounds)

    def stage_of_chunk(self, c):
        """Round-robin virtual-stage assignment: chunk c lives on stage c % P
        (reference interleave get_model_chunk_id inverse)."""
        return c % self._num_stages

    def get_stage_from_index(self, idx):
        for c, (a, b) in enumerate(self._chunk_bounds):
            if a <= idx < b:
                return self.stage_of_chunk(c)
        return self._num_stages - 1

    # ---- execution -----------------------------------------------------------
    def _run_segment(self, a, b, x):
        from ..distributed.fleet.recompute import recompute
        for i in range(a, b):
            layer, ffn = self.run_functions[i]
            fn = ffn if ffn is not None else layer
            if self._recompute_interval and isinstance(layer, Layer) and \
                    i % self._recompute_interval == 0 and self.training:
                x = recompute(fn, x) if ffn is None else \
                    recompute(lambda v: ffn(layer, v), x)
            else:
                x = fn(x) if ffn is None else ffn(layer, x)
        return x

    def forward_chunk(self, c, x):
        a, b = self._chunk_bounds[c]
        return self._run_segment(a, b, x)

    def forward(self, x):
        if self._stage is not None:
            raise RuntimeError(
                "a PipelineLayer split over launched pipeline ranks holds "
                "only its own stage: run it through PipelineParallel's "
                "train_batch / eval_batch")
        return self._run_segment(0, len(self.run_functions), x)

    def chunk_parameters(self, c):
        a, b = self._chunk_bounds[c]
        out = []
        for layer, _ in self.run_functions[a:b]:
            if isinstance(layer, Layer):
                out.extend(layer.parameters())
        return out

    def pin_stages(self, mesh, axis_name="pp"):
        """Place each chunk on its stage.  One process drives one card, so
        in a single process every chunk stays on it; in a launched job the
        ranks of the 'pp' axis hold their own chunks (``_localize``), the
        reference's placement of stage s on its slice of the axis."""
        return self

    # ---- a launched job: this rank's chunks ----------------------------------
    def _shared_users(self):
        """{id(param): (param, set of stages that read it)} for the weights
        two or more stages use: a parameter of several chunks, or a tied
        one (``_pin_exempt``: owned by its chunk, read by the last)."""
        users = {}
        for c in range(self.num_chunks):
            for p in self.chunk_parameters(c):
                users.setdefault(id(p), (p, set()))[1].add(
                    self.stage_of_chunk(c))
        for pid in self._pin_exempt:
            if pid in users:
                users[pid][1].add(self.stage_of_chunk(self.num_chunks - 1))
        return {k: v for k, v in users.items() if len(v[1]) > 1}

    def _localize(self):
        """In a launched job whose 'pp' degree is ``num_stages``, keep only
        this rank's chunks (and the layers holding weights its chunks
        share); make the groups that all-reduce the shared weights'
        gradients.  Every rank calls it, in one order (it makes groups)."""
        from ..distributed.collective import _dist_up, new_group
        from ..distributed.fleet.topology import get_hybrid_communicate_group
        hcg = get_hybrid_communicate_group()
        if self._stage is not None or self._num_stages == 1 or \
                not _dist_up() or \
                hcg.get_pipe_parallel_world_size() != self._num_stages:
            return
        stage = hcg.get_stage_id()
        shared = self._shared_users()
        keep = set()
        for c in range(self.num_chunks):
            if self.stage_of_chunk(c) == stage:
                a, b = self._chunk_bounds[c]
                keep.update(range(a, b))
        for i, (layer, _) in enumerate(self.run_functions):
            if isinstance(layer, Layer) and any(
                    stage in shared.get(id(p), (None, ()))[1]
                    for p in layer.parameters()):
                keep.add(i)
        names = iter(list(self._layers_list._sub_layers))
        for i, (layer, _) in enumerate(self.run_functions):
            key = next(names) if isinstance(layer, Layer) else None
            if i not in keep:
                self.run_functions[i] = (None, None)
                if key is not None:
                    del self._layers_list._sub_layers[key]
        self._stage = stage
        self._pp_group = hcg.get_pipe_parallel_group()
        # this stage's copies of weights an earlier stage owns
        self._replicas = {k for k, (_, u) in shared.items()
                          if stage in u and stage != min(u)}
        # one group per set of stages sharing a weight, made on every rank
        self._shared_groups = []
        pp_lists = hcg.topology().get_comm_list("pp")
        for sets in sorted({tuple(sorted(u)) for _, u in shared.values()}):
            mine = None
            for ranks in pp_lists:
                sub = [ranks[s] for s in sets]
                g = self._pp_group if len(sets) == self._num_stages else \
                    new_group(sub)
                if hcg.global_rank in sub:
                    mine = g
            if stage in sets:
                self._shared_groups.append(
                    (mine, [p for p, u in shared.values()
                            if tuple(sorted(u)) == sets]))

    def _sync_shared_grads(self):
        """Sum each shared weight's gradient over the stages that use it."""
        import torch.distributed as dist
        for g, params in getattr(self, "_shared_groups", ()):
            for p in params:
                if p._buf.grad is None:
                    p._buf.grad = torch.zeros_like(p._buf)
                dist.all_reduce(p._buf.grad, group=g.pg)


def _is_float_tensor(t):
    return isinstance(t, Tensor) and t._buf.is_floating_point()


def _as_leaf(t):
    """Detach into a fresh grad-requiring leaf — the tape-level stage boundary
    (the reference's p2p recv of the activation)."""
    if not _is_float_tensor(t):
        return t
    leaf = _wrap(t._buf.detach())
    leaf.stop_gradient = False
    return leaf


def _boundary_leaves(struct):
    """Float-Tensor members of a boundary structure, positionally ordered."""
    if isinstance(struct, (tuple, list)):
        return [t for t in struct if _is_float_tensor(t)]
    return [struct] if _is_float_tensor(struct) else []


def _members(struct):
    return list(struct) if isinstance(struct, (tuple, list)) else [struct]


def _struct(items):
    """The boundary structure of received members: the tensor, or a tuple
    of several (the hidden state and a carried MoE aux loss, matching the
    reference's tuple p2p payloads)."""
    items = [_as_leaf(_wrap(b)) for b in items]
    return tuple(items) if len(items) > 1 else items[0]


# ---- how a boundary's tensors travel ------------------------------------------
_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int32, torch.int64, torch.bool, torch.uint8, torch.int8]
_HEADER = 64


class _Local:
    """One process runs every stage: a message waits under its tag until
    its receiver takes it, and an op whose message has not been sent yet
    is not ready."""

    def __init__(self):
        self.box = {}

    def ready(self, tag):
        return tag in self.box

    def send(self, bufs, stage, tag, head=True):
        self.box[tag] = bufs

    def recv(self, stage, tag, like=None):
        return self.box.pop(tag)

    def finish(self, total, last):
        return total


class _P2P:
    """Launched ranks, one stage each: sends are posted and kept until the
    step ends, receives wait.  An activation's message is a header of
    dtypes and shapes, then its tensors; a gradient's receiver knows its
    shapes from the activation it sent, so it comes without one (reading a
    header off the card waits for the card).  Each tensor has its own tag,
    so two streams between one pair of ranks never cross."""

    def __init__(self, group, dev):
        self.group, self.dev, self.sends = group, dev, []

    def ready(self, tag):
        return True

    def _post(self, tensors, stage, tag):
        import torch.distributed as dist
        dst = self.group.ranks[stage]
        for i, t in enumerate(tensors):
            self.sends.append(dist.isend(t.contiguous(), dst,
                                         group=self.group.pg, tag=tag + i))

    def _take(self, like, stage, tag):
        import torch.distributed as dist
        src = self.group.ranks[stage]
        out = []
        for i, (shape, dtype) in enumerate(like):
            t = torch.empty(shape, dtype=dtype, device=self.dev)
            dist.irecv(t, src, group=self.group.pg, tag=tag + i).wait()
            out.append(t)
        return out

    def send(self, bufs, stage, tag, head=True):
        if not head:
            self._post(bufs, stage, tag)
            return
        head = torch.zeros(_HEADER, dtype=torch.int64)
        head[0] = len(bufs)
        for i, b in enumerate(bufs):
            head[1 + 10 * i] = _DTYPES.index(b.dtype)
            head[2 + 10 * i] = b.ndim
            head[3 + 10 * i:3 + 10 * i + b.ndim] = torch.tensor(b.shape)
        self._post([head.to(self.dev)] + list(bufs), stage, tag)

    def recv(self, stage, tag, like=None):
        if like is not None:
            return self._take(like, stage, tag)
        head = self._take([((_HEADER,), torch.int64)], stage, tag)[0].cpu()
        like = []
        for i in range(int(head[0])):
            nd = int(head[2 + 10 * i])
            like.append((tuple(int(d) for d in head[3 + 10 * i:3 + 10 * i
                                                    + nd]),
                         _DTYPES[int(head[1 + 10 * i])]))
        return self._take(like, stage, tag + 1)

    def finish(self, total, last):
        """Wait for this rank's sends; the summed loss, broadcast from the
        last stage to the group."""
        import torch.distributed as dist
        for w in self.sends:
            w.wait()
        self.sends = []
        dist.broadcast(total, self.group.ranks[last], group=self.group.pg)
        return total


class _Schedule:
    """One ``train_batch`` (or ``eval_batch``) run as each stage's op list
    of ``("F" | "B", microbatch, virtual chunk)``: ``fwd`` and ``bwd`` of
    (microbatch, chunk) take the chunk's input from the previous stage and
    hand its output to the next (and the gradients the other way) through
    the transport, ``_Local`` when one process runs every stage (an op
    runs once its message is there) and ``_P2P`` between launched ranks.
    Stage boundaries are tape detach points, so each chunk's backward runs
    alone given its output's cotangent.  With ``param_ids`` (ZB-H1) a
    backward is B only and its deferred W closures queue a stage, drained
    oldest first whenever more than P are waiting and at the end."""

    def __init__(self, pp, micro_x, micro_y, loss_fn, scaler, param_ids):
        pl = pp._layers
        self.pl, self.n = pl, len(micro_x)
        self.micro_x, self.micro_y = micro_x, micro_y
        self.loss_fn = loss_fn or getattr(pl, "_loss_fn", None)
        self.scaler, self.param_ids = scaler, param_ids
        self.P = pp.num_stages
        self.G = getattr(pl, "num_chunks", 1)
        self.acts, self.losses = {}, {}
        self.live, self.max_live = {}, 0
        self.w_queue, self.w_total = {}, 0
        self.dev = next((p._buf.device for p in pl.parameters()),
                        torch.device("cpu"))
        self.launched = pp._rank_stage is not None
        self.stages = [pp._rank_stage] if self.launched else range(self.P)
        self.link = _P2P(pl._pp_group, self.dev) if self.launched \
            else _Local()

    def _stage(self, g):
        return g % self.P

    def _tag(self, m, g, kind):
        return ((m * self.G + g) * 2 + kind) * 16

    def _chunk(self, g, h):
        fc = getattr(self.pl, "forward_chunk", None)
        return fc(g, h) if fc is not None else self.pl(h)

    def ready(self, op, stage):
        kind, m, v = op
        g = v * self.P + stage
        if kind == "F":
            return g == 0 or self.link.ready(self._tag(m, g, 0))
        return g + 1 == self.G or self.link.ready(self._tag(m, g, 1))

    def fwd(self, m, g):
        if g == 0:
            h = self.micro_x[m]
        else:
            h = _struct(self.link.recv(self._stage(g - 1), self._tag(m, g, 0)))
        out = self._chunk(g, h)
        self.acts[(m, g)] = (h, out)
        if g + 1 == self.G:
            lf = self.loss_fn
            self.losses[m] = (lf(out, self.micro_y[m]) if lf is not None
                              else out) / self.n
        else:
            self.link.send([t._buf.detach() for t in _members(out)],
                           self._stage(g + 1), self._tag(m, g + 1, 0))
        live = self.live.setdefault(self._stage(g), set())
        live.add(m)
        self.max_live = max(self.max_live, len(live))

    def bwd(self, m, g):
        from ..autograd.backward import backward as _backward
        stage = self._stage(g)
        leaf_struct, out_struct = self.acts.pop((m, g))
        kw = {"defer_param_ids": self.param_ids} if self.param_ids else {}
        if g + 1 == self.G:
            loss = self.losses[m]
            loss = self.scaler.scale(loss) if self.scaler is not None \
                else loss
            ws = _backward([loss], [None], **kw)
        else:
            outs = _boundary_leaves(out_struct)
            cots = self.link.recv(
                self._stage(g + 1), self._tag(m, g, 1),
                like=[(tuple(o._buf.shape), o._buf.dtype) for o in outs])
            ws = _backward(outs, [_wrap(c) for c in cots], **kw)
        if g > 0:
            gs = []
            for leaf in _boundary_leaves(leaf_struct):
                gr = leaf._buf.grad
                gs.append(torch.zeros_like(leaf._buf) if gr is None else gr)
                leaf.grad = None
            self.link.send(gs, self._stage(g - 1), self._tag(m, g - 1, 1),
                           head=False)
        if g < self.P:                 # the stage's first chunk
            self.live[stage].discard(m)
        if ws:
            q = self.w_queue.setdefault(stage, deque())
            q.append(ws)
            self.w_total += len(ws)
            while len(q) > self.P:     # the ZB-H1 residual window
                for w in q.popleft():
                    w()

    def run(self, ops_of):
        """Run every stage's op list (``ops_of(stage)``) in an order its
        messages allow, then the W closures left; returns the summed
        loss."""
        ops = {s: deque(ops_of(s)) for s in self.stages}
        while any(ops.values()):
            progress = False
            for s, q in ops.items():
                while q and self.ready(q[0], s):
                    kind, m, v = q.popleft()
                    (self.fwd if kind == "F" else self.bwd)(m, v * self.P + s)
                    progress = True
            if not progress:
                raise RuntimeError("pipeline schedule deadlocked")
        for q in self.w_queue.values():
            while q:
                for w in q.popleft():
                    w()
        if self.losses:
            total = torch.stack([self.losses[m]._buf.detach().float()
                                 for m in range(self.n)]).sum().reshape(1)
        else:
            total = torch.zeros(1, device=self.dev)
        return _wrap(self.link.finish(total, self._stage(self.G - 1))
                     .reshape([]))


def _skip_together(scaler, optimizer, group, dev):
    """Unscale now, and skip the step on every stage when any stage's
    gradients are not finite (a stage's scaler sees only its own)."""
    import torch.distributed as dist
    inner = getattr(scaler, "_scaler", scaler)
    if not inner._enable:
        return
    inner.unscale_(optimizer)
    found = torch.tensor([float(inner._found_inf)], device=dev)
    dist.all_reduce(found, group=group.pg)
    inner._found_inf = bool(found.item())


def _one_f_one_b(n, P, stage):
    """This stage's op list of the 1F1B schedule (chunk = stage): warmup of
    (P - stage - 1) forwards, steady one-forward-one-backward, drain."""
    warm = min(P - stage - 1, n)
    sched = [("F", m, 0) for m in range(warm)]
    for k in range(n - warm):
        sched += [("F", warm + k, 0), ("B", k, 0)]
    sched += [("B", k, 0) for k in range(n - warm, n)]
    return sched


class PipelineParallel(Layer):
    """1F1B microbatch schedule (reference pipeline_parallel.py:255,
    forward_backward_pipeline:575 — warmup / steady 1F1B / drain)."""

    schedule_mode = "1F1B"

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        cfg = getattr(strategy, "pipeline_configs", {}) if strategy else {}
        self.accumulate_steps = cfg.get("accumulate_steps", 1)
        self.micro_batch_size = cfg.get("micro_batch_size", None)
        self.max_in_flight = 0       # schedule introspection (tests assert this)
        if type(self) is PipelineParallel and \
                cfg.get("schedule_mode", "1F1B") == "FThenB":
            self.schedule_mode = "FThenB"
        if hasattr(layers, "_localize"):
            layers._localize()

    @property
    def num_stages(self):
        return getattr(self._layers, "_num_stages", 1)

    @property
    def _rank_stage(self):
        return getattr(self._layers, "_stage", None)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def _split_micro(self, data, n):
        if isinstance(data, (tuple, list)):
            parts = [self._split_micro(d, n) for d in data]
            return list(zip(*parts))
        return ops.split(data, n, axis=0)

    def _ops(self, n):
        """``ops_of(stage)``: the schedule's op list of each stage.  Peak
        live microbatches are min(P, M) under 1F1B — its memory bound — and
        M under FThenB (GPipe)."""
        if self.schedule_mode == "FThenB":
            return lambda s: ([("F", m, 0) for m in range(n)]
                              + [("B", m, 0) for m in range(n)])
        return lambda s: _one_f_one_b(n, self.num_stages, s)

    def _train_batch_impl(self, data, optimizer, lr_scheduler, scaler, loss_fn,
                          param_ids=None):
        """Run the schedule over ``accumulate_steps`` microbatches and step.
        In a launched job the shared weights' gradients are summed over
        their stages first, the stages skip a step together when a loss
        scaler finds a non-finite gradient on any of them, and the
        global-norm clip sums over the stages."""
        from ..nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                               ClipGradByValue, norm_over_stages)
        self.train()
        inputs, labels = data
        n = self.accumulate_steps
        sched = _Schedule(self, self._split_micro(inputs, n),
                          self._split_micro(labels, n), loss_fn, scaler,
                          param_ids)
        total = sched.run(self._ops(n))
        self.max_in_flight = sched.max_live
        self.w_deferred_total = sched.w_total
        step = contextlib.nullcontext()
        if sched.launched:
            pl = self._layers
            pl._sync_shared_grads()
            clip = getattr(optimizer, "_grad_clip", None)
            if clip is not None and not isinstance(
                    clip, (ClipGradByGlobalNorm, ClipGradByNorm,
                           ClipGradByValue)):
                raise NotImplementedError(
                    f"{type(clip).__name__} over launched pipeline ranks: "
                    "only the port's own clips know the stages")
            if scaler is not None:
                _skip_together(scaler, optimizer, pl._pp_group, sched.dev)
            step = norm_over_stages(pl._pp_group, pl._replicas, sched.dev)
        with step:
            if scaler is not None:
                scaler.step(optimizer)
            else:
                optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return total

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None,
                    loss_fn=None):
        return self._train_batch_impl(data, optimizer, lr_scheduler, scaler,
                                      loss_fn)

    def eval_batch(self, data, compute_loss=True):
        self.eval()
        inputs, labels = data
        if self._rank_stage is not None:
            from ..autograd import no_grad
            if not compute_loss:
                raise NotImplementedError(
                    "eval_batch over launched pipeline ranks returns the "
                    "loss (compute_loss=True)")
            sched = _Schedule(self, [inputs], [labels], None, None, None)
            V = getattr(self._layers, "_num_virtual", 1)
            with no_grad():
                return sched.run(lambda s: [("F", 0, v) for v in range(V)])
        out = self._layers(inputs)
        lf = getattr(self._layers, "_loss_fn", None)
        if compute_loss and lf is not None:
            return lf(out, labels)
        return out

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        return self._layers.set_state_dict(sd, *a, **k)

    def parameters(self, *a, **k):
        return self._layers.parameters(*a, **k)


class ZeroBubblePipelineParallel(PipelineParallel):
    """Zero-bubble (ZB-H1) schedule (reference: distributed/passes/
    pipeline_scheduler_pass/pipeline_zero_bubble.py).

    The reference splits each backward op into B (grad-input, on the critical
    path — the upstream stage waits for it) and W (grad-weight, off the
    critical path) and sinks W into the drain-phase bubble, eliminating the
    tail bubble of 1F1B. Here the split happens at the tape level:
    ``backward_split`` propagates activation cotangents immediately and
    returns deferred W closures, which this schedule runs after later B's
    and in the drain — so each stage's device queue sees F/B work first and
    fills its idle tail with dW, the ZB-H1 op ordering.  W sweeps the
    retained graph again (``autograd/backward.py``), so it recomputes the
    activation gradients between the loss and the weights: the schedule is
    right, not yet faster than 1F1B.

    Numerics are identical to 1F1B (same grads, different order); the
    deferred-W residuals are drained on a P-microbatch window so peak memory
    stays within the ZB-H1 bound (1F1B activations + one window of dW
    residuals), not O(accumulate_steps)."""

    schedule_mode = "ZB-H1"

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None,
                    loss_fn=None):
        param_ids = {id(p) for p in self._layers.parameters()}
        return self._train_batch_impl(data, optimizer, lr_scheduler, scaler,
                                      loss_fn, param_ids=param_ids)


def interleave_schedule(num_micro, num_stages, num_virtual, rank):
    """Per-rank interleaved-1F1B op list: [('F'|'B', microbatch, chunk), ...]
    (reference PipelineParallelWithInterleave:1179 / Megatron interleaving).

    Forward-op k on rank r touches chunk ((k % (P*V)) // P) of microbatch
    ((k // (P*V)) * P + k % P); warmup covers (P - r - 1) * 2 + (V - 1) * P
    forward ops, then steady state alternates 1F1B, then drain.
    Used for introspection/verification of the global executed order.
    """
    P, V, M = num_stages, num_virtual, num_micro
    if M % P != 0:
        raise ValueError("interleave requires microbatches % stages == 0")
    total = M * V

    def fwd_k(k):
        grp = k // (P * V)
        chunk = (k % (P * V)) // P
        micro = grp * P + k % P
        return ("F", micro, chunk)

    def bwd_k(k):
        grp = k // (P * V)
        chunk = V - 1 - (k % (P * V)) // P
        micro = grp * P + k % P
        return ("B", micro, chunk)

    warmup = min((P - rank - 1) * 2 + (V - 1) * P, total)
    sched = [fwd_k(k) for k in range(warmup)]
    for k in range(warmup, total):
        sched.append(fwd_k(k))
        sched.append(bwd_k(k - warmup))
    sched.extend(bwd_k(k) for k in range(total - warmup, total))
    return sched


class PipelineParallelWithInterleave(PipelineParallel):
    """Interleaved (virtual-stage) 1F1B (reference :1179).

    The container must be built with num_virtual_pipeline_stages=V; chunks are
    assigned round-robin so stage s hosts chunks s, s+P, … Execution runs the
    chunk-granular schedule: warmup forwards per the interleave depth, then
    one-chunk-forward/one-chunk-backward, then drain. Numerics are identical
    to 1F1B; what changes is chunk placement + op order (bubble shrinks by V)."""

    schedule_mode = "interleave"

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__(layers, hcg=hcg, strategy=strategy)
        if getattr(layers, "_num_virtual", 1) < 2:
            raise ValueError(
                "PipelineParallelWithInterleave needs a PipelineLayer built "
                "with num_virtual_pipeline_stages >= 2")

    def _ops(self, n):
        P = self.num_stages
        if n % P != 0:
            raise ValueError(
                f"interleave schedule needs accumulate_steps ({n}) divisible "
                f"by num_stages ({P})")
        return lambda s: interleave_schedule(n, P, self._layers._num_virtual,
                                             s)
