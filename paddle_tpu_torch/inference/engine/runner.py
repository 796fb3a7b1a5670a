"""Device half of the engine core: weights, paged-KV buffers, and the prefill
/ decode programs, all on ONE device.

:class:`ModelRunner` owns everything that lives on (or dispatches to) the
card: the model's weights, the paged KV cache, the copy-on-write page copy,
and the page gather/scatter primitives the KV tiers are built from.  It
holds NO scheduling state — no queues, no refcounts, no request objects.

Counterpart of ``paddle_tpu/inference/engine/runner.py``, in PyTorch:
- A PREFILL step consumes a CHUNK of prompt tokens for one slot per
  dispatch; the chunk's rows ride the paged-attention kernel's batch dim
  with per-row context lengths, so causal masking falls out of
  ctx = pos + 1.  A DECODE step feeds every in-flight slot its last token
  (token-level continuous batching); ``run_decode`` runs K such steps,
  the token and length feedback kept on the device.  A
  VERIFY step (``run_verify``) scores Kv consecutive positions per slot
  for speculative decoding through the multi-query kernel.
- The layer stack is a Python loop over the layers (the reference's
  ``lax.scan``); each layer writes its new K/V rows into the cache IN PLACE
  (``kp[l, page_idx, within] = k``) before attention reads them.
- Sampling is batched on the device with per-slot parameters (greedy /
  temperature / top-k / top-p / seed), with the reference's filter order.
- KV lives in PAGES: two tensors [L, n_pages, page, KVH, D] in the
  weights' dtype, or with ``kv_cache_dtype="int8"`` four: int8 values and
  float32 per-(token, kv head) scales [L, n_pages, page, KVH], quantized as
  each layer writes its rows; page tables arrive from the scheduler per
  dispatch.

The device decides the attention path: CUDA tensors go through the
hand-written paged-attention kernels (K5 / K6 for prefill and decode, K7 /
K7q for verify), CPU tensors through their plain versions (see
:mod:`paddle_tpu_torch.ops.paged_attention`).

The programs: as the reference jits one program per shape (``_build_decode``
per K, ``_build_prefill``, ``_build_verify`` per Kv), the runner keeps one
:class:`~paddle_tpu_torch.jit.capture.CapturedProgram` per decode K, per
verify Kv and one for prefill, with static int32 buffers shaped by
``max_batch``, ``prefill_chunk`` and the scheduler's block tables.  On the
card the first greedy dispatch captures the program into a CUDA graph and
every later one replays it (one host launch); on the CPU the same body runs
on the same buffers.  A dispatch with a sampled row runs the body eagerly
(its per-row seeded ``torch.Generator`` cannot be captured), counted as
``eager`` in :meth:`ModelRunner.program_stats`.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ...device import resolve_device
from ...jit.capture import CapturedProgram, graph_pool
from ...models.llama_module import rms_norm as _rms
from ...models.llama_module import rope as _rope
from ...ops.paged_attention import (paged_attention,
                                     paged_attention_multiquery, quantize_kv)

__all__ = ["ModelRunner"]

_MAXK = 64        # cap for per-slot dynamic top-k filtering


def _sample(logits, greedy, temp, topp, topk, seeds):
    """Batched sampling, the reference's ``_sample_row`` filter order:
    temperature -> top-k (cap ``_MAXK``) -> top-p over the sorted vocab.
    logits [B, V] float32 on the device; the per-row parameters are host
    numpy arrays [B].  Greedy rows take ``argmax`` (the first index on
    ties); each sampled row draws from its own ``torch.Generator`` seeded
    ``seeds[i]``, so draws are reproducible within the port (they cannot
    match JAX's threefry draws)."""
    amax = _greedy(logits)
    sampled = np.flatnonzero(np.asarray(greedy) == 0)
    if sampled.size == 0:
        return amax
    dev = logits.device
    rows = torch.as_tensor(sampled, device=dev)
    lg = logits[rows]
    t = torch.as_tensor(np.asarray(temp, np.float32)[sampled], device=dev)
    tk = torch.as_tensor(np.asarray(topk, np.int64)[sampled], device=dev)
    tp = torch.as_tensor(np.asarray(topp, np.float32)[sampled], device=dev)
    probs = torch.softmax(lg / torch.where(t > 0, t, 1.0)[:, None], dim=-1)
    maxk = min(_MAXK, lg.shape[-1])
    kvals = torch.topk(probs, maxk, dim=-1).values
    thresh = kvals.gather(1, (tk - 1).clamp(0, maxk - 1)[:, None])
    probs = torch.where((tk > 0)[:, None] & (probs < thresh), 0.0, probs)
    probs = probs / probs.sum(-1, keepdim=True)
    sorted_p, sort_idx = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    cum = torch.cumsum(sorted_p, dim=-1)
    keep = torch.where((tp < 1.0)[:, None], (cum - sorted_p) < tp[:, None],
                       sorted_p >= 0)
    filtered = torch.where(keep, sorted_p, 0.0)
    filtered = filtered / filtered.sum(-1, keepdim=True)
    out = amax.clone()
    for j, row in enumerate(sampled):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seeds[row]))
        choice = torch.multinomial(filtered[j], 1, generator=gen)
        out[row] = sort_idx[j, choice[0]]
    return out


def _greedy(logits):
    """The greedy rows' token: ``argmax`` (the first index on ties), as
    :func:`_sample` takes it."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _to_numpy(t):
    """Owned host numpy copy of a CPU tensor; bfloat16 (which numpy lacks)
    travels as its int16 bit pattern, int8 and float32 as themselves."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().copy()


def _from_host(a, like):
    """Tensor on ``like``'s device and dtype from a host block component
    (numpy array or tensor); int16 numpy blocks of a bfloat16 cache are
    reinterpreted, not converted."""
    if isinstance(a, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if like.dtype == torch.bfloat16 and t.dtype == torch.int16:
            t = t.view(torch.bfloat16)
    else:
        t = a
    return t.to(device=like.device, dtype=like.dtype, non_blocking=True)


class ModelRunner:
    """Weights + paged KV + the prefill/decode forwards on one device."""

    def __init__(self, model, max_batch=4, page_size=16, prefill_chunk=32,
                 n_pages=None, kv_cache_dtype="auto", device="cuda"):
        if kv_cache_dtype not in ("auto", "int8"):
            raise ValueError(f"unknown kv_cache_dtype {kv_cache_dtype!r}")
        self.device = resolve_device(device)
        cfg = model.config
        self.cfg = cfg
        self.max_batch = int(max_batch)
        self.page = int(page_size)
        self.chunk = int(prefill_chunk)
        self.n_pages = int(n_pages)
        self.trash_page = self.n_pages - 1
        L = cfg.num_hidden_layers
        nh, kvh = cfg.num_attention_heads, cfg.num_key_value_heads
        D = cfg.hidden_size // nh
        self.nh, self.kvh, self.D = nh, kvh, D
        self.kv_quant = kv_cache_dtype == "int8"

        def w(p):
            return p.detach().to(self.device)

        lay = model.llama.layers
        self.W = {
            "embed": w(model.llama.embed_tokens.weight),
            "norm": w(model.llama.norm.weight),
            # the head runs in float32, as the reference's logits do
            "head": w(model.head_weight()).float(),
            "wq": [w(l.self_attn.q_proj.weight) for l in lay],
            "wk": [w(l.self_attn.k_proj.weight) for l in lay],
            "wv": [w(l.self_attn.v_proj.weight) for l in lay],
            "wo": [w(l.self_attn.o_proj.weight) for l in lay],
            "ln1": [w(l.input_layernorm.weight) for l in lay],
            "ln2": [w(l.post_attention_layernorm.weight) for l in lay],
            "wg": [w(l.mlp.gate_proj.weight) for l in lay],
            "wu": [w(l.mlp.up_proj.weight) for l in lay],
            "wd": [w(l.mlp.down_proj.weight) for l in lay],
        }
        dtype = torch.int8 if self.kv_quant else self.W["wq"][0].dtype
        kp = torch.zeros((L, self.n_pages, self.page, kvh, D), dtype=dtype,
                         device=self.device)
        self.cache = (kp, torch.zeros_like(kp))
        if self.kv_quant:
            ks = torch.zeros((L, self.n_pages, self.page, kvh),
                             dtype=torch.float32, device=self.device)
            self.cache += (ks, torch.zeros_like(ks))
        # the programs (CapturedProgram), built at their first dispatch:
        # decode by block size K, verify by rows Kv, one prefill; on the
        # card their graphs share one memory pool
        self._pool = graph_pool(self.device)
        self._decode_programs: dict = {}
        self._verify_programs: dict = {}
        self._prefill_program = None

    @property
    def use_kernel(self):
        """Whether attention goes through the CUDA kernel — decided by the
        device alone, never by a switch."""
        return self.device.type == "cuda"

    @property
    def devices(self):
        """The device set this runner's buffers live on, as their tensors
        report it: two runners on one device report the same set however
        their callers spelled it (``"cpu"`` / ``"cpu:0"``, ``"cuda"`` /
        ``"cuda:0"``)."""
        return (self.cache[0].device,)

    # ---------------------------------------------------------------- layers
    def _forward(self, x, pos, page_idx, within, tables, ctx, q_len=None):
        """The layer stack over rows x [N, hidden]: each row sits at
        position pos [N] and writes its K/V into (page_idx, within) before
        attention reads the cache.  Without ``q_len`` row i attends through
        its block-table row tables[i] to ctx[i] tokens; with it the rows are
        B sequences x q_len consecutive positions, tables [B, S] and ctx [B]
        (row 0's context; row j sees ctx + j), through the multi-query
        kernel.  Returns the final-normed hidden states [N, hidden]."""
        W, nh, kvh, D = self.W, self.nh, self.kvh, self.D
        eps = self.cfg.rms_norm_eps
        theta = self.cfg.rope_theta
        for l in range(len(W["wq"])):
            h = _rms(x, W["ln1"][l], eps)
            q = _rope(F.linear(h, W["wq"][l]).view(-1, nh, D), pos, theta)
            k = _rope(F.linear(h, W["wk"][l]).view(-1, kvh, D), pos, theta)
            v = F.linear(h, W["wv"][l]).view(-1, kvh, D)
            kp, vp = self.cache[0][l], self.cache[1][l]
            scales = {}
            if self.kv_quant:
                ks, vs = self.cache[2][l], self.cache[3][l]
                k, k_scale = quantize_kv(k)
                v, v_scale = quantize_kv(v)
                ks[page_idx, within] = k_scale
                vs[page_idx, within] = v_scale
                scales = dict(k_scales=ks, v_scales=vs)
            kp[page_idx, within] = k
            vp[page_idx, within] = v
            if q_len is None:
                att = paged_attention(q, kp, vp, tables, ctx, **scales)
            else:
                att = paged_attention_multiquery(
                    q.view(-1, q_len, nh, D), kp, vp, tables, ctx, **scales)
            x = x + F.linear(att.reshape(-1, nh * D), W["wo"][l])
            h = _rms(x, W["ln2"][l], eps)
            up = F.linear(h, W["wu"][l])
            gate = F.silu(F.linear(h, W["wg"][l]).float()).to(up.dtype)
            x = x + F.linear(gate * up, W["wd"][l])
        return _rms(x, W["norm"], eps)

    def _logits(self, h):
        return F.linear(h.float(), self.W["head"])

    # -------------------------------------------------------------- programs
    # Each body reads only its program's static buffers (and the weights
    # and cache, which stay where they are) and returns (tokens, logits);
    # the dispatch copies out the tokens.  ``sample`` None is the greedy
    # argmax the card captures, else ``sample(logits, step)`` draws the
    # tokens of an eager dispatch with sampled rows.
    def _decode_body(self, k, b, sample=None):
        """K decode steps with the token and length feedback kept inside:
        buffers tokens [B], lens [B] (tokens already cached), tables
        [B, S], active [B] 0/1; returns the tokens [K, B] int32 and the
        logits [K, B, V]."""
        act = b["active"] > 0
        tok, ln, tab = b["tokens"], b["lens"], b["tables"]
        S = tab.shape[1]
        outs, logs = [], []
        for i in range(int(k)):
            x = self.W["embed"][tok.long()]                      # [B, H]
            pos = ln
            slot = (pos // self.page).long().clamp(max=S - 1)
            page_idx = tab.gather(1, slot[:, None])[:, 0]
            # inactive slots write into the trash page, never a live one
            page_idx = torch.where(act, page_idx, self.trash_page).long()
            within = (pos % self.page).long()
            ctx = torch.where(act, pos + 1, 1).to(torch.int32)
            h = self._forward(x, pos, page_idx, within, tab, ctx)
            logits = self._logits(h)
            nxt = _greedy(logits) if sample is None else sample(logits, i)
            tok = torch.where(act, nxt, tok)
            ln = ln + act.to(ln.dtype)
            outs.append(nxt)
            logs.append(logits)
        return torch.stack(outs), torch.stack(logs)

    def _prefill_body(self, b, sample=None):
        """One prompt chunk of one slot: buffers tokens [C] (zero-padded),
        start and n_valid (0-d), table [S]; the chunk's rows ride the paged
        kernel's batch dim with ctx = pos + 1.  Returns the next token
        (0-d int32) sampled from row n_valid - 1, and its logits [1, V]."""
        C = self.chunk
        tab = b["table"]
        x = self.W["embed"][b["tokens"].long()]                  # [C, H]
        offs = torch.arange(C, dtype=torch.int32, device=self.device)
        pos = b["start"] + offs
        valid = offs < b["n_valid"]
        page_idx = tab[(pos // self.page).long().clamp(max=tab.shape[0] - 1)]
        page_idx = torch.where(valid, page_idx, self.trash_page).long()
        within = (pos % self.page).long()
        ctx = torch.where(valid, pos + 1, 1).to(torch.int32)
        tables = tab[None, :].expand(C, -1).contiguous()
        h = self._forward(x, pos, page_idx, within, tables, ctx)
        last = (b["n_valid"] - 1).clamp(min=0).long().view(1)
        logits = self._logits(h.index_select(0, last))
        nxt = _greedy(logits) if sample is None else sample(logits, 0)
        return nxt[0], logits

    def _verify_body(self, kv, b, sample=None):
        """kv consecutive positions a slot in one forward: buffers tokens
        [B, kv], lens [B], tables [B, S], n_rows [B]; returns the tokens
        [B, kv] int32 (see :meth:`run_verify`) and the logits [B * kv,
        V]."""
        B = self.max_batch
        tab, ln, nr = b["tables"], b["lens"], b["n_rows"]
        S = tab.shape[1]
        row_j = torch.arange(kv, dtype=torch.int32,
                             device=self.device).repeat(B)      # [B*kv]
        pos = ln[:, None].expand(B, kv).reshape(-1) + row_j
        valid = row_j < nr[:, None].expand(B, kv).reshape(-1)
        slot = (pos // self.page).long().clamp(max=S - 1).view(B, kv)
        page_idx = tab.gather(1, slot).reshape(-1)
        page_idx = torch.where(valid, page_idx, self.trash_page).long()
        within = (pos % self.page).long()
        # row 0 of an active slot sees lens + 1 tokens (its own write
        # included); the multi-query kernel extends that by j for row j
        cl = torch.where(nr > 0, ln + 1, 1).to(torch.int32)
        x = self.W["embed"][b["tokens"].reshape(-1).long()]
        h = self._forward(x, pos, page_idx, within, tab, cl, q_len=kv)
        logits = self._logits(h)
        toks = _greedy(logits) if sample is None else sample(logits, 0)
        return toks.view(B, kv), logits

    def _program(self, name, body, inputs):
        """A program whose int32 buffers take the shapes of its first
        call's ``inputs``."""
        bufs = {n: torch.zeros(np.shape(v), dtype=torch.int32,
                               device=self.device)
                for n, v in inputs.items()}
        return CapturedProgram(body, bufs, self._pool, name)

    # ------------------------------------------------------------- dispatch
    def has_decode_program(self, k):
        """Whether the decode program of ``k`` steps is built: its graph
        captured on the card, its body run once on the CPU."""
        prog = self._decode_programs.get(k)
        return prog is not None and prog.ready

    def has_verify_program(self, kv):
        prog = self._verify_programs.get(kv)
        return prog is not None and prog.ready

    def program_stats(self):
        """Each program's runs, captures, replays, eager runs, capture
        seconds and launches a replay, by ``decode/K``, ``prefill`` and
        ``verify/Kv``."""
        progs = {f"decode/{k}": p for k, p in self._decode_programs.items()}
        if self._prefill_program is not None:
            progs["prefill"] = self._prefill_program
        progs.update((f"verify/{kv}", p)
                     for kv, p in self._verify_programs.items())
        return {name: p.stats() for name, p in progs.items()}

    @torch.no_grad()
    def run_prefill(self, tokens, start, table, n_valid,
                    greedy, temp, topp, topk, seed):
        """Dispatch one prefill chunk; returns the sampled next token as a
        0-d DEVICE tensor of its own (only the caller decides whether to
        sync on it — a mid-prompt chunk's sample is never read)."""
        inputs = dict(tokens=tokens, start=start, table=table,
                      n_valid=n_valid)
        if self._prefill_program is None:
            self._prefill_program = self._program(
                "prefill", self._prefill_body, inputs)
        prog = self._prefill_program
        if greedy:
            return prog.run(inputs, take=0)

        def sample(logits, _):
            return _sample(logits, [greedy], [temp], [topp], [topk], [seed])

        return prog.run_eager(inputs, functools.partial(
            self._prefill_body, sample=sample), take=0)

    @torch.no_grad()
    def run_decode(self, k, tokens, lens, tables, active,
                   greedy, temp, topp, topk, seeds, fold):
        """Run a K-step decode block; returns host tokens [k, B] int32 (the
        copy to the host syncs, so the caller's wall time is a true dispatch
        sample).  Greedy dispatches run the program; one with a sampled row
        runs its body eagerly (a seeded draw cannot be captured)."""
        inputs = dict(tokens=tokens, lens=lens, tables=tables, active=active)
        prog = self._decode_programs.get(k)
        if prog is None:
            prog = self._decode_programs[k] = self._program(
                f"decode/{k}", functools.partial(self._decode_body, k),
                inputs)
        if np.all(np.asarray(greedy) != 0):
            return prog.run(inputs, host=True, take=0).numpy()
        seeds = np.asarray(seeds, np.int64)
        fold = np.asarray(fold, np.int64)

        def sample(logits, i):
            return _sample(logits, greedy, temp, topp, topk, seeds + i * fold)

        return prog.run_eager(inputs, functools.partial(
            self._decode_body, k, sample=sample), host=True, take=0).numpy()

    @torch.no_grad()
    def run_verify(self, kv, tokens, lens, tables, n_rows,
                   greedy, temp, topp, topk, seeds, fold):
        """ONE forward scoring kv consecutive positions per slot — the
        speculative-decoding verifier; returns host tokens [B, kv] int32.
        tokens [B, kv] (row 0 the pending token, 1.. the drafts, then
        padding); lens [B] tokens already cached; n_rows [B] valid rows (0 =
        inactive slot).  Row j of a slot sits at lens + j; rows past n_rows
        write into the trash page; every row's K/V lands before attention,
        so row j sees drafts 1..j.  Sampling row j yields the target's token
        after draft j, with seed ``seeds + j * fold`` — the key step j of a
        decode block would have drawn — so greedy and fixed-seed requests
        stay token-exact against spec-off decoding.  The host rolls back
        pages past the accepted point; attention masks by context length,
        so stale writes beyond a slot's length are never attended.  As in
        :meth:`run_decode`, a dispatch with a sampled row runs eagerly."""
        inputs = dict(tokens=tokens, lens=lens, tables=tables, n_rows=n_rows)
        prog = self._verify_programs.get(kv)
        if prog is None:
            prog = self._verify_programs[kv] = self._program(
                f"verify/{kv}", functools.partial(self._verify_body, kv),
                inputs)
        if np.all(np.asarray(greedy) != 0):
            return prog.run(inputs, host=True, take=0).numpy()
        B = self.max_batch

        def rep(a):
            return np.repeat(np.asarray(a), kv)

        seeds_rep = (rep(seeds).astype(np.int64)
                     + np.tile(np.arange(kv), B) * rep(fold))

        def sample(logits, _):
            return _sample(logits, rep(greedy), rep(temp), rep(topp),
                           rep(topk), seeds_rep)

        return prog.run_eager(inputs, functools.partial(
            self._verify_body, kv, sample=sample), host=True, take=0).numpy()

    @torch.no_grad()
    def load_cache(self, cache):
        """Copy ``cache`` (one tensor a component, shapes and dtypes as
        this runner's) into the cache IN PLACE: the captured programs hold
        the addresses of these tensors, so they are never rebound."""
        cache = tuple(cache)
        if len(cache) != len(self.cache):
            raise ValueError(f"cache has {len(cache)} components, this "
                             f"runner {len(self.cache)}")
        for i, (a, b) in enumerate(zip(self.cache, cache)):
            if tuple(b.shape) != tuple(a.shape) or b.dtype != a.dtype:
                raise ValueError(
                    f"cache component {i} is {b.dtype} "
                    f"{tuple(b.shape)}, this runner's {a.dtype} "
                    f"{tuple(a.shape)}")
        for a, b in zip(self.cache, cache):
            a.copy_(b)

    # ---------------------------------------------------------- page movement
    @torch.no_grad()
    def copy_page(self, src, dst):
        """Device-side copy of one physical KV page (all layers, K and V,
        int8 scales included) — the copy half of copy-on-write."""
        for a in self.cache:
            a[:, int(dst)] = a[:, int(src)]

    @torch.no_grad()
    def gather_pages(self, page_idx):
        """``page_idx`` pages out of the cache as a dense block (tuple of
        [L, n, page, ...] tensors) — fresh copies, never views."""
        idx = torch.as_tensor(np.asarray(page_idx, np.int64),
                              device=self.device)
        return tuple(a.index_select(1, idx) for a in self.cache)

    @torch.no_grad()
    def scatter_pages(self, page_idx, block):
        """Write a dense page block into ``page_idx`` of this runner's cache,
        in place."""
        idx = torch.as_tensor(np.asarray(page_idx, np.int64),
                              device=self.device)
        for a, b in zip(self.cache, block):
            a.index_copy_(1, idx, _from_host(b, a))

    def kv_bytes_per_page(self):
        """Device bytes one KV page costs across all layers (both K and V,
        including int8 scales) — the unit of the page_pool budget."""
        return sum(a.numel() * a.element_size()
                   for a in self.cache) // self.n_pages

    def pages_to_host(self, page_idx):
        """Gather ``page_idx`` pages and land them in host RAM as a tuple of
        owned numpy arrays (one [L, n, page, ...] array per cache component)
        — the device half of a host-tier spill.  A bfloat16 cache lands as
        int16 bit patterns (numpy has no bfloat16); :meth:`restore_pages`
        and :meth:`scatter_pages` reinterpret them."""
        return tuple(_to_numpy(a.cpu()) for a in self.gather_pages(page_idx))

    def put_block(self, block):
        """Start the transfer of a page block (tensors from another runner's
        ``gather_pages``, or host numpy arrays) onto THIS runner's device;
        the copy is non-blocking where the source allows it."""
        return tuple(_from_host(b, a) for a, b in zip(self.cache, block))

    def restore_pages(self, page_idx, host_blocks):
        """Write host-tier page blocks back into device pages ``page_idx``
        (one single-page block per entry, in order) — the device half of a
        spill restore.  Page i+1's host->device transfer is issued before
        page i's scatter."""
        if not page_idx:
            return
        pending = self.put_block(host_blocks[0])
        for i, p in enumerate(page_idx):
            blk, pending = pending, (
                self.put_block(host_blocks[i + 1])
                if i + 1 < len(page_idx) else None)
            self.scatter_pages([p], blk)
