"""The port's ``DisaggEngine`` on the CPU: prefill and decode engines with
KV-page handoff between their pools, the mirror of ``tests/test_disagg.py``.

Correctness bar everywhere: token-identical output.  Against the JAX
package's ``DisaggEngine`` on the same (bridged) weights, greedy, with the
same handoff counts; against the port's colocated :class:`LLMEngine` for
greedy and fixed-seed requests in every pool shape, with every transport
(in process, forced across devices through ``put_block``, and from a
thread-hosted prefill worker over RPC) and under injected handoff faults —
the copied KV pages are bit-identical to what the decode engine would have
computed, so disaggregation may change dispatch structure and latency,
never tokens.

The reference's mesh tests (``split_mesh``, engines on mesh slices) become
device tests: a port engine holds one device, and a pair of engines on
one device however spelled is not cross.  One ``cuda``-marked test holds two
runners' ``gather_pages`` -> ``scatter_pages`` bitwise on the card."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference.serving import DisaggEngine as JaxDisagg
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.inference.engine import ModelRunner
from paddle_tpu_torch.inference.serving import (DisaggEngine, LLMEngine,
                                                RequestStatus, SpecConfig)
from paddle_tpu_torch.models.convert import llama_from_numpy
from paddle_tpu_torch.models.llama_module import LlamaConfig
from paddle_tpu_torch.testing import FAULTS, FailNth, injected
from paddle_tpu_torch.testing.faults import Always

# the reference test's tiny model and engine knobs
_CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=176,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=256)
_KW = dict(max_batch=3, max_len=64, page_size=8, page_pool=48)
_HANDOFF_EVENTS = ("handoff_queued", "handoff_dispatch", "handoff_land",
                   "remote_submit", "handoff_pulled")


@pytest.fixture(scope="module")
def models():
    """(the JAX model, the port's model on the CPU) with the same
    weights."""
    pt.seed(0)
    jm = JaxLlama(JaxConfig(**_CFG))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    return jm, llama_from_numpy(state, LlamaConfig(**_CFG), device="cpu")


@pytest.fixture(scope="module")
def model(models):
    return models[1]


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


def _engine(model, **kw):
    return LLMEngine(model, device="cpu", **{**_KW, **kw})


def _pool(model, **kw):
    return DisaggEngine(model, device="cpu", **{**_KW, **kw})


def _prompts(n, seed=0, lo=4, step=5):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, (lo + step * i,)).astype(np.int32)
            for i in range(n)]


def _serve(eng, prompts, **req_kw):
    rids = [eng.add_request(p, **req_kw) for p in prompts]
    eng.run_until_done()
    return [list(eng.result(r)) for r in rids]


def _colocated(model, prompts, **req_kw):
    return _serve(_engine(model), prompts, **req_kw)


_SAMPLED = dict(max_new_tokens=6, do_sample=True, temperature=0.8,
                top_p=0.9, top_k=20)


def _seeded(eng, prompts, base):
    rids = [eng.add_request(p, seed=base + i, **_SAMPLED)
            for i, p in enumerate(prompts)]
    eng.run_until_done()
    return [list(eng.result(r)) for r in rids]


class TestAgainstTheJaxPool:
    """Greedy tokens and the handoff counters equal the JAX package's
    ``DisaggEngine`` on the same weights."""

    @pytest.mark.parametrize("m,n", [(1, 1), (2, 1)])
    def test_greedy_tokens_and_handoffs_equal(self, models, m, n):
        jm, tm = models
        prompts = _prompts(5, seed=30)
        jeng = JaxDisagg(jm, n_prefill=m, n_decode=n, **_KW)
        teng = _pool(tm, n_prefill=m, n_decode=n, debug_refcount_audit=True)
        want = [[int(t) for t in toks]
                for toks in _serve(jeng, prompts, max_new_tokens=7)]
        assert _serve(teng, prompts, max_new_tokens=7) == want
        keys = ("handoffs", "n_prefill", "n_decode", "failures")
        js, ts = jeng.handoff_stats(), teng.handoff_stats()
        assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
        assert ts["handoffs"] == len(prompts)
        assert teng.audit_refcounts() == []


class TestDisaggParity:
    def test_greedy_token_exact(self, model):
        prompts = _prompts(4)
        ref = _serve(_engine(model, debug_refcount_audit=True), prompts,
                     max_new_tokens=7)
        deng = _pool(model, debug_refcount_audit=True)
        assert _serve(deng, prompts, max_new_tokens=7) == ref
        assert deng.handoff_stats()["handoffs"] == len(prompts)
        assert deng.audit_refcounts() == []

    def test_fixed_seed_sampling_token_exact(self, model):
        prompts = _prompts(3, seed=1)
        ref = _seeded(_engine(model), prompts, 100)
        deng = _pool(model, debug_refcount_audit=True)
        assert _seeded(deng, prompts, 100) == ref

    def test_prefix_cache_on_token_exact(self, model):
        # shared 24-token prefix: the prefill engine's cache serves the
        # later prompts' full pages; tokens must not move
        rng = np.random.RandomState(2)
        base = rng.randint(1, 128, (24,)).astype(np.int32)
        prompts = [np.concatenate([base, rng.randint(1, 128, (k,))
                                   .astype(np.int32)]) for k in (3, 5, 7)]
        ref_eng = _engine(model, prefix_cache=True)
        deng = _pool(model, prefix_cache=True, debug_refcount_audit=True)
        # two waves: wave 2 reuses the pages wave 1 registered
        for wave in range(2):
            ref = _serve(ref_eng, prompts, max_new_tokens=6)
            assert _serve(deng, prompts, max_new_tokens=6) == ref, wave
        assert deng.prefix_cache_stats()["hits"] > 0
        assert deng.audit_refcounts() == []

    def test_spec_decode_on_token_exact(self, model):
        # repetitive prompt so the n-gram proposer actually drafts
        pat = np.tile(np.arange(1, 9, dtype=np.int32), 4)
        prompts = [pat, _prompts(1, seed=3)[0]]
        ref = _colocated(model, prompts, max_new_tokens=8)
        deng = _pool(model, spec_decode=SpecConfig(max_draft=4),
                     debug_refcount_audit=True)
        assert _serve(deng, prompts, max_new_tokens=8) == ref
        assert deng.spec_stats()["verify_dispatches"] >= 1
        assert deng.audit_refcounts() == []

    def test_single_token_requests_skip_handoff(self, model):
        prompts = _prompts(2, seed=4)
        ref = _colocated(model, prompts, max_new_tokens=1)
        deng = _pool(model, debug_refcount_audit=True)
        assert _serve(deng, prompts, max_new_tokens=1) == ref
        assert deng.handoff_stats()["handoffs"] == 0
        assert deng.audit_refcounts() == []


class TestDisaggDevices:
    """The reference's mesh slices, as devices: one device an engine."""

    def test_runner_devices_are_spelled_once(self, model):
        a = ModelRunner(model, n_pages=4, device="cpu")
        b = ModelRunner(model, n_pages=4, device="cpu:0")
        assert a.devices == b.devices

    def test_mixed_spellings_are_not_cross(self, model):
        prompts = _prompts(3, seed=5)
        ref = _colocated(model, prompts, max_new_tokens=6)
        deng = DisaggEngine(
            prefill_engines=[_engine(model), LLMEngine(model, device="cpu:0",
                                                       **_KW)],
            decode_engines=[LLMEngine(model, device="cpu:0", **_KW)],
            debug_refcount_audit=True)
        assert len(deng.prefills) == 2 and len(deng.decodes) == 1
        assert not deng.handoff_stats()["cross_device"]
        assert _serve(deng, prompts, max_new_tokens=6) == ref
        assert deng.audit_refcounts() == []

    def test_forced_cross_pair_moves_blocks_through_put_block(self, model,
                                                              monkeypatch):
        """A pair marked cross (as two cards would be) sends each gathered
        block through the decode runner's ``put_block``; tokens stay."""
        prompts = _prompts(3, seed=6)
        ref = _colocated(model, prompts, max_new_tokens=6)
        deng = _pool(model, debug_refcount_audit=True)
        deng._cross = [[True]]
        puts = []
        put = ModelRunner.put_block

        def counted(runner, block):
            puts.append(runner)
            return put(runner, block)

        monkeypatch.setattr(ModelRunner, "put_block", counted)
        assert deng.handoff_stats()["cross_device"]
        assert _serve(deng, prompts, max_new_tokens=6) == ref
        assert puts == [deng.dec.runner] * len(prompts)
        assert deng.audit_refcounts() == []


class TestDisaggChaos:
    def test_transient_handoff_faults_retried(self, model):
        prompts = _prompts(3, seed=6)
        ref = _colocated(model, prompts, max_new_tokens=6)
        deng = _pool(model, debug_refcount_audit=True)
        rids = [deng.add_request(p, max_new_tokens=6) for p in prompts]
        with injected("serving.kv_handoff", FailNth({1, 3}),
                      transient=True):
            deng.run_until_done()
        assert [list(deng.result(r)) for r in rids] == ref
        stats = deng.handoff_stats()
        assert stats["retries"] >= 2 and stats["failures"] == 0
        assert deng.audit_refcounts() == []

    def test_poisoned_handoff_quarantines_only_that_request(self, model):
        prompts = _prompts(4, seed=7)
        ref = _colocated(model, prompts, max_new_tokens=6)
        deng = _pool(model, debug_refcount_audit=True)
        rids = [deng.add_request(p, max_new_tokens=6) for p in prompts]
        poison = rids[1]
        FAULTS.install("serving.kv_handoff", Always(),
                       match=lambda ctx: poison in ctx.get("rids", ()))
        try:
            deng.run_until_done()
        finally:
            FAULTS.reset()
        assert deng.status(poison) == RequestStatus.FAILED
        assert "InjectedFault" in deng.error(poison)
        for i in (0, 2, 3):
            assert deng.status(rids[i]) == RequestStatus.FINISHED
            assert list(deng.result(rids[i])) == ref[i], i
        stats = deng.handoff_stats()
        assert stats["failures"] == 1
        assert stats["handoffs"] == len(prompts) - 1
        assert deng.audit_refcounts() == []

    def test_seeded_kv_handoff_chaos_converges(self, model):
        """FailProb kv_handoff chaos under the CI seed matrix: every
        transient hit retries losslessly and every request still matches
        the fault-free tokens, whatever PADDLE_TPU_FAULT_SEED says."""
        import os
        from paddle_tpu_torch.testing.faults import FailProb
        fault_seed = int(os.environ.get("PADDLE_TPU_FAULT_SEED", "11"))
        prompts = _prompts(4, seed=23)
        ref = _colocated(model, prompts, max_new_tokens=6)
        deng = _pool(model, n_prefill=2, n_decode=2,
                     debug_refcount_audit=True)
        rids = [deng.add_request(p, max_new_tokens=6) for p in prompts]
        with injected("serving.kv_handoff",
                      FailProb(0.3, seed=fault_seed), transient=True):
            deng.run_until_done()
        assert [list(deng.result(r)) for r in rids] == ref
        assert deng.handoff_stats()["failures"] == 0
        assert deng.audit_refcounts() == []


class TestDisaggBackpressure:
    def test_handoff_queue_stays_bounded(self, model):
        # depth=1 and a decode side kept full: prefill must pause (no new
        # sink appends) instead of growing the queue without bound
        deng = _pool(model, handoff_depth=1, debug_refcount_audit=True)
        for p in _prompts(6, seed=8, lo=4, step=2):
            deng.add_request(p, max_new_tokens=8)
        steps = 0
        while deng.has_work() and steps < 500:
            deng.step()
            assert len(deng._queue) <= deng.handoff_depth
            steps += 1
        assert not deng.has_work()
        assert deng.handoff_stats()["handoffs"] == 6

    def test_cancel_in_handoff_queue_releases_pages(self, model):
        deng = _pool(model, handoff_depth=4, debug_refcount_audit=True)
        for p in _prompts(2, seed=9):
            deng.add_request(p, max_new_tokens=6)
        # step until something sits in the handoff queue, then cancel it
        steps = 0
        while not deng._queue and steps < 200:
            deng.dec.step()
            if len(deng._queue) < deng.handoff_depth:
                deng.pre.step()
            steps += 1
        assert deng._queue
        rid = deng._queue[0].r.rid
        held = len(deng._queue[0].pages)
        free = deng.pre.pool.n_available()
        assert deng.cancel(rid)
        assert deng.status(rid) == RequestStatus.CANCELLED
        assert deng.pre.pool.n_available() == free + held
        deng.run_until_done()
        assert deng.audit_refcounts() == []

    def test_tpot_reported_after_finish(self, model):
        deng = _pool(model)
        rid = deng.add_request(_prompts(1, seed=10)[0], max_new_tokens=6)
        deng.run_until_done()
        assert deng.ttft(rid) is not None
        assert deng.tpot(rid) is not None and deng.tpot(rid) >= 0.0


class TestDisaggMN:
    """M:N pools: any prefill fan-in, any decode fan-out, one shared
    bounded queue — tokens never move."""

    @pytest.mark.parametrize("m,n", [(2, 1), (1, 2), (2, 2)])
    def test_mn_greedy_token_exact(self, model, m, n):
        prompts = _prompts(6, seed=11)
        ref = _colocated(model, prompts, max_new_tokens=7)
        deng = _pool(model, n_prefill=m, n_decode=n,
                     debug_refcount_audit=True)
        assert _serve(deng, prompts, max_new_tokens=7) == ref
        stats = deng.handoff_stats()
        assert stats["handoffs"] == len(prompts)
        assert stats["n_prefill"] == m and stats["n_decode"] == n
        assert deng.audit_refcounts() == []

    def test_mn_fixed_seed_sampling_token_exact(self, model):
        prompts = _prompts(4, seed=12)
        ref = _seeded(_engine(model), prompts, 200)
        deng = _pool(model, n_prefill=2, n_decode=2,
                     debug_refcount_audit=True)
        assert _seeded(deng, prompts, 200) == ref
        assert deng.audit_refcounts() == []

    def test_mn_prefix_cache_token_exact(self, model):
        rng = np.random.RandomState(13)
        base = rng.randint(1, 128, (24,)).astype(np.int32)
        prompts = [np.concatenate([base, rng.randint(1, 128, (k,))
                                   .astype(np.int32)]) for k in (3, 5, 7)]
        ref_eng = _engine(model, prefix_cache=True)
        deng = _pool(model, n_prefill=2, n_decode=1, prefix_cache=True,
                     debug_refcount_audit=True)
        for wave in range(2):
            ref = _serve(ref_eng, prompts, max_new_tokens=6)
            assert _serve(deng, prompts, max_new_tokens=6) == ref, wave
        assert deng.audit_refcounts() == []

    def test_least_loaded_decode_placement_spreads(self, model):
        deng = _pool(model, n_prefill=1, n_decode=2,
                     debug_refcount_audit=True)
        _serve(deng, _prompts(6, seed=14), max_new_tokens=6)
        per_engine = [len(de.sched.finished) for de in deng.decodes]
        assert sum(per_engine) == 6
        assert all(c > 0 for c in per_engine), per_engine

    def test_mn_cancel_and_queue_paths(self, model):
        deng = _pool(model, n_prefill=2, n_decode=1, handoff_depth=4,
                     debug_refcount_audit=True)
        rids = [deng.add_request(p, max_new_tokens=6)
                for p in _prompts(4, seed=15)]
        steps = 0
        while not deng._queued and steps < 300:
            deng.step()
            steps += 1
        if deng._queued:
            rid = next(iter(deng._queued))
            assert deng.cancel(rid)
            assert deng.status(rid) == RequestStatus.CANCELLED
        deng.run_until_done()
        assert deng.audit_refcounts() == []
        for rid in rids:
            assert deng.status(rid).terminal


class TestAsyncHandoff:
    """The pipelined transfer changes latency structure only, and its
    overlap shows in ``handoff_stats()``."""

    def test_async_vs_sync_token_exact(self, model):
        prompts = _prompts(5, seed=17)
        ref = _colocated(model, prompts, max_new_tokens=7)
        sync_eng = _pool(model, async_handoff=False,
                         debug_refcount_audit=True)
        async_eng = _pool(model, async_handoff=True,
                          debug_refcount_audit=True)
        assert _serve(sync_eng, prompts, max_new_tokens=7) == ref
        assert _serve(async_eng, prompts, max_new_tokens=7) == ref
        s_sync, s_async = sync_eng.handoff_stats(), async_eng.handoff_stats()
        assert not s_sync["async"] and s_async["async"]
        assert s_sync["transfer_overlap_s"] == 0.0
        assert s_async["transfer_overlap_s"] > 0.0
        assert s_async["handoffs"] == s_sync["handoffs"] == len(prompts)
        for s in (s_sync, s_async):
            assert s["queue_wait_s"] >= 0.0 and s["transfer_s"] > 0.0

    def test_async_registry_series_mirror_stats(self, model):
        from paddle_tpu_torch import observability as obs
        obs.enable()
        try:
            deng = _pool(model)
            _serve(deng, _prompts(3, seed=18), max_new_tokens=6)
            label = deng._pm.label
            snap = obs.REGISTRY.snapshot(
                prefix="serving_handoff", labels={"pool": label})

            def series(name, **extra):
                return next(
                    s for s in snap[name]["series"]
                    if all(s["labels"].get(k) == v
                           for k, v in extra.items()))

            wait = series("serving_handoff_wait_seconds", path="local")
            xfer = series("serving_handoff_transfer_seconds", path="local")
            assert wait["count"] == xfer["count"] == 3
            assert series("serving_handoff_queue_depth")["value"] == 0
        finally:
            obs.disable()


def _worker(engine, store_mod, worker_mod, group):
    """A started thread-hosted prefill-role worker over a fresh store
    master (``store_mod`` / ``worker_mod``: either package's modules)."""
    master = store_mod.TCPStore(is_master=True, timeout=20)
    w = worker_mod.WorkerServer(
        "pf0", engine, store_mod.TCPStore(port=master.port, timeout=20),
        group=group, ttl=60.0, role="prefill")
    w.start(heartbeat=False)
    return w


class TestCrossHostHandoff:
    """Prefill in another worker process (thread-hosted here): the pool
    pulls serialized page blocks over the worker RPC plane and lands them
    through the same queue -> stage -> scatter path."""

    @pytest.fixture()
    def worker(self, model):
        from paddle_tpu_torch.distributed import store
        from paddle_tpu_torch.inference.frontend import worker as wmod
        w = _worker(_engine(model), store, wmod, "disagg-xh")
        yield w
        w.close(drain=False)

    def _tier(self, w):
        from paddle_tpu_torch.inference.frontend.disagg import (
            RemotePrefillTier)
        return RemotePrefillTier(w.rpc.host, w.rpc.port, name=w.name)

    def _remote_pool(self, model, tier):
        return _pool(model, n_prefill=0, remote_prefill=[tier],
                     debug_refcount_audit=True)

    def test_cross_host_greedy_token_exact(self, model, worker):
        prompts = _prompts(4, seed=19)
        ref = _colocated(model, prompts, max_new_tokens=7)
        tier = self._tier(worker)
        try:
            deng = self._remote_pool(model, tier)
            assert _serve(deng, prompts, max_new_tokens=7) == ref
            stats = deng.handoff_stats()
            assert stats["handoffs"] == len(prompts)
            assert stats["cross_device"]
            # decode pool here, prefill pool over RPC
            assert deng.audit_refcounts() == []
        finally:
            tier.close()

    def test_cross_host_fixed_seed_token_exact(self, model, worker):
        prompts = _prompts(3, seed=20)
        ref = _seeded(_engine(model), prompts, 300)
        tier = self._tier(worker)
        try:
            deng = self._remote_pool(model, tier)
            assert _seeded(deng, prompts, 300) == ref
            assert deng.audit_refcounts() == []
        finally:
            tier.close()

    def test_cross_host_transient_fault_lossless(self, model, worker):
        prompts = _prompts(3, seed=21)
        ref = _colocated(model, prompts, max_new_tokens=6)
        tier = self._tier(worker)
        try:
            deng = self._remote_pool(model, tier)
            rids = [deng.add_request(p, max_new_tokens=6) for p in prompts]
            with injected("serving.kv_handoff", FailNth({1, 3}),
                          transient=True):
                deng.run_until_done()
            assert [list(deng.result(r)) for r in rids] == ref
            stats = deng.handoff_stats()
            assert stats["retries"] >= 2 and stats["failures"] == 0
            assert deng.audit_refcounts() == []
        finally:
            tier.close()

    def test_cross_host_poison_quarantines_one(self, model, worker):
        prompts = _prompts(4, seed=22)
        ref = _colocated(model, prompts, max_new_tokens=6)
        tier = self._tier(worker)
        try:
            deng = self._remote_pool(model, tier)
            rids = [deng.add_request(p, max_new_tokens=6) for p in prompts]
            poison = rids[1]
            FAULTS.install(
                "serving.kv_handoff", Always(),
                match=lambda ctx: (poison in ctx.get("rids", ())
                                   and ctx.get("path") == "cross_host"))
            try:
                deng.run_until_done()
            finally:
                FAULTS.reset()
            assert deng.status(poison) == RequestStatus.FAILED
            assert "InjectedFault" in deng.error(poison)
            for i in (0, 2, 3):
                assert deng.status(rids[i]) == RequestStatus.FINISHED
                assert list(deng.result(rids[i])) == ref[i], i
            stats = deng.handoff_stats()
            assert stats["failures"] == 1
            assert stats["handoffs"] == len(prompts) - 1
            # the worker dropped the poisoned block and released its pages
            assert deng.audit_refcounts() == []
        finally:
            tier.close()

    def test_fleet_routes_prefill_role_to_tier(self, model, worker):
        from paddle_tpu_torch.distributed.store import TCPStore
        from paddle_tpu_torch.inference.frontend.fleet import FleetReplicaSet
        store_port = worker.membership.store.port
        fleet = FleetReplicaSet(TCPStore(port=store_port, timeout=20),
                                group="disagg-xh", ttl=60.0)
        try:
            fleet.sync()
            # a prefill-role member becomes a tier, never a serving replica
            assert list(fleet.prefill_tiers) == ["pf0"]
            assert fleet.replicas == []
            tier = fleet.prefill_tiers["pf0"]
            prompts = _prompts(2, seed=24)
            ref = _colocated(model, prompts, max_new_tokens=5)
            deng = self._remote_pool(model, tier)
            assert _serve(deng, prompts, max_new_tokens=5) == ref
            assert deng.audit_refcounts() == []
        finally:
            fleet.close()


def _traced_pool_run(pool, flight, prompts):
    """Two traced greedy requests through ``pool`` (one local prefill
    engine and one remote tier: the first lands locally, the second on
    the tier); returns their tokens and each one's handoff events' names
    in recorded order."""
    flight.reset()
    flight.enable()
    try:
        rids = []
        for i, p in enumerate(prompts):
            with flight.use_context(flight.mint(f"disagg-trace-{i}")):
                rids.append(pool.add_request(p, max_new_tokens=5))
        pool.run_until_done()
        events = [[e["phase"] for e in flight.events_for(
            f"disagg-trace-{i}") if e["phase"] in _HANDOFF_EVENTS]
                  for i in range(len(prompts))]
    finally:
        flight.disable()
        flight.reset()
    assert pool.audit_refcounts() == []
    return [[int(t) for t in pool.result(r)] for r in rids], events


def test_traced_requests_record_the_jax_pools_handoff_events(models):
    """A traced local handoff and a traced cross-host one record the JAX
    pool's handoff events, in its order, with the same tokens."""
    from paddle_tpu.distributed import store as jstore
    from paddle_tpu.inference.frontend import worker as jworker
    from paddle_tpu.inference.frontend.disagg import (
        RemotePrefillTier as JaxTier)
    from paddle_tpu.inference.serving import LLMEngine as JaxEngine
    from paddle_tpu.observability import flight as jflight
    from paddle_tpu_torch.distributed import store as tstore
    from paddle_tpu_torch.inference.frontend import worker as tworker
    from paddle_tpu_torch.inference.frontend.disagg import RemotePrefillTier
    from paddle_tpu_torch.observability import flight as tflight
    jm, tm = models
    prompts = _prompts(2, seed=25)
    out = {}
    for side, (mod_store, mod_worker, tier_cls, flight, engine, pool) in {
            "jax": (jstore, jworker, JaxTier, jflight,
                    lambda: JaxEngine(jm, **_KW),
                    lambda tier: JaxDisagg(jm, remote_prefill=[tier],
                                           **_KW)),
            "port": (tstore, tworker, RemotePrefillTier, tflight,
                     lambda: _engine(tm),
                     lambda tier: _pool(tm, remote_prefill=[tier]))}.items():
        w = _worker(engine(), mod_store, mod_worker, f"trace-{side}")
        tier = tier_cls(w.rpc.host, w.rpc.port, name=w.name)
        try:
            out[side] = _traced_pool_run(pool(tier), flight, prompts)
        finally:
            tier.close()
            w.close(drain=False)
    (jtoks, jevents), (ttoks, tevents) = out["jax"], out["port"]
    assert ttoks == jtoks
    assert tevents == jevents
    assert tevents[0] == ["handoff_queued", "handoff_dispatch",
                          "handoff_land"]
    assert tevents[1][:2] == ["remote_submit", "handoff_pulled"]


class TestRpcOutOfBand:
    """Protocol-5 out-of-band framing: numpy page blocks ride the wire as
    raw buffers, the in-band pickle stays structural."""

    def test_page_block_bytes_stay_out_of_band(self):
        import pickle
        from paddle_tpu_torch.inference.frontend.rpc import _encode_frame
        block = tuple(np.random.RandomState(0)
                      .randn(2, 64, 16, 4, 32).astype(np.float32)
                      for _ in range(2))
        payload = {"req": None, "block": block, "n_tokens": 30}
        inband, bufs = _encode_frame(("handoff_pull_reply", payload))
        assert sum(b.nbytes for b in bufs) == sum(b.nbytes for b in block)
        flat = len(pickle.dumps(("handoff_pull_reply", payload), protocol=4))
        assert len(inband) < 2048
        assert len(inband) * 100 < flat

    def test_small_ops_have_no_oob_buffers(self):
        from paddle_tpu_torch.inference.frontend.rpc import _encode_frame
        _, bufs = _encode_frame(("submit", {
            "prompt_ids": list(range(64)), "max_new_tokens": 8}))
        assert bufs == []

    def test_round_trip_preserves_arrays(self):
        from paddle_tpu_torch.inference.frontend.rpc import (RpcClient,
                                                             RpcServer)
        blocks = {}

        def handler(op, kw):
            if op == "put":
                blocks[kw["key"]] = kw["block"]
                return True
            return blocks[kw["key"]]

        srv = RpcServer(handler).start()
        cli = RpcClient(srv.host, srv.port)
        try:
            a = np.arange(1 << 16, dtype=np.float32).reshape(4, -1)
            assert cli.call("put", key="k", block=(a, a * 2))
            b0, b1 = cli.call("get", key="k")
            np.testing.assert_array_equal(b0, a)
            np.testing.assert_array_equal(b1, a * 2)
        finally:
            cli.close()
            srv.close()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the runners' caches live there)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_cache_dtype", ["auto", "int8"])
def test_gather_scatter_between_runners_bitwise_on_the_card(cuda_device,
                                                            kv_cache_dtype):
    """Two runners on the card, bf16 (or int8 pages with float32 scales):
    pages gathered from one and scattered into others of the second land
    bit for bit, and no other page moves."""
    model = _tiny_bf16_model(cuda_device)
    src, dst = (ModelRunner(model, page_size=8, n_pages=16,
                            kv_cache_dtype=kv_cache_dtype,
                            device=cuda_device) for _ in range(2))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for a in src.cache:
        if a.dtype == torch.int8:
            a.copy_(torch.randint(-127, 128, a.shape, generator=gen,
                                  device=cuda_device, dtype=torch.int8))
        else:
            a.copy_(torch.randn(a.shape, generator=gen, device=cuda_device,
                                dtype=a.dtype))
    before = tuple(a.clone() for a in dst.cache)
    pages, into = [3, 0, 7, 12], [5, 9, 1, 14]
    dst.scatter_pages(into, dst.put_block(src.gather_pages(pages)))
    torch.cuda.synchronize(cuda_device)
    rest = [p for p in range(16) if p not in into]
    for a, b, old in zip(src.cache, dst.cache, before):
        assert torch.equal(b[:, into], a[:, pages])
        assert torch.equal(b[:, rest], old[:, rest])
    # across processes the block travels as host numpy (bf16 as int16)
    host = src.pages_to_host(pages)
    dst.scatter_pages(into[::-1], host)
    for a, b in zip(src.cache, dst.cache):
        assert torch.equal(b[:, into[::-1]], a[:, pages])


def _tiny_bf16_model(device):
    """The reference test's tiny model shape in bfloat16 on ``device``."""
    from paddle_tpu_torch.models.llama_module import LlamaForCausalLM
    return LlamaForCausalLM(LlamaConfig(**_CFG), device=device,
                            dtype=torch.bfloat16,
                            generator=torch.Generator(
                                device=device).manual_seed(0))
