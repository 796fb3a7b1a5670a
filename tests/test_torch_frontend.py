"""The port's serving front door (``paddle_tpu_torch.inference.frontend``)
against the JAX package's, on the CPU.

- Every copied module (the frontend, ``distributed/{store,membership}.py``,
  ``core/native/{build.py,store.cc}``) equals its reference once the
  package name is rewritten, apart from the deliberate divergences that
  ROADMAP queue 3 lists (``DIVERGENT`` below); the test fails as well if a
  listed divergence is gone.
- Concurrent SSE streams through the port's gateway are token-identical to
  direct port-engine runs and to the JAX package's ``ReplicaSet`` + gateway
  on the same (bridged) weights and ``make_trace`` seed.
- Prefix-affinity routing beats round-robin on prefix-cache hits with port
  engines.
- A ``frontend.step`` fault kills a replica mid-stream and the durable
  gateway resumes its streams token-exact on the survivor.
- The lock yield: ``status`` is served within a step while a replica
  decodes a paced stream, through the engine condition's lock granted in
  arrival order (``_FairRLock``).
- The launch counters stay exact across threads (``ops._counts``)."""
import sys
import threading
import time
from pathlib import Path

import pytest

import _torch_serving as ts
from _torch_copies import differing_units, statement
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.inference.frontend import (ReplicaSet, make_trace,
                                                 run_closed_loop,
                                                 start_gateway)
from paddle_tpu_torch.inference.frontend.journal import RequestJournal
from paddle_tpu_torch.inference.frontend.loadgen import http_completion
from paddle_tpu_torch.inference.frontend.replica import _FairRLock
from paddle_tpu_torch.inference.frontend.router import (PrefixAffinityRouter,
                                                        RoundRobinRouter)
from paddle_tpu_torch.inference.serving import RequestStatus
from paddle_tpu_torch.ops import _counts
from paddle_tpu_torch.ops.paged_attention import paged_attention
from paddle_tpu_torch.testing import FAULTS, Always, FailNth

REPO = Path(__file__).resolve().parent.parent


# port path (under paddle_tpu_torch/, the reference's under paddle_tpu/) ->
# the units that differ on purpose (ROADMAP queue 3): a top-level function
# or class by name, a method as "Class.method", the module docstring as
# "__doc__", any other top-level statement by ``statement``
DIVERGENT = {
    "inference/frontend/__init__.py": set(),
    "inference/frontend/admission.py": set(),
    "inference/frontend/disagg.py": set(),
    "inference/frontend/fleet.py": set(),
    "inference/frontend/gateway.py": set(),
    "inference/frontend/journal.py": set(),
    "inference/frontend/loadgen.py": set(),
    # the engine condition's lock is granted in arrival order
    "inference/frontend/replica.py": {"_FairRLock", "EngineReplica.__init__"},
    "inference/frontend/router.py": set(),
    "inference/frontend/rpc.py": set(),
    "inference/frontend/supervisor.py": set(),
    "inference/frontend/worker.py": set(),
    "distributed/store.py": set(),
    "distributed/membership.py": set(),
    # the store daemon builds into build/paddle_tpu_torch/native/, each
    # process through a temporary of its own
    "core/native/build.py": {"__doc__", "_cache_dir", "load"},
    # no jax; engines on devices, not mesh slices: split_mesh is not
    # carried, the pool's __init__ takes one device and refuses the mesh
    # knobs
    "inference/engine/disagg.py": {
        "__doc__", statement("import jax"), "split_mesh",
        statement('__all__ = ["DisaggEngine", "split_mesh"]'),
        statement('__all__ = ["DisaggEngine"]'), "DisaggEngine.__init__"},
}


@pytest.mark.parametrize("path", sorted(DIVERGENT))
def test_copy_matches_the_reference(path):
    assert differing_units(path) == DIVERGENT[path]


def test_store_daemon_source_is_the_reference():
    rel = Path("core") / "native" / "store.cc"
    assert ((REPO / "paddle_tpu_torch" / rel).read_bytes()
            == (REPO / "paddle_tpu" / rel).read_bytes())


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


@pytest.fixture(scope="module")
def models():
    return ts.bridged_models()


def _http_streams(gw_url, trace):
    """Every trace request streamed concurrently through the gateway;
    returns each one's tokens, in trace order."""
    results, errors = [None] * len(trace), []

    def client(i):
        try:
            results[i] = http_completion(gw_url, trace[i]["prompt"],
                                         max_tokens=trace[i]["max_tokens"],
                                         stream=True, timeout=60.0)
        except Exception as e:  # surfaced through errors
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(trace))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90.0)
    assert not errors, errors
    assert all(r["status"] in ("finished", "eos") for r in results)
    # one event a token, the final status and [DONE]
    assert all(r["events"] == len(r["tokens"]) + 2 for r in results)
    return [r["tokens"] for r in results]


def test_sse_streams_match_direct_engine_and_the_jax_gateway(models):
    """Four concurrent SSE clients (two shared-prefix groups of
    ``make_trace``) through the port's gateway over two port replicas get
    the direct port engine's tokens, and the JAX package's gateway over
    two JAX replicas on the same weights gives the same streams."""
    from paddle_tpu.inference.frontend import ReplicaSet as JaxReplicaSet
    from paddle_tpu.inference.frontend import start_gateway as jax_gateway
    jm, tm = models
    trace = make_trace(5, 4, groups=2, prefix_pages=2, page_size=8,
                       suffix_tokens=3, max_new_tokens=6)
    direct = ts.engine(tm)
    rids = [direct.add_request(r["prompt"], max_new_tokens=r["max_tokens"])
            for r in trace]
    direct.run_until_done()
    want = [[int(t) for t in direct.result(r)] for r in rids]

    rs = ReplicaSet([ts.engine(tm), ts.engine(tm)])
    gw = start_gateway(rs)
    try:
        port = _http_streams(gw.url, trace)
    finally:
        gw.close()
        rs.close()
    jrs = JaxReplicaSet([ts.jax_engine(jm), ts.jax_engine(jm)])
    jgw = jax_gateway(jrs)
    try:
        jax = _http_streams(jgw.url, trace)
    finally:
        jgw.close()
        jrs.close()
    assert port == want
    assert jax == want


def _closed_loop(model, router, trace):
    rs = ReplicaSet([ts.engine(model), ts.engine(model)], router=router)
    try:
        records, _ = run_closed_loop(rs, trace, concurrency=1)
        stats = [r.engine.prefix_cache_stats() for r in rs.replicas]
    finally:
        rs.close()
    assert all(r["status"] in ("finished", "eos") for r in records)
    hits = sum(s["hits"] for s in stats)
    return records, hits, max(1, hits + sum(s["misses"] for s in stats))


def test_affinity_beats_round_robin_on_prefix_hits(models):
    """The reference's acceptance, with port engines: a group-major
    repeated-prefix trace, closed loop over two replicas.  Round-robin
    sends each group's repeat to the replica without its prefix; affinity
    sends it back (at least twice round-robin's hit rate, and every group
    on one replica)."""
    _, tm = models
    trace = make_trace(3, 8, groups=4, prefix_pages=2, page_size=8,
                       suffix_tokens=3, max_new_tokens=4, group_major=True)
    _, rr_hits, rr_lookups = _closed_loop(tm, RoundRobinRouter(), trace)
    obs.enable()
    try:
        obs.reset()
        records, hits, lookups = _closed_loop(
            tm, PrefixAffinityRouter(page_size=8), trace)
        snap = obs.snapshot(prefix="frontend_affinity")
        events = {s["labels"]["event"]: s["value"] for s in
                  snap["frontend_affinity_events_total"]["series"]}
    finally:
        obs.disable()
        obs.reset()
    assert hits > 0
    assert rr_hits == 0 or hits / lookups >= 2 * rr_hits / rr_lookups
    assert events.get("hit", 0) >= 4
    by_group = {}
    for r in records:
        by_group.setdefault(r["group"], set()).add(r["replica"])
    assert all(len(v) == 1 for v in by_group.values())


def test_replica_death_resumes_token_exact_through_the_journal(models,
                                                               tmp_path):
    """Two streams pinned to r0 of a requeueing set behind the durable
    gateway; r0's sixth step raises (``frontend.step``) once both have
    streamed tokens.  Both streams still carry exactly the tokens of an
    uninterrupted run, the journal holds them, and r0 is dead."""
    _, tm = models
    prompts = ts.prompts(2, seed=21)
    want = [ts.reference_tokens(tm, p, 8) for p in prompts]
    router = ts.PinRouter()
    router.pin = "r0"
    rs = ReplicaSet([ts.engine(tm), ts.engine(tm)], router=router,
                    requeue=True)
    gw = start_gateway(rs, journal_dir=str(tmp_path), journal_fsync="never")
    # paced steps give the plane's pumps time to deliver tokens before
    # the death, so the streams resume rather than requeue
    FAULTS.install("serving.slow_step", Always(), delay=0.05)
    FAULTS.install("frontend.step", FailNth(6),
                   match=lambda ctx: ctx.get("replica") == "r0")
    obs.enable()
    try:
        got = _http_streams(gw.url, [{"prompt": p, "max_tokens": 8}
                                     for p in prompts])
        resumed = obs.snapshot(prefix="frontend_resumed")
    finally:
        obs.disable()
        obs.reset()
        gw.close()
        rs.close()
    assert got == want
    assert not rs.replica("r0").alive and rs.replica("r1").alive
    n_resumed = sum(s["value"] for s in
                    resumed["frontend_resumed_total"]["series"])
    assert n_resumed >= 1
    with RequestJournal(str(tmp_path)) as journal:
        replayed, counts = journal.replay()
    assert counts["torn"] == 0
    assert sorted(r.tokens for r in replayed.values()) == sorted(want)
    assert all(r.status is RequestStatus.FINISHED
               for r in replayed.values())


def test_status_is_served_while_a_replica_decodes_a_paced_stream(models):
    """The lock yield (a divergence from the reference, whose step loop
    takes its condition back at once after each step and can starve a
    caller for a whole stream): while one replica decodes a stream of
    0.1 s steps, every ``status`` call on it returns within a step or
    two, and the stream is still running for most of them."""
    _, tm = models
    FAULTS.install("serving.slow_step", Always(), delay=0.1)
    rs = ReplicaSet([ts.engine(tm)])
    try:
        h = rs.submit(ts.prompts(1, seed=3)[0], max_new_tokens=16)
        waits, live = [], 0
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            t0 = time.monotonic()
            status = h.replica.status(h.rid)
            waits.append(time.monotonic() - t0)
            if status.terminal:
                break
            live += 1
            time.sleep(0.02)
    finally:
        rs.close()
    assert status is RequestStatus.FINISHED
    assert live >= 5, f"only {live} status calls while the stream ran"
    assert max(waits) < 0.5, f"a status call waited {max(waits):.2f} s"


def test_fair_lock_grants_in_arrival_order_and_serves_a_condition():
    lock = _FairRLock()
    order, started = [], []
    lock.acquire()
    assert lock.acquire()                       # reentrant
    assert not lock._queue

    def waiter(i):
        started.append(i)
        with lock:
            order.append(i)

    threads = []
    for i in range(4):
        t = threading.Thread(target=waiter, args=(i,))
        t.start()
        threads.append(t)
        deadline = time.monotonic() + 5.0
        while len(lock._queue) < i + 1 and time.monotonic() < deadline:
            time.sleep(0.001)
    assert len(lock._queue) == 4
    lock.release()
    assert order == []                          # still held once
    lock.release()
    for t in threads:
        t.join(timeout=5.0)
    assert order == [0, 1, 2, 3]
    assert lock._owner is None
    assert lock.acquire(blocking=False)
    other = []
    t = threading.Thread(
        target=lambda: other.append(lock.acquire(timeout=0.05)))
    t.start()
    t.join(timeout=5.0)
    assert other == [False] and not lock._queue
    lock.release()

    cv = threading.Condition(_FairRLock())
    box = []

    def producer():
        with cv:
            box.append(1)
            cv.notify_all()

    with cv:
        with cv:                                # wait() at depth 2
            t = threading.Thread(target=producer)
            t.start()
            assert cv.wait_for(lambda: box, timeout=5.0)
        assert cv._lock._depth == 1
    t.join(timeout=5.0)
    assert cv._lock._owner is None


def test_launch_counts_of_a_recording_thread_stay_its_own():
    """A thread capturing a graph tallies its launches apart; the launches
    of sixteen other threads meanwhile reach the counter, none lost with
    the interpreter switching threads as often as it can."""
    before = paged_attention.launches
    inside = threading.Event()
    done = threading.Event()
    tallies = []

    def capturing():
        with _counts.recording() as tally:
            _counts.count(paged_attention, "launches", 3)
            inside.set()
            done.wait(5.0)
        tallies.append(tally)

    t = threading.Thread(target=capturing)
    t.start()
    assert inside.wait(5.0)
    workers = [threading.Thread(target=lambda: [
        _counts.count(paged_attention, "launches") for _ in range(1000)])
        for _ in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=30.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    done.set()
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert tallies == [{"paged_attention.launches": 3}]
    assert paged_attention.launches - before == 16000
    _counts.add(((paged_attention, "launches"),), tallies[0])
    assert paged_attention.launches - before == 16003
    paged_attention.launches = before
