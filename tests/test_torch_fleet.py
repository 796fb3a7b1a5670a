"""The port's fleet on the CPU: the socket RPC, worker supervision,
``TCPStore`` on both server kinds, lease membership, thread-hosted
``WorkerServer``s over port engines with an injected clock (as the JAX
package's tier-1 fleet tests run them), the peer KV tier between two port
workers, and one real worker subprocess.

The chaos scenario is the JAX package's
``test_fleet.py::TestFleetChaos::test_kill_mid_stream_full_recovery`` with
port engines: there it races on an idle host (its replica step loop takes
its lock back at once and starves the ``status`` RPC inside ``submit``);
the port's copy grants that lock in arrival order, and the scenario must
pass."""
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_fleet_worker_spec as spec
import _torch_serving as ts
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.core.retry import RetryPolicy
from paddle_tpu_torch.distributed.membership import (EXPIRE, JOIN, LEAVE,
                                                     MembershipService)
from paddle_tpu_torch.distributed.store import StoreKeyDeleted, TCPStore
from paddle_tpu_torch.inference.frontend import ShedError
from paddle_tpu_torch.inference.frontend.fleet import FleetReplicaSet
from paddle_tpu_torch.inference.frontend.rpc import (RpcClient, RpcError,
                                                     RpcServer)
from paddle_tpu_torch.inference.frontend.supervisor import (QUARANTINED,
                                                            RESPAWNED,
                                                            RUNNING,
                                                            WorkerSupervisor)
from paddle_tpu_torch.inference.serving import (LLMEngine, RequestStatus,
                                                prefix_page_keys)
from paddle_tpu_torch.testing import FAULTS, Always, FailNth, InjectedFault

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


# ------------------------------------------------------------------ RPC layer

def test_rpc_roundtrip_errors_and_fault_points():
    def handler(op, kw):
        if op == "submit":
            raise ShedError("draining", retry_after=7.5)
        return op, sorted(kw.items())

    srv = RpcServer(handler)
    srv.start()
    c = RpcClient(srv.host, srv.port)
    try:
        assert c.call("ping", a=1) == ("ping", [("a", 1)])
        with pytest.raises(ShedError) as ei:
            c.call("submit")
        assert (ei.value.reason, ei.value.retry_after) == ("draining", 7.5)
        FAULTS.install("rpc.send", FailNth(1))
        with pytest.raises(InjectedFault):
            c.call("ping")
        assert c.call("ping")[0] == "ping"           # the next call recovers
        FAULTS.reset()
        FAULTS.install("rpc.recv", FailNth(1))
        with pytest.raises(InjectedFault):
            c.call("ping")
    finally:
        c.close()
        srv.close()
    dead = RpcClient("127.0.0.1", srv.port, connect_timeout=0.5)
    with pytest.raises(RpcError):
        dead.call("ping")
    dead.close()


# --------------------------------------------------------------- supervisor

class _FakeProc:
    def __init__(self):
        self.rc = None
        self.terminated = False

    def poll(self):
        return self.rc

    def terminate(self):
        self.terminated = True
        self.rc = 0

    def kill(self):
        self.rc = -9

    def wait(self, timeout=None):
        return self.rc


def _supervisor(clock, **kw):
    procs, sleeps = [], []

    def spawn():
        procs.append(_FakeProc())
        return procs[-1]

    return (WorkerSupervisor(spawn, name="w", clock=clock,
                             sleep=sleeps.append, **kw), procs, sleeps)


def test_supervisor_backs_off_then_quarantines_a_crash_loop():
    clock = ts.FakeClock()
    sup, procs, sleeps = _supervisor(clock, base_delay=0.1, multiplier=2.0,
                                     max_delay=0.3, max_crashes=5,
                                     crash_window=100.0)
    sup.start_worker()
    assert sup.tick() == RUNNING
    for expected in (0.1, 0.2, 0.3, 0.3):
        procs[-1].rc = 1
        clock.t += 1
        assert sup.tick() == RESPAWNED
        assert sleeps[-1] == pytest.approx(expected)
    procs[-1].rc = 1
    clock.t += 1
    assert sup.tick() == QUARANTINED
    assert sup.tick() == QUARANTINED and len(procs) == 5
    sup.reset()
    assert sup.tick() == RESPAWNED
    sup.stop()
    assert procs[-1].terminated


# -------------------------------------------------------------------- store

def _exercise(master, client):
    master.set("obj", {"a": [1, 2]})
    assert client.get("obj") == {"a": [1, 2]}
    assert client.add("n", 3) == 3 and master.add("n", -1) == 2
    assert master.get("n") == 2
    ok, _ = client.compare_and_set("k", None, ["v1"])
    raw = client.get_raw("k")
    assert ok and not client.compare_and_set("k", b"stale", ["v2"])[0]
    assert client.compare_and_set("k", raw, ["v2"])[0]
    assert master.get("k") == ["v2"]
    assert master.delete_key("obj") is True
    assert master.delete_key("obj") is False
    res = {}

    def blocked():
        try:
            client.get("dw", timeout=10)
        except StoreKeyDeleted:
            res["r"] = "deleted"

    t = threading.Thread(target=blocked)
    t.start()
    deadline = time.monotonic() + 10
    while "r" not in res and time.monotonic() < deadline:
        master.delete_key("dw")
        time.sleep(0.05)
    t.join(timeout=15)
    assert res == {"r": "deleted"}
    with pytest.raises(TimeoutError):
        client.get("missing", timeout=0.2)


_NATIVE = """
import sys
sys.path.insert(0, {tests!r})
from test_torch_fleet import _exercise
from paddle_tpu_torch.distributed.store import TCPStore
m = TCPStore(is_master=True, timeout=20)
assert m.server_kind == "native", m.server_kind
_exercise(m, TCPStore(port=m.port, timeout=20))
print("NATIVE_OK")
"""


@pytest.mark.parametrize("kind", ["native", "python"])
def test_store_on_both_server_kinds(kind, monkeypatch):
    """The daemon is once a process, so the native kind runs in a fresh
    one (it builds ``core/native/store.cc`` with g++ at first use)."""
    if kind == "python":
        monkeypatch.setenv("PADDLE_TPU_PURE_PY_STORE", "1")
        m = TCPStore(is_master=True, timeout=20)
        assert m.server_kind == "python"
        _exercise(m, TCPStore(port=m.port, timeout=20))
        return
    from paddle_tpu_torch.core.native.build import _cache_dir, load
    if load("pt_store", "store.cc") is None:
        pytest.skip("no C++ toolchain")
    assert Path(_cache_dir()) == REPO / "build" / "paddle_tpu_torch" / "native"
    r = subprocess.run(
        [sys.executable, "-c", _NATIVE.format(tests=str(REPO / "tests"))],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert "NATIVE_OK" in r.stdout, r.stderr[-2000:]


# --------------------------------------------------------------- membership

def test_membership_join_expire_leave_and_epochs(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PURE_PY_STORE", "1")
    master = TCPStore(is_master=True, timeout=20)
    clock = ts.FakeClock(1000.0)
    svc = MembershipService(master, group="g", ttl=2.0, clock=clock,
                            retry_policy=RetryPolicy(max_attempts=2,
                                                     base_delay=0.0,
                                                     max_delay=0.0))
    w = svc.watch()
    a = svc.register("a", meta={"port": 1})
    b = svc.register("b", meta={"port": 2})
    assert [(e.kind, e.member.name) for e in w.poll()] == [(JOIN, "a"),
                                                          (JOIN, "b")]
    assert svc.members()["a"].meta == {"port": 1} and a.epoch == 1
    clock.t += 1.5
    a.renew()
    assert w.poll() == []
    clock.t += 1.0                                   # b's lease lapsed
    assert [(e.kind, e.member.name) for e in w.poll()] == [(EXPIRE, "b")]
    b2 = svc.register("b")
    assert [(e.kind, e.member.epoch) for e in w.poll()] == [(JOIN, 2)]
    assert b2.epoch == 2
    a.release()
    assert [(e.kind, e.member.name) for e in w.poll()] == [(LEAVE, "a")]


# ------------------------------------------- fleet end-to-end (tiny engines)

@pytest.fixture(scope="module")
def models():
    return ts.bridged_models()


@pytest.fixture()
def fleet(models, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PURE_PY_STORE", "1")
    f = ts.Fleet(models[1], n=2)
    yield f
    f.close()


def test_members_join_and_stream_the_jax_engines_tokens(fleet, models):
    jm, tm = models
    assert {r.name for r in fleet.fleet.alive_replicas()} == {"w0", "w1"}
    prompt = list(range(1, 17))
    jeng = ts.jax_engine(jm)
    rid = jeng.add_request(prompt, max_new_tokens=6)
    jeng.run_until_done()
    want = [int(t) for t in jeng.result(rid)]
    assert ts.reference_tokens(tm, prompt) == want
    for name in ("w0", "w1"):
        fleet.router.pin = name
        h = fleet.fleet.submit(prompt, max_new_tokens=6, do_sample=False)
        assert h.replica.name == name
        assert list(fleet.fleet.stream(h)) == want
        assert fleet.fleet.status(h) is RequestStatus.FINISHED


def test_drain_sheds_typed_and_release_leaves(fleet):
    fleet.workers["w0"].draining = True
    with pytest.raises(ShedError) as ei:
        fleet.fleet.replica("w0").submit(list(range(16)), max_new_tokens=4)
    assert ei.value.reason == "draining"
    assert fleet.fleet.replica("w0").alive
    fleet.workers["w1"].lease.release()
    assert [(e.kind, e.member.name) for e in fleet.fleet.sync()] == [
        ("leave", "w1")]
    assert {r.name for r in fleet.fleet.alive_replicas()} == {"w0"}


def test_kill_mid_stream_full_recovery(fleet, models):
    """The reference's chaos scenario with port engines: a partially
    streamed victim resumes token-exact on the survivor, a zero-token one
    is requeued, the survivor's own stream is untouched, the dead lease
    expires one TTL later and a supervised respawn rejoins under epoch 2
    within one TTL."""
    obs.enable()
    try:
        _chaos_scenario(fleet, models[1])
    finally:
        obs.disable()
        obs.reset()


def _chaos_scenario(fleet, model):
    fs = fleet.fleet
    prompt_a = list(range(1, 17))
    prompt_b = list(range(30, 46))
    prompt_c = list(range(60, 76))
    ref_a = ts.reference_tokens(model, prompt_a, n=24)
    ref_b = ts.reference_tokens(model, prompt_b)
    ref_c = ts.reference_tokens(model, prompt_c)
    # paced steps: A's 24 tokens take >= 6 s, the window before the kill
    # is two A pulls and one C pull
    FAULTS.install("serving.slow_step", Always(), delay=0.25)
    fleet.router.pin = "w0"
    h_a = fs.submit(prompt_a, max_new_tokens=24, do_sample=False)
    h_b = fs.submit(prompt_b, max_new_tokens=6, do_sample=False)
    fleet.router.pin = "w1"
    h_c = fs.submit(prompt_c, max_new_tokens=6, do_sample=False)
    assert (h_a.replica.name, h_b.replica.name,
            h_c.replica.name) == ("w0", "w0", "w1")
    stream_a = fs.stream(h_a)
    got_a = [next(stream_a), next(stream_a)]
    stream_c = fs.stream(h_c)
    got_c = [next(stream_c)]
    fleet.kill("w0")
    FAULTS.reset()
    fleet.router.pin = None

    assert list(fs.stream(h_b)) == ref_b
    assert h_b.requeued and h_b.replica.name == "w1"
    got_a += list(stream_a)
    assert h_a.resumed and not h_a.requeued and h_a.replica.name == "w1"
    assert got_a == ref_a
    assert fs.status(h_a) is RequestStatus.FINISHED
    got_c += list(stream_c)
    assert got_c == ref_c

    fleet.renew_all()
    fleet.clock.t += fleet.ttl + 0.5
    fleet.workers["w1"].lease.renew()
    assert [(e.kind, e.member.name) for e in fs.sync()] == [("expire", "w0")]
    assert {r.name for r in fs.alive_replicas()} == {"w1"}

    sup = WorkerSupervisor(lambda: ts.RespawnHandle(fleet, "w0"), name="w0",
                           clock=fleet.clock, sleep=lambda s: None,
                           max_crashes=5)
    sup.start_worker()
    assert sup.tick() == RUNNING
    fleet.clock.t += fleet.ttl / 2
    assert [(e.kind, e.member.name, e.member.epoch) for e in fs.sync()] == [
        ("join", "w0", 2)]
    fleet.router.pin = "w0"
    h = fs.submit(prompt_b, max_new_tokens=6, do_sample=False)
    assert h.replica.name == "w0" and h.replica.epoch == 2
    assert list(fs.stream(h)) == ref_b
    text = obs.render_prometheus()
    assert ('membership_lease_expiries_total{group="%s"} 1'
            % fleet.group) in text
    assert "frontend_requeued_total 1" in text
    assert "frontend_resumed_total 1" in text


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_peer_pages_pull_and_push_land_bitwise(models, dtype, monkeypatch):
    """A page chain pulled over RPC from one port worker and pushed into
    another lands bitwise (bf16 pages travel as int16 bit patterns), and
    the receiver then serves the same prompt from those pages with the
    sender's tokens."""
    import copy
    monkeypatch.setenv("PADDLE_TPU_PURE_PY_STORE", "1")
    model = models[1]
    if dtype == "bfloat16":
        model = copy.deepcopy(model).to(torch.bfloat16)
    f = ts.Fleet(model, n=2)
    try:
        prompt = list(range(3, 23))                  # two full pages of 8
        f.router.pin = "w0"
        h = f.fleet.submit(prompt, max_new_tokens=4, do_sample=False)
        want = list(f.fleet.stream(h))
        keys = prefix_page_keys(prompt, 8)
        sender, receiver = f.fleet.replica("w0"), f.fleet.replica("w1")
        payload = sender.export_pages(keys)
        assert payload["keys"] == keys
        if dtype == "bfloat16":
            assert all(a.dtype == np.int16 for a in payload["block"])
        assert receiver.import_pages(payload) == len(keys)
        back = receiver.export_pages(keys)
        assert all(a.dtype == b.dtype and a.tobytes() == b.tobytes()
                   for a, b in zip(payload["block"], back["block"]))
        f.router.pin = "w1"
        h = f.fleet.submit(prompt, max_new_tokens=4, do_sample=False)
        assert list(f.fleet.stream(h)) == want
        stats = f.workers["w1"].replica.engine.prefix_cache_stats()
        assert stats["hits"] == len(keys)
    finally:
        f.close()


def test_a_real_worker_subprocess_serves_a_request(monkeypatch):
    """``python -m paddle_tpu_torch.inference.frontend.worker`` with a CPU
    engine factory joins through membership, streams the tokens of the
    same engine built here, has loaded neither JAX nor the JAX package,
    and drains on SIGTERM."""
    monkeypatch.setenv("PADDLE_TPU_PURE_PY_STORE", "1")
    master = TCPStore(is_master=True, timeout=60)
    fleet = FleetReplicaSet(TCPStore(port=master.port, timeout=60),
                            group="real", ttl=5.0)
    env = {**os.environ, "PADDLE_TPU_PURE_PY_STORE": "1",
           "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.inference.frontend.worker",
         "--engine-spec",
         f"{REPO / 'tests' / '_torch_fleet_worker_spec.py'}:make_engine",
         "--name", "w0", "--store-port", str(master.port),
         "--group", "real", "--ttl", "5"],
        env=env, cwd=REPO)
    try:
        deadline = time.monotonic() + 60
        while not fleet.alive_replicas() and time.monotonic() < deadline:
            fleet.sync()
            time.sleep(0.2)
        assert [r.name for r in fleet.alive_replicas()] == ["w0"]
        prompt = list(range(1, 17))
        want = ts.reference_tokens(spec.make_model(), prompt)
        h = fleet.submit(prompt, max_new_tokens=6, do_sample=False)
        assert list(fleet.stream(h)) == want
        health = fleet.replica("w0").health()
        assert health["forbidden_modules"] == []
        assert fleet.membership.members()["w0"].meta["pid"] == proc.pid
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        deadline = time.monotonic() + 10
        gone = False
        while not gone and time.monotonic() < deadline:
            gone = any(e.kind == "leave" for e in fleet.sync())
            time.sleep(0.1)
        assert gone
    finally:
        fleet.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_engine_factory_decides_the_device():
    """A factory that names no device gets the card, as every port entry
    point does: without one it raises."""
    from unittest import mock
    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LLMEngine(spec.make_model())
