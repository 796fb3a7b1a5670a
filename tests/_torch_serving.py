"""Shared pieces of the port's front-door and fleet tests
(``test_torch_frontend.py``, ``test_torch_fleet.py``).

The model is the JAX package's frontend-test Llama (vocab 128, width 64, 2
layers, 4 q / 2 kv heads) from ``pt.seed(0)``, bridged into the port
through ``llama_from_numpy``, so a port engine and a JAX engine serve the
same weights.  Engines take the JAX frontend tests' knobs (batch 3, length
64, page 8, prefix caching); the port's run on the CPU.  The fleet harness
is the JAX tests' own: thread-hosted ``WorkerServer``s over one store with
an injected clock, where "kill -9" closes a worker's RPC listener and step
loop without releasing its lease."""
import numpy as np

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=176,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=128)
ENGINE = dict(max_batch=3, max_len=64, page_size=8, prefix_cache=True)


def bridged_models():
    """(the JAX model, the port's model on the CPU) with the same weights."""
    import paddle_tpu as pt
    from paddle_tpu.models.llama import LlamaConfig as JaxConfig
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from paddle_tpu_torch.models.convert import llama_from_numpy
    from paddle_tpu_torch.models.llama_module import LlamaConfig

    pt.seed(0)
    jm = JaxLlama(JaxConfig(**CFG))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    return jm, llama_from_numpy(state, LlamaConfig(**CFG), device="cpu")


def engine(model, **kw):
    """A port engine on the CPU with the frontend tests' knobs."""
    from paddle_tpu_torch.inference.serving import LLMEngine
    return LLMEngine(model, device="cpu", **{**ENGINE, **kw})


def jax_engine(model, **kw):
    from paddle_tpu.inference.serving import LLMEngine
    return LLMEngine(model, **{**ENGINE, **kw})


def reference_tokens(model, prompt, n=6):
    """Greedy tokens of one uninterrupted run on a fresh port engine."""
    eng = engine(model)
    rid = eng.add_request(list(prompt), max_new_tokens=n, do_sample=False)
    eng.run_until_done()
    return [int(t) for t in eng.result(rid)]


def prompts(n, seed=0, lo=4, step=3):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, 128, (lo + step * i,))]
            for i in range(n)]


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


class PinRouter:
    """Deterministic routing: the pinned replica when it is a candidate,
    else the first candidate."""

    def __init__(self):
        self.pin = None

    def route(self, prompt_ids, replicas):
        from paddle_tpu_torch.inference.frontend.router import RouteDecision
        rep = next((r for r in replicas if r.name == self.pin), replicas[0])
        return RouteDecision(rep, "pinned")

    def note_event(self, replica_name, event, key):
        pass

    def forget(self, name):
        pass


class Fleet:
    """A store master, N thread-hosted port ``WorkerServer``s and one
    ``FleetReplicaSet``, all on one fake clock.  ``kill`` is SIGKILL-shaped:
    the worker's RPC listener and step loop go, its lease stays."""

    def __init__(self, model, n=2, ttl=5.0, group="fl", router=None,
                 engine_kw=None):
        from paddle_tpu_torch.distributed.store import TCPStore
        from paddle_tpu_torch.inference.frontend.fleet import FleetReplicaSet
        self.model = model
        self.group = group
        self.ttl = ttl
        self.engine_kw = dict(engine_kw or {})
        self.clock = FakeClock(1000.0)
        self.master = TCPStore(is_master=True, timeout=20)
        self.workers = {}
        self.router = router if router is not None else PinRouter()
        self.fleet = FleetReplicaSet(self.store(), group=group, ttl=ttl,
                                     clock=self.clock, router=self.router)
        try:
            for i in range(n):
                self.spawn(f"w{i}")
            self.fleet.sync()
        except BaseException:
            self.close()
            raise

    def store(self):
        from paddle_tpu_torch.distributed.store import TCPStore
        return TCPStore(port=self.master.port, timeout=20)

    def spawn(self, name):
        from paddle_tpu_torch.inference.frontend.worker import WorkerServer
        w = WorkerServer(name, engine(self.model, **self.engine_kw),
                         self.store(), group=self.group, ttl=self.ttl,
                         clock=self.clock)
        w.start(heartbeat=False)                     # tests renew by hand
        self.workers[name] = w
        return w

    def kill(self, name):
        w = self.workers.pop(name)
        w.rpc.close()
        w.replica.close()
        return w

    def renew_all(self):
        for w in self.workers.values():
            w.lease.renew()

    def close(self):
        self.fleet.close()
        for name in list(self.workers):
            self.workers.pop(name).close(drain=False)


class RespawnHandle:
    """The process handle a ``WorkerSupervisor`` drives in-thread:
    'spawning' stands up a fresh thread-hosted worker of the harness."""

    def __init__(self, harness, name):
        self.worker = harness.spawn(name)

    def poll(self):
        return None if self.worker.replica.alive else 1

    def terminate(self):
        self.worker.close(drain=False)

    def kill(self):
        self.terminate()

    def wait(self, timeout=None):
        return 0
