"""The port's data pipeline and checkpoints (``paddle_tpu_torch/io/``,
``core/native/dataloader.cc``, ``framework/io.py``) against the JAX
package's on the CPU.

- ``tests/test_native_loader.py`` and ``tests/test_bucketing.py`` mirrored
  on the port, each case also held to the JAX package's batches (one
  ``to_static`` variant per bucket); the bucketed loss at the reference's
  rtol 2e-5.
- Sampler orders under one ``np.random.seed`` equal to the reference's;
  orders drawn from a ``Generator`` are compared within the port only (the
  two packages' generators draw different streams).
- ``default_collate_fn`` trees, and the sync, worker and native loaders,
  batch for batch equal to the reference's.
- ``save`` / ``load`` round trips bit for bit, and a file the JAX package
  wrote (a tiny GPT-2's bf16 state dict and its AdamW state) loaded in a
  process where ``ml_dtypes`` cannot be imported and ``paddle_tpu`` never
  loads, every tensor bit for bit.
- The copies ``io/__init__.py`` and ``io/native_loader.py`` (ASTs held to
  the reference's but the units ``DIVERGENT`` lists) and the byte-equal
  ``dataloader.cc``.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.io as jio
import paddle_tpu_torch as tp
import paddle_tpu_torch.io as tio
from _torch_copies import REPO, differing_units, statement
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.io.native_loader import NativeArrayLoader, available

native = pytest.mark.skipif(not available(),
                            reason="no C++ toolchain for the native engine")


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev


def _data(n=64, l=8, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 1000, (n, l)).astype(np.int32),
            rng.randn(n, l).astype(np.float32))


def _np(t):
    return t.numpy() if hasattr(t, "numpy") else np.asarray(t)


def _tree(x):
    """A batch as nested lists / dicts of numpy arrays."""
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v) for v in x]
    return _np(x) if hasattr(x, "numpy") or isinstance(x, np.ndarray) else x


# the port's Tensor narrows 64-bit host data to 32 bits as it is made (the
# spine's); the reference's Tensor keeps an int64 array until an op runs
NARROW = {np.dtype(np.int64): np.dtype(np.int32),
          np.dtype(np.float64): np.dtype(np.float32)}


def _same_tree(a, b):
    """``a`` (the port's) equal to ``b`` (the reference's), dtypes too, but
    for the 64-bit narrowing above."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same_tree(u, v)
    elif isinstance(a, np.ndarray):
        assert a.dtype == NARROW.get(b.dtype, b.dtype), (a.dtype, b.dtype)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


# ---- copies -----------------------------------------------------------------
DIVERGENT = {
    "io/__init__.py": {
        "__doc__", statement("import torch"), "_tensor",
        statement("from ..framework.io import _host, _to_buf"),
        # the port's Generator is a torch.Generator a device
        "_epoch_seed",
        # the default ranks wait for M12
        "DistributedBatchSampler.__init__",
        # host reads bit for bit, from the card too; fork safety
        "BucketCollate.__call__", "default_collate_fn", "_worker_loop",
        "_to_numpy_tree", "_to_tensor_tree", "DataLoader._iter_native"},
    "io/native_loader.py": set(),
    "framework/__init__.py": {"__doc__"},
}


@pytest.mark.parametrize("path", sorted(DIVERGENT))
def test_copy_matches_the_reference(path):
    assert differing_units(path) == DIVERGENT[path]


def test_dataloader_source_is_byte_equal():
    rel = Path("core") / "native" / "dataloader.cc"
    assert (REPO / "paddle_tpu_torch" / rel).read_bytes() == \
        (REPO / "paddle_tpu" / rel).read_bytes()


# ---- tests/test_native_loader.py, on the port --------------------------------
@native
class TestEngine:
    def test_order_and_values(self):
        xs, ys = _data()
        batches = [list(range(i, i + 16)) for i in range(0, 64, 16)]
        out = list(NativeArrayLoader([xs, ys], batches, num_threads=4))
        assert len(out) == 4
        for k, (bx, by) in enumerate(out):
            np.testing.assert_array_equal(bx, xs[batches[k]])
            np.testing.assert_array_equal(by, ys[batches[k]])

    def test_shuffled_and_ragged_tail(self):
        xs, _ = _data(n=50)
        perm = np.random.RandomState(3).permutation(50)
        batches = [perm[i:i + 16].tolist() for i in range(0, 50, 16)]
        out = [b[0] for b in NativeArrayLoader([xs], batches, num_threads=3)]
        assert [len(b) for b in out] == [16, 16, 16, 2]
        for k, b in enumerate(out):
            np.testing.assert_array_equal(b, xs[batches[k]])

    def test_bad_index_raises(self):
        xs, _ = _data(n=8)
        with pytest.raises(RuntimeError):
            list(NativeArrayLoader([xs], [[0, 99]], num_threads=1))

    def test_many_batches_soak(self):
        xs, _ = _data(n=256, l=4)
        batches = [np.random.RandomState(i).randint(0, 256, 8).tolist()
                   for i in range(200)]
        out = [b[0] for b in NativeArrayLoader([xs], batches,
                                               num_threads=8, depth=4)]
        assert len(out) == 200
        for k in (0, 57, 123, 199):
            np.testing.assert_array_equal(out[k], xs[batches[k]])

    def test_owned_copies_survive(self):
        xs, _ = _data(n=32)
        batches = [list(range(0, 8)), list(range(8, 16)), list(range(16, 24))]
        held = list(NativeArrayLoader([xs], batches, num_threads=2, depth=1))
        np.testing.assert_array_equal(held[0][0], xs[:8])
        np.testing.assert_array_equal(held[2][0], xs[16:24])


@native
class TestDataLoaderIntegration:
    def test_auto_engine_matches_sync_and_the_reference(self):
        xs, ys = _data()
        ds = tio.TensorDataset([tp.to_tensor(xs), tp.to_tensor(ys)])
        sync = [(a.numpy(), b.numpy()) for a, b in
                tio.DataLoader(ds, batch_size=16)]
        nat = [(a.numpy(), b.numpy()) for a, b in
               tio.DataLoader(ds, batch_size=16, num_workers=4,
                              engine="native")]
        jds = jio.TensorDataset([pt.to_tensor(xs), pt.to_tensor(ys)])
        ref = [(np.asarray(a._data), np.asarray(b._data))
               for a, b in jio.DataLoader(jds, batch_size=16)]
        assert len(sync) == len(nat) == len(ref) == 4
        for (sa, sb), (na, nb), (ra, rb) in zip(sync, nat, ref):
            for got in (sa, na):
                np.testing.assert_array_equal(got, ra)
            for got in (sb, nb):
                np.testing.assert_array_equal(got, rb)

    def test_native_requires_tensor_dataset(self):
        class LD(tio.Dataset):
            def __getitem__(self, i):
                return np.zeros(3, np.float32)

            def __len__(self):
                return 8

        with pytest.raises(RuntimeError):
            iter(tio.DataLoader(LD(), batch_size=2, num_workers=2,
                                engine="native")).__next__()

    def test_native_engine_with_zero_workers(self):
        xs, ys = _data(n=32)
        ds = tio.TensorDataset([tp.to_tensor(xs), tp.to_tensor(ys)])
        out = list(tio.DataLoader(ds, batch_size=8, engine="native"))
        assert len(out) == 4
        np.testing.assert_array_equal(out[0][0].numpy(), xs[:8])

    def test_python_engine_still_works(self):
        class NpDataset(tio.Dataset):
            def __init__(self):
                self.xs, self.ys = _data(n=32)

            def __getitem__(self, i):
                return self.xs[i], self.ys[i]

            def __len__(self):
                return 32

        out = list(tio.DataLoader(NpDataset(), batch_size=8, num_workers=2,
                                  engine="python"))
        assert len(out) == 4
        np.testing.assert_array_equal(out[0][0].numpy(), _data(n=32)[0][:8])

    def test_bf16_dataset_keeps_its_bits_on_every_engine(self):
        """A bf16 TensorDataset: the native engine gathers its raw bits
        and the workers ship them, so every engine yields bf16 batches
        bitwise the sync path's."""
        xs, ys = _data(n=32)
        ds = tio.TensorDataset([tp.to_tensor(xs),
                                tp.to_tensor(ys).astype("bfloat16")])
        sync = [b._data for _, b in tio.DataLoader(ds, batch_size=8)]
        for engine, nw in (("native", 2), ("python", 2)):
            got = [b._data for _, b in tio.DataLoader(
                ds, batch_size=8, num_workers=nw, engine=engine)]
            assert [g.dtype for g in got] == [torch.bfloat16] * 4
            assert all(torch.equal(g.view(torch.int16), s.view(torch.int16))
                       for g, s in zip(got, sync))


# ---- tests/test_bucketing.py, on the port ------------------------------------
def _mixed_length_data(n=12, lo=5, hi=60, vocab=256, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, (int(rng.randint(lo, hi)),)).astype(np.int64)
            for _ in range(n)]


def _make_model(pkg=tp):
    if pkg is tp:
        from paddle_tpu_torch.models.gpt2 import GPT2Config, GPT2ForCausalLM
    else:
        from paddle_tpu.models.gpt2 import GPT2Config, GPT2ForCausalLM
    pkg.seed(0)
    cfg = GPT2Config.tiny(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                          max_position_embeddings=64)
    model = GPT2ForCausalLM(cfg)
    opt = pkg.optimizer.AdamW(learning_rate=1e-3,
                              parameters=model.parameters())

    def step(x, y):
        _, loss = model(x, labels=y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return model, step


def test_bucket_lengths_are_pow2_capped():
    for pkg in (tio, jio):
        c = pkg.BucketCollate(floor=16, max_len=48)
        assert [c.bucket_length(n) for n in (3, 16, 17, 40)] == \
            [16, 16, 32, 48]
        assert pkg.BucketCollate(floor=8).bucket_length(100) == 128


@pytest.mark.parametrize("make_labels", [True, False])
def test_bucket_collate_matches_the_reference(make_labels):
    data = _mixed_length_data(n=4, seed=2)
    got = tio.BucketCollate(floor=16, max_len=64, make_labels=make_labels)(
        [tp.to_tensor(d) for d in data[:2]] + data[2:])
    want = jio.BucketCollate(floor=16, max_len=64, make_labels=make_labels)(
        data)
    got = got if make_labels else (got,)
    want = want if make_labels else (want,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w._data))


def test_mixed_lengths_compile_once_per_bucket():
    data = _mixed_length_data()
    collate = tio.BucketCollate(floor=16, max_len=64)
    model, step = _make_model()
    static = tp.jit.to_static(step)
    batches = [data[i:i + 4] for i in range(0, len(data), 4)]
    buckets = set()
    for b in batches * 2:                      # two epochs
        ids, labels = collate(b)
        buckets.add(ids.shape[1])
        static(ids, labels)
    # one captured signature per bucket, not per distinct raw length
    assert len(static._cache) == len(buckets)
    assert all(not g.eager_only for g in static._cache.values())


def test_bucketed_loss_parity_with_fixed_padding():
    data = _mixed_length_data(n=4, lo=6, hi=30, seed=3)
    small = tio.BucketCollate(floor=16, max_len=64)
    big = tio.BucketCollate(floor=64, max_len=64)
    model, _ = _make_model()
    ids_s, lab_s = small(data)
    ids_b, lab_b = big(data)
    assert ids_s.shape[1] < ids_b.shape[1]
    _, loss_small = model(ids_s, labels=lab_s)
    _, loss_big = model(ids_b, labels=lab_b)
    np.testing.assert_allclose(float(loss_small), float(loss_big), rtol=2e-5)


def test_bucketed_training_through_dataloader():
    class _ListDataset:
        def __init__(self, items):
            self.items = items

        def __getitem__(self, i):
            return self.items[i]

        def __len__(self):
            return len(self.items)

    data = _ListDataset(_mixed_length_data(n=16, seed=5))
    collate = tio.BucketCollate(floor=32, max_len=64)
    loader = tio.DataLoader(data, batch_size=4, shuffle=False,
                            collate_fn=collate)
    model, step = _make_model()
    static = tp.jit.to_static(step)
    losses = [float(static(ids, labels)) for _ in range(6)
              for ids, labels in loader]
    assert losses[-1] < losses[0], (losses[0], losses[-1])


# ---- samplers -----------------------------------------------------------------
class _Len:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


def _sampler_orders(pkg, case):
    """The order ``case`` draws under ``np.random.seed(11)``, twice (two
    epochs)."""
    np.random.seed(11)
    ds = _Len(23)
    if case == "random":
        s = pkg.RandomSampler(ds)
    elif case == "random_replacement":
        s = pkg.RandomSampler(ds, replacement=True, num_samples=9)
    elif case == "weighted":
        s = pkg.WeightedRandomSampler(np.arange(1, 11), 12)
    elif case == "subset":
        s = pkg.SubsetRandomSampler([3, 5, 7, 11, 13])
    elif case == "batch_shuffle":
        s = pkg.BatchSampler(ds, shuffle=True, batch_size=5, drop_last=True)
    elif case == "distributed":
        s = pkg.DistributedBatchSampler(ds, 4, num_replicas=3, rank=1,
                                        shuffle=True)
        out = [list(s)]
        s.set_epoch(1)
        return out + [list(s)], len(s)
    elif case == "sequence":
        s = pkg.SequenceSampler(ds)
    return [list(s), list(s)], len(s)


@pytest.mark.parametrize("case", ["random", "random_replacement", "weighted",
                                  "subset", "batch_shuffle", "distributed",
                                  "sequence"])
def test_sampler_orders_match_the_reference(case):
    assert _sampler_orders(tio, case) == _sampler_orders(jio, case)


def test_generator_seeded_orders_within_the_port():
    """A Generator-seeded sampler: the same seed gives the same orders
    epoch by epoch, each epoch its own; ``random_split`` with a generator
    is the reference's split (it seeds numpy with ``initial_seed``)."""
    ds = _Len(40)

    def epochs(seed):
        s = tio.RandomSampler(ds, generator=tp.Generator(seed))
        return [list(s) for _ in range(3)]

    a, b = epochs(5), epochs(5)
    assert a == b and a[0] != a[1] and sorted(a[0]) == list(range(40))
    assert epochs(6) != a
    got = [list(s.indices) for s in tio.random_split(
        ds, [0.5, 0.25, 0.25], generator=tp.Generator(9))]
    want = [list(s.indices) for s in jio.random_split(
        ds, [0.5, 0.25, 0.25], generator=pt.Generator(9))]
    assert got == want


def test_distributed_batch_sampler_default_ranks_wait_for_m12():
    with pytest.raises(NotImplementedError, match="M12"):
        tio.DistributedBatchSampler(_Len(8), 2)


# ---- collate and the three loaders ------------------------------------------------
def _samples(pkg, kind):
    rng = np.random.RandomState(4)
    if kind == "tensor":
        return [pkg.to_tensor(rng.rand(3).astype(np.float32))
                for _ in range(4)]
    if kind == "ndarray":
        return [rng.rand(2, 2).astype(np.float32) for _ in range(4)]
    if kind == "int":
        return [1, 2, 3]
    if kind == "float":
        return [0.5, 1.5]
    if kind == "tuple":
        return [(rng.rand(2).astype(np.float32), i) for i in range(3)]
    if kind == "dict":
        return [{"x": rng.rand(2).astype(np.float32), "y": float(i),
                 "s": f"s{i}"} for i in range(3)]
    return [b"a", b"b"]


@pytest.mark.parametrize("kind", ["tensor", "ndarray", "int", "float",
                                  "tuple", "dict", "bytes"])
def test_default_collate_fn_trees(kind):
    got = _tree(tio.default_collate_fn(_samples(tp, kind)))
    want = _tree(jio.default_collate_fn(_samples(pt, kind)))
    _same_tree(got, want)


class _DictDataset:
    """A map-style dataset of numpy samples (what forked workers may read)."""

    def __init__(self, n=20):
        rng = np.random.RandomState(8)
        self.x = rng.rand(n, 3).astype(np.float32)
        self.y = rng.randint(0, 5, n)

    def __getitem__(self, i):
        return {"x": self.x[i], "y": int(self.y[i])}

    def __len__(self):
        return len(self.x)


@pytest.mark.parametrize("engine,workers", [
    ("python", 0), ("python", 2), ("native", 2)])
def test_loaders_give_the_reference_batches(engine, workers):
    """Sync, forked workers and the native engine, each with a fixed
    shuffled batch sampler, batch for batch the reference's sync
    loader's."""
    if engine == "native" and not available():
        pytest.skip("no C++ toolchain for the native engine")
    xs, ys = _data(n=30)
    order = np.random.RandomState(2).permutation(30).tolist()
    batches = [order[i:i + 8] for i in range(0, 30, 8)]
    if engine == "native":
        ds = tio.TensorDataset([xs, ys])
        jds = jio.TensorDataset([xs, ys])
    else:
        ds = jds = _DictDataset(30)
    got = [_tree(b) for b in tio.DataLoader(
        ds, batch_sampler=batches, num_workers=workers, engine=engine)]
    want = [_tree(b) for b in jio.DataLoader(jds, batch_sampler=batches)]
    _same_tree(got, want)


def test_workers_collate_on_the_cpu_and_their_errors_fail_the_loop():
    """A worker runs on the CPU place: what it collates it ships as host
    arrays, and the parent's batches are on the parent's place.  A worker
    error fails the iteration; nothing falls back to the sync path."""
    class Bad(tio.Dataset):
        def __getitem__(self, i):
            raise ValueError("boom")

        def __len__(self):
            return 4

    with pytest.raises(RuntimeError, match="worker failed"):
        list(tio.DataLoader(Bad(), batch_size=2, num_workers=2,
                            engine="python"))

    class Place(tio.Dataset):
        def __getitem__(self, i):
            return tp.to_tensor(np.full(2, i, np.float32)).place.is_cpu_place()

        def __len__(self):
            return 4

    out = list(tio.DataLoader(Place(), batch_size=2, num_workers=2,
                              engine="python"))
    assert [b.numpy().tolist() for b in out] == [[True, True]] * 2


# ---- save / load --------------------------------------------------------------
def _bits(buf):
    b = buf.detach().contiguous().reshape(-1)
    return b.view(torch.uint8).numpy().tobytes() if b.numel() else b""


def test_save_load_round_trip_is_bitwise(tmp_path):
    rng = np.random.RandomState(0)
    sd = {"w": tp.Parameter(rng.randn(4, 3).astype(np.float32), name="w0"),
          "h": tp.to_tensor(rng.randn(5).astype(np.float32)).astype(
              "bfloat16"),
          "q": tp.to_tensor(rng.randint(-127, 128, 6).astype(np.int8)),
          "i": tp.to_tensor(np.arange(3)),
          "nested": [tp.to_tensor(np.float32(2.5)), {"k": 3, "s": "x"}],
          "arr": np.arange(4.0), "tup": (1, 2)}
    path = str(tmp_path / "sub" / "ck.pdparams")
    tp.save(sd, path)
    with open(path, "rb") as f:
        assert f.read(6) == b"PTPU1\n"
    got = tp.load(path)
    for k in ("w", "h", "q", "i"):
        assert got[k].dtype == sd[k].dtype and got[k].shape == sd[k].shape
        assert _bits(got[k]._data) == _bits(sd[k]._data), k
        assert got[k].place.is_cpu_place()
    assert isinstance(got["w"], tp.Parameter) and got["w"].name == "w0"
    assert got["w"].persistable and not got["w"].stop_gradient
    assert not isinstance(got["h"], tp.Parameter)
    assert got["nested"][0].shape == []        # 0-d stays 0-d
    assert float(got["nested"][0]) == 2.5 and got["nested"][1] == {
        "k": 3, "s": "x"}
    np.testing.assert_array_equal(got["arr"], np.arange(4.0))
    assert type(got["arr"]) is np.ndarray and got["tup"] == (1, 2)
    raw = tp.load(path, return_numpy=True)
    assert raw["h"].dtype == np.float32
    np.testing.assert_array_equal(raw["h"], sd["h"].numpy())
    np.testing.assert_array_equal(raw["q"], sd["q"].numpy())


def test_layer_and_optimizer_state_round_trip(tmp_path):
    """A bf16 model's state dict and its AdamW state after a step: a fresh
    model and optimizer loaded from them take the next step bitwise the
    saving pair's."""
    from paddle_tpu_torch.models.gpt2 import GPT2Config, GPT2ForCausalLM
    ids = np.random.RandomState(1).randint(0, 256, (2, 17))
    x, y = tp.to_tensor(ids[:, :-1]), tp.to_tensor(ids[:, 1:])

    def pair(seed):
        tp.seed(seed)
        m = GPT2ForCausalLM(GPT2Config.tiny(hidden_dropout_prob=0.0,
                                            attention_dropout_prob=0.0))
        m.to(dtype="bfloat16")
        return m, tp.optimizer.AdamW(1e-3, parameters=m.parameters(),
                                     weight_decay=0.01)

    def step(m, o):
        _, loss = m(x, labels=y)
        loss.backward()
        o.step()
        o.clear_grad()
        return float(loss)

    a, oa = pair(0)
    step(a, oa)
    tp.save(a.state_dict(), str(tmp_path / "m.pdparams"))
    tp.save(oa.state_dict(), str(tmp_path / "m.pdopt"))
    b, ob = pair(1)
    assert b.set_state_dict(tp.load(str(tmp_path / "m.pdparams"))) == ([], [])
    ob.set_state_dict(tp.load(str(tmp_path / "m.pdopt")))
    assert step(a, oa) == step(b, ob)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p._data, q._data), n


_READER = r"""
import builtins, json, sys
real = builtins.__import__
def guard(name, *a, **k):
    if name.split(".")[0] in ("ml_dtypes", "jax", "paddle_tpu"):
        raise ImportError(f"{name} is blocked here")
    return real(name, *a, **k)
builtins.__import__ = guard
import torch
import paddle_tpu_torch as tp
from paddle_tpu_torch.models.gpt2 import GPT2Config, GPT2ForCausalLM
tp.set_device("cpu")
out = {}
for tag in ("pdparams", "pdopt", "pdextra"):
    obj = tp.load(sys.argv[1] + "." + tag)
    for k, v in obj.items():
        if isinstance(v, tp.Tensor):
            b = v._data.detach().contiguous().reshape(-1)
            out[tag + ":" + k] = [str(v.dtype), list(v.shape),
                                  b.view(torch.uint8).numpy().tobytes().hex(),
                                  isinstance(v, tp.Parameter), v.name]
        else:
            out[tag + ":" + k] = repr(v)
tp.seed(3)
m = GPT2ForCausalLM(GPT2Config.tiny())
m.to(dtype="bfloat16")
out["set_state_dict"] = [list(x) for x in
                         m.set_state_dict(tp.load(sys.argv[1] + ".pdparams"))]
out["loaded"] = sorted(n for n in sys.modules if n.split(".")[0] in
                       ("ml_dtypes", "jax", "paddle_tpu"))
print(json.dumps(out))
"""


def test_reference_checkpoint_loads_bit_for_bit_without_ml_dtypes(tmp_path):
    """The JAX package saves a tiny bf16 GPT-2's state dict and its AdamW
    state after one step; a process that cannot import ``ml_dtypes``, JAX
    or ``paddle_tpu`` loads both through the port: every tensor's dtype,
    shape, bits, Parameter flag and name are the reference's, and the
    state dict loads into the port's model."""
    from paddle_tpu.models.gpt2 import GPT2Config, GPT2ForCausalLM
    pt.seed(0)
    m = GPT2ForCausalLM(GPT2Config.tiny())
    m.to(dtype="bfloat16")
    opt = pt.optimizer.AdamW(1e-3, parameters=m.parameters(),
                             weight_decay=0.01)
    ids = np.random.RandomState(1).randint(0, 256, (2, 17))
    _, loss = m(pt.to_tensor(ids[:, :-1]), labels=pt.to_tensor(ids[:, 1:]))
    loss.backward()
    opt.step()
    base = str(tmp_path / "ref")
    sds = {"pdparams": m.state_dict(), "pdopt": opt.state_dict(),
           "pdextra": {"q": pt.to_tensor(np.arange(-4, 4, dtype=np.int8)),
                       "i64": np.arange(5, dtype=np.int64),
                       "p": pt.Parameter(np.ones((2, 2), np.float32),
                                         name="extra_p")}}
    for tag, sd in sds.items():
        pt.save(sd, f"{base}.{tag}")
    r = subprocess.run([sys.executable, "-c", _READER, base], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got.pop("loaded") == []
    assert got.pop("set_state_dict") == [[], []]
    dtypes = set()
    for tag, sd in sds.items():
        for k, v in sd.items():
            g = got.pop(f"{tag}:{k}")
            if not isinstance(v, pt.Tensor):
                assert g == repr(v), k
                continue
            a = np.asarray(v._data, order="C")
            dtypes.add(str(a.dtype))
            assert g[0] == f"torch.{a.dtype}", (k, g[0], a.dtype)
            assert g[1] == list(a.shape)
            assert bytes.fromhex(g[2]) == a.tobytes(), k
            assert g[3] == isinstance(v, pt.Parameter) and g[4] == v.name
    assert not got
    assert {"bfloat16", "float32", "int32", "int8"} <= dtypes, dtypes
