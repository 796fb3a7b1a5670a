"""The 'sep' axis and sequence parallelism of the port
(``parallel/{ring_attention,ulysses,sequence_parallel}.py``) and the
differentiable ``mesh_ppermute`` against the JAX package on its CPU mesh.

Mirrors ``tests/test_distributed.py``'s ``TestRingAttention`` (:331),
``TestUlyssesAttention`` (:585) and ``TestSequenceParallel`` (:160) on 2
and 4 spawned gloo ranks (one job each), the same numpy inputs on every
rank.  As the reference's tests do, ring and Ulysses attention are held to
the reference's dense attention ``_sdpa_ref`` at its bars (rtol 2e-4, atol
2e-5), and their gradients of sum(out * out) to ``jax.grad`` of the same
function of ``_sdpa_ref`` at 5e-4 (the reference checks only that they
are finite; its own ring's gradient takes minutes of eager ``shard_map`` on
the CPU), grouped K / V too; the sequence-parallel linear pair to the
reference's layers on its mesh.  ``mesh_ppermute``'s value and gradient of
sum(w * ppermute(x)) equal ``jax.lax.ppermute``'s and ``jax.grad``'s under
``shard_map`` for a ring, a partial permutation (an index no one sends to
gets zeros) and a shift by two."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as pt
from paddle_tpu.distributed.fleet.topology import (
    CommunicateTopology, HybridCommunicateGroup, set_hybrid_communicate_group)
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import device as tdevice

import _torch_dist
from _torch_copies import differing_units, statement

OUT = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=5e-4, atol=5e-4)
WORLDS = (2, 4)
NAMES = ["dp", "pp", "sharding", "sep", "mp", "ep"]


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    """The CPU, and one torch thread as the spawned ranks have: the tiny
    models gain nothing from more, and the suite's workers share the
    cores."""
    prev, threads = tdevice._current_device, torch.get_num_threads()
    tp.set_device("cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    tdevice._current_device = prev
    _set_hcg()


def _set_hcg(**dims):
    d = [dims.get(n, 1) for n in NAMES]
    set_hybrid_communicate_group(HybridCommunicateGroup(
        CommunicateTopology(NAMES, d), rank=0))


def _arrays(world):
    rng = np.random.RandomState(world)
    B, S, H, D = 1, 32, 4, 8
    a = {n: rng.rand(B, S, H, D).astype(np.float32) for n in ("q", "k", "v")}
    a["kq"] = rng.rand(B, S, 2, D).astype(np.float32)
    a["odd"] = rng.rand(B, S, 2 * world - 1, D).astype(np.float32)
    a["perm_x"] = rng.rand(world, 4).astype(np.float32)
    a["perm_w"] = rng.rand(world, 4).astype(np.float32)
    a["x_sp"] = rng.rand(2, 8, 16).astype(np.float32)
    return a


def _perms(world):
    return {"ring": [(i, (i + 1) % world) for i in range(world)],
            "partial": [(i, i + 1) for i in range(world - 1)],
            "shift2": [(i, (i + 2) % world) for i in range(world)]}


def _attn_ref(a, b, c, causal):
    """The reference's dense attention and jax.grad of sum(out * out)."""
    from paddle_tpu.nn.functional.attention import _sdpa_ref

    def f(q, k, v):
        o = _sdpa_ref(q, k, v, causal=causal)
        return jnp.sum(o * o), o
    (_, o), g = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2),
                                           has_aux=True))(
        *(jnp.asarray(t) for t in (a, b, c)))
    return np.asarray(o), [np.asarray(t) for t in g]


def _sp_layers():
    from paddle_tpu.parallel import (ColumnSequenceParallelLinear,
                                     RowSequenceParallelLinear)
    pt.seed(5)
    return (ColumnSequenceParallelLinear(16, 64),
            RowSequenceParallelLinear(64, 16))


def _reference(world, a):
    """The JAX package's functions (dense attention, ppermute under
    shard_map on its CPU mesh, the SP pair at mp = world)."""
    from paddle_tpu.parallel._compat import shard_map
    from paddle_tpu.distributed.collective import mesh_ppermute
    from paddle_tpu.parallel.sequence_parallel import scatter, all_gather
    from jax.sharding import Mesh, PartitionSpec as P
    ref = {}
    for causal in (False, True):
        ref[causal] = _attn_ref(a["q"], a["k"], a["v"], causal)
    ref["gqa"] = _attn_ref(a["q"], a["kq"], a["kq"], True)
    mesh = Mesh(np.array(jax.devices()[:world]), ("mp",))
    for name, perm in _perms(world).items():
        def body(xl, wl, perm=perm):
            return jnp.sum(wl * mesh_ppermute(xl, "mp", perm))[None]

        def loss(x, w, body=body):
            return shard_map(body, mesh=mesh, in_specs=(P("mp"), P("mp")),
                             out_specs=P("mp"), check_vma=False)(x, w).sum()
        val = shard_map(lambda xl, perm=perm: mesh_ppermute(xl, "mp", perm),
                        mesh=mesh, in_specs=(P("mp"),), out_specs=P("mp"),
                        check_vma=False)(jnp.asarray(a["perm_x"]))
        g = jax.grad(loss)(jnp.asarray(a["perm_x"]), jnp.asarray(a["perm_w"]))
        ref[("ppermute", name)] = (np.asarray(val), np.asarray(g))
    _set_hcg(mp=world)
    try:
        col, row = _sp_layers()
        xt = pt.to_tensor(a["x_sp"], stop_gradient=False)
        o = all_gather(row(col(scatter(xt))))
        (o * o).sum().backward()
        ref["sp"] = tuple(np.asarray(t.numpy()) for t in
                          (o, xt.grad, col.weight.grad, row.weight.grad))
    finally:
        _set_hcg()
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    arrays = {w: _arrays(w) for w in WORLDS}
    col, row = _sp_layers()        # the SP weights: the reference's seeded
    for a in arrays.values():
        a["col"] = {k: np.asarray(v.numpy()) for k, v in
                    col.state_dict().items()}
        a["row"] = {k: np.asarray(v.numpy()) for k, v in
                    row.state_dict().items()}
    jobs = {w: _torch_dist.start("sequence_parallel_cases", w,
                                 tmp_path_factory.mktemp(f"sep{w}"),
                                 arrays[w], timeout=240) for w in WORLDS}
    # the references run while the ranks do
    refs = {w: _reference(w, arrays[w]) for w in WORLDS}
    return refs, {w: jobs[w].results() for w in WORLDS}, arrays


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_matches_dense_attention_and_its_gradients(runs, world, kind, causal):
    refs, got, _ = runs
    want_o, want_g = refs[world][causal]
    for r in range(world):
        o, g = got[world][r][(kind, causal)]
        np.testing.assert_allclose(o, want_o, **OUT)
        for a, b in zip(g, want_g):
            np.testing.assert_allclose(a, b, **GRAD)
            assert np.isfinite(a).all()


@pytest.mark.parametrize("world", WORLDS)
def test_ring_takes_grouped_kv(runs, world):
    refs, got, _ = runs
    want_o, want_g = refs[world]["gqa"]
    for r in range(world):
        o, g = got[world][r]["ring_gqa"]
        np.testing.assert_allclose(o, want_o, **OUT)
        for a, b in zip(g, want_g):
            np.testing.assert_allclose(a, b, **GRAD)


@pytest.mark.parametrize("world", WORLDS)
def test_ulysses_head_divisibility_enforced(runs, world):
    _, got, _ = runs
    for r in range(world):
        assert "divisible" in got[world][r]["divisible"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("perm", ["ring", "partial", "shift2"])
def test_mesh_ppermute_gradient_is_jax_ppermute_s(runs, world, perm):
    refs, got, _ = runs
    want_v, want_g = refs[world][("ppermute", perm)]
    for r in range(world):
        v, g = got[world][r][("ppermute", perm)]
        np.testing.assert_allclose(v, want_v[r], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(g, want_g[r], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("world", WORLDS)
def test_sp_linear_pair(runs, world):
    refs, got, arrays = runs
    a = arrays[world]
    col, row = a["col"], a["row"]
    dense = (a["x_sp"] @ col["weight"] + col["bias"]) @ row["weight"] + \
        row["bias"]
    for r in range(world):
        o, gx, gc, gr = got[world][r]["sp"]
        np.testing.assert_allclose(o, refs[world]["sp"][0], **OUT)
        np.testing.assert_allclose(o, dense, rtol=1e-4, atol=1e-5)
        for x, y in zip((gx, gc, gr), refs[world]["sp"][1:]):
            np.testing.assert_allclose(x, y, **GRAD)


def test_single_rank_falls_back_to_dense_attention():
    """Without a 'sep' group both functions are dense attention (the
    reference's ``test_single_device_fallback``)."""
    from paddle_tpu_torch.parallel import (ring_flash_attention,
                                           ulysses_attention)
    from paddle_tpu_torch.nn.functional.attention import _sdpa_ref
    q = np.random.RandomState(1).rand(1, 16, 4, 8).astype(np.float32)
    want = _sdpa_ref(*(torch.tensor(q),) * 3, causal=True).numpy()
    for fn in (ring_flash_attention, ulysses_attention):
        out = fn(*(tp.to_tensor(q),) * 3, causal=True)
        assert out.shape == [1, 16, 4, 8]
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-6)


def test_single_rank_takes_the_flash_path(monkeypatch):
    """Without a 'sep' group, a shape the kernels take goes through the
    flash wrapper (K1-K3 on the card, their plain twins here), not the
    dense attention, and agrees with the reference's dense attention and
    ``jax.grad`` of it."""
    from paddle_tpu_torch.nn.functional import attention as tattn
    from paddle_tpu_torch.parallel import (ring_flash_attention,
                                           ulysses_attention)
    calls = []
    flash = tattn.flash_attention_bshd
    monkeypatch.setattr(tattn, "flash_attention_bshd",
                        lambda *a, **k: calls.append(1) or flash(*a, **k))
    rng = np.random.RandomState(2)
    q, k, v = (rng.rand(1, 128, 2, 64).astype(np.float32) for _ in range(3))
    want_o, want_g = _attn_ref(q, k, v, True)
    for fn in (ring_flash_attention, ulysses_attention):
        ts = [tp.to_tensor(t, stop_gradient=False) for t in (q, k, v)]
        out = fn(*ts, causal=True)
        (out * out).sum().backward()
        np.testing.assert_allclose(out.numpy(), want_o, **OUT)
        for t, g in zip(ts, want_g):
            np.testing.assert_allclose(t.grad.numpy(), g, **GRAD)
    assert len(calls) == 2


# the units that differ from the reference's, each for a reason:
DIVERGENT = {
    "parallel/sequence_parallel.py": {
        "__doc__", statement("import jax"),
        statement("from jax.sharding import NamedSharding, "
                  "PartitionSpec as P"),
        statement("from ._compat import P"),
        # DTensor placements in place of GSPMD's partitioner
        "register_sequence_parallel_allreduce_hooks",
    },
}


@pytest.mark.parametrize("path", sorted(DIVERGENT))
def test_copy_matches_the_reference(path):
    assert differing_units(path) == DIVERGENT[path]
