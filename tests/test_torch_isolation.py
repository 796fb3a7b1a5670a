"""The PyTorch port stands alone: nothing under ``paddle_tpu_torch/`` or in
``chip_smoke.py`` imports JAX or the JAX package; its entry points run on
the card unless the caller asks for the CPU, and raise without CUDA; the
options whose kernels are ported (int8 pages, speculative decoding, the
training forward) run, and those whose kernels or modules are not ported
yet are refused, not run some other way."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.inference.engine import ModelRunner
from paddle_tpu_torch.inference.serving import (DisaggEngine, LLMEngine,
                                                SpecConfig)
from paddle_tpu_torch.models.gpt2_module import GPT2ForCausalLM
from paddle_tpu_torch.models.llama_module import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.flash_attention import flash_attention_bshd
from paddle_tpu_torch.ops.paged_attention import paged_attention
from paddle_tpu_torch.ops.quant_matmul import quant_matmul
from paddle_tpu_torch.quantization import weight_only_linear

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "paddle_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"] + sorted((REPO / "tools").glob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu", "ml_dtypes")


def _imported_roots(path):
    """Top-level package of every absolute import in ``path``."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_files_import_no_jax_and_nothing_of_the_jax_package():
    assert len(PORT_FILES) > 20
    # autocast and train-step capture, and M2's rest, are among them
    port = REPO / "paddle_tpu_torch"
    assert {port / "amp" / "__init__.py", port / "jit" / "to_static.py",
            port / "jit" / "__init__.py", port / "models" / "ernie.py",
            port / "nn" / "utils" / "__init__.py"} | {
        port / "ops" / f"{m}.py" for m in ("search", "stat", "random",
                                            "linalg", "einsum_op")} | {
        port / "nn" / kind / f"{m}.py" for kind in ("layer", "functional")
        for m in ("conv", "pooling")} | {
        port / "nn" / "layer" / "transformer.py",
        port / "nn" / "functional" / "rope.py"} | {
        # the Layer Llama (M7b), the torch.nn Llama, and M2's rest
        port / "models" / "llama.py", port / "models" / "llama_module.py",
        port / "nn" / "layer" / "rnn.py", port / "nn" / "layer" / "extras.py",
        port / "nn" / "functional" / "extras.py",
        port / "nn" / "functional" / "extra_losses.py",
        port / "framework" / "__init__.py",
        port / "framework" / "compat.py", port / "version.py"} | {
        port / "ops" / f"{m}_extra.py" for m in ("math", "manip", "linalg")
    } | {
        # quantization (M10) and the training workflow around it
        port / "quantization" / f"{m}.py" for m in (
            "__init__", "base", "config", "observers", "quanters",
            "qat_layers", "quantize")} | {
        port / "nn" / "quant" / "__init__.py",
        port / "framework" / "io.py", port / "io" / "__init__.py",
        port / "io" / "native_loader.py", port / "metric" / "__init__.py",
        port / "hapi" / "__init__.py", port / "hapi" / "callbacks.py",
        port / "hapi" / "model.py", REPO / "tools" / "workflow_phase.py",
    } | {
        # distributed and parallel (M12 part 1)
        port / "distributed" / f"{m}.py" for m in (
            "__init__", "env", "collective", "parallel", "mesh_utils",
            "staged")} | {
        port / "distributed" / "auto_parallel" / f"{m}.py"
        for m in ("__init__", "api", "placement")} | {
        port / "distributed" / "fleet" / f"{m}.py"
        for m in ("__init__", "topology", "recompute", "hybrid_optimizer")} | {
        port / "distributed" / "fleet" / "utils" / "timer_helper.py",
        port / "distributed" / "launch" / "main.py",
        port / "distributed" / "sharding" / "__init__.py",
        port / "core" / "sharding.py", port / "_unported.py",
        REPO / "tools" / "hybrid_phase.py"} | {
        port / "parallel" / f"{m}.py" for m in (
            "__init__", "_compat", "mp_layers", "tensor_parallel", "moe",
            "sharding")
    } <= set(PORT_FILES)
    bad = {str(p.relative_to(REPO)): sorted(_imported_roots(p)
                                            & set(FORBIDDEN))
           for p in PORT_FILES}
    assert not {k: v for k, v in bad.items() if v}


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import paddle_tpu_torch.inference.serving\n"
            "import paddle_tpu_torch.inference.engine.disagg\n"
            "import paddle_tpu_torch.jit\n"
            "import paddle_tpu_torch.jit.to_static\n"
            "import paddle_tpu_torch.amp\n"
            "import paddle_tpu_torch.models.convert\n"
            "import paddle_tpu_torch.models.gpt2\n"
            "import paddle_tpu_torch.models.gpt2_module\n"
            "import paddle_tpu_torch.nn.layer\n"
            "import paddle_tpu_torch.optimizer.lr\n"
            "import paddle_tpu_torch.nn\n"
            "import paddle_tpu_torch.optimizer\n"
            "import paddle_tpu_torch.observability\n"
            "import paddle_tpu_torch.testing\n"
            "import paddle_tpu_torch.core.flags\n"
            "import paddle_tpu_torch.quantization\n"
            "import paddle_tpu_torch.nn.quant\n"
            "import paddle_tpu_torch.ops.quant_matmul\n"
            "import paddle_tpu_torch.inference.frontend\n"
            "import paddle_tpu_torch.distributed.store\n"
            "import paddle_tpu_torch.distributed.membership\n"
            "import paddle_tpu_torch.core.native.build\n"
            "import paddle_tpu_torch.autograd.functional\n"
            "import paddle_tpu_torch.device\n"
            "import paddle_tpu_torch.nn.functional.attention\n"
            "import paddle_tpu_torch.ops.search\n"
            "import paddle_tpu_torch.ops.stat\n"
            "import paddle_tpu_torch.ops.random\n"
            "import paddle_tpu_torch.ops.linalg\n"
            "import paddle_tpu_torch.ops.einsum_op\n"
            "import paddle_tpu_torch.nn.layer.transformer\n"
            "import paddle_tpu_torch.nn.layer.conv\n"
            "import paddle_tpu_torch.nn.layer.pooling\n"
            "import paddle_tpu_torch.nn.functional.conv\n"
            "import paddle_tpu_torch.nn.functional.pooling\n"
            "import paddle_tpu_torch.nn.functional.rope\n"
            "import paddle_tpu_torch.nn.utils\n"
            "import paddle_tpu_torch.models.ernie\n"
            "import paddle_tpu_torch.models.llama\n"
            "import paddle_tpu_torch.models.llama_module\n"
            "import paddle_tpu_torch.nn.layer.rnn\n"
            "import paddle_tpu_torch.nn.layer.extras\n"
            "import paddle_tpu_torch.nn.functional.extras\n"
            "import paddle_tpu_torch.nn.functional.extra_losses\n"
            "import paddle_tpu_torch.ops.math_extra\n"
            "import paddle_tpu_torch.ops.manip_extra\n"
            "import paddle_tpu_torch.ops.linalg_extra\n"
            "import paddle_tpu_torch.framework\n"
            "import paddle_tpu_torch.framework.compat\n"
            "import paddle_tpu_torch.version\n"
            "import paddle_tpu_torch.framework.io\n"
            "import paddle_tpu_torch.io\n"
            "import paddle_tpu_torch.io.native_loader\n"
            "import paddle_tpu_torch.metric\n"
            "import paddle_tpu_torch.hapi\n"
            "import paddle_tpu_torch.hapi.callbacks\n"
            "import paddle_tpu_torch.quantization.quantize\n"
            "import paddle_tpu_torch.quantization.observers\n"
            "import paddle_tpu_torch.distributed\n"
            "import paddle_tpu_torch.distributed.fleet\n"
            "import paddle_tpu_torch.distributed.fleet.utils\n"
            "import paddle_tpu_torch.distributed.fleet.layers.mpu\n"
            "import paddle_tpu_torch.distributed.fleet.meta_parallel\n"
            "import paddle_tpu_torch.distributed.launch.main\n"
            "import paddle_tpu_torch.distributed.staged\n"
            "import paddle_tpu_torch.distributed.sharding\n"
            "import paddle_tpu_torch.parallel\n"
            "import paddle_tpu_torch.parallel.moe\n"
            "import paddle_tpu_torch as tp\n"
            "tp.Model, tp.summary, tp.flops, tp.save, tp.load\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_worker_entry_loads_no_jax():
    """``python -m paddle_tpu_torch.inference.frontend.worker`` in a fresh
    process, with everything it imports (store, membership, RPC, replica,
    disagg) and the port's engine: its engine-spec hook exits 0 only when
    neither JAX nor the JAX package is in ``sys.modules``."""
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.inference.frontend.worker",
         "--engine-spec",
         f"{REPO / 'tests' / '_torch_fleet_worker_spec.py'}"
         ":exit_if_jax_loaded",
         "--name", "iso", "--store-port", "1"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    assert "forbidden modules: []" in r.stdout


def _sibling_imports(pkg):
    """{module: the sibling modules it imports} of one package directory,
    lazy imports inside functions included."""
    deps = {}
    for path in sorted(pkg.glob("*.py")):
        sibs = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level == 1:
                if node.module:
                    sibs.add(node.module.split(".")[0])
                else:
                    sibs.update(a.name for a in node.names)
        deps[path.stem] = sibs - {path.stem}
    return deps


def _cycle(deps):
    """One import cycle of ``deps`` as a list of modules, or None."""
    state = {}

    def visit(mod, stack):
        state[mod] = "visiting"
        for dep in sorted(deps.get(mod, ())):
            if dep not in deps:
                continue
            if state.get(dep) == "visiting":
                return stack[stack.index(dep):] + [dep]
            if dep not in state:
                found = visit(dep, stack + [dep])
                if found:
                    return found
        state[mod] = "done"
        return None

    for mod in sorted(deps):
        if mod not in state:
            found = visit(mod, [mod])
            if found:
                return found
    return None


@pytest.mark.parametrize("package", ["engine", "frontend"])
def test_serving_packages_have_no_import_cycles(package):
    """The port's mirror of the JAX package's engine layering guard
    (``tests/test_analysis.py``, ``test_engine_package_has_no_import_cycles``),
    for the engine and the front door: acyclic, and the engine's
    ``request`` imports no sibling."""
    deps = _sibling_imports(REPO / "paddle_tpu_torch" / "inference" / package)
    assert len(deps) > 5
    if package == "engine":
        assert deps["request"] == set()
    assert _cycle(deps) is None


@pytest.fixture
def no_cuda(monkeypatch):
    """This machine as a caller without a card sees it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def model():
    return LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                            generator=torch.Generator().manual_seed(0))


def test_entry_points_default_to_the_card_and_raise_without_it(no_cuda,
                                                               model):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LLMEngine(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelRunner(model, n_pages=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LlamaForCausalLM(LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GPT2ForCausalLM()
    # a (fake) CUDA tensor without a card: the wrapper refuses to launch,
    # and never computes its plain version instead
    with FakeTensorMode():
        q = torch.empty(1, 128, 2, 64, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            flash_attention_bshd(q, q, q)
    assert flash_attention_bshd.launches_fwd == 0
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_weight_only_matmul_raises_without_a_card(no_cuda):
    """K8's route on a (fake) CUDA tensor without a card: ``quant_matmul``
    and ``weight_only_linear`` refuse to launch, and the latter does not
    run the dequant formulation instead."""
    with FakeTensorMode():
        x = torch.empty(8, 256, dtype=torch.bfloat16, device="cuda")
        qw = torch.empty(256, 256, dtype=torch.int8, device="cuda")
        q4 = torch.empty(128, 256, dtype=torch.int8, device="cuda")
        s = torch.empty(256, dtype=torch.float32, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            quant_matmul(x, qw, s)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            weight_only_linear(x, qw, weight_scale=s)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            weight_only_linear(x, q4, weight_scale=s, weight_dtype="int4")
    assert quant_matmul.launches == quant_matmul.launches_int4 == 0


def test_paged_attention_takes_only_cpu_or_cuda_tensors():
    q = torch.empty(1, 4, 64, device="meta")
    kp = torch.empty(2, 8, 2, 64, device="meta")
    bt = torch.zeros(1, 1, dtype=torch.int32, device="meta")
    cl = torch.ones(1, dtype=torch.int32, device="meta")
    before = paged_attention.launches
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        paged_attention(q, kp, kp, bt, cl)
    assert paged_attention.launches == before


# LLMEngine's mesh, then DisaggEngine's mesh knobs
@pytest.mark.parametrize("knob,value,what", [
    ("mesh", object(), "multi-device serving .* M12 part 3"),
    ("prefill_mesh", object(), "multi-device serving .* M12 part 3"),
    ("decode_mesh", object(), "multi-device serving .* M12 part 3"),
    ("prefill_meshes", [object()], "multi-device serving .* M12 part 3"),
    ("decode_meshes", [object()], "multi-device serving .* M12 part 3"),
    ("mp_axis", "mp", "multi-device serving .* M12 part 3"),
    ("pp_axis", "pp", "multi-device serving .* M12 part 3"),
])
def test_unported_options_are_refused(model, knob, value, what):
    engine = LLMEngine if knob == "mesh" else DisaggEngine
    with pytest.raises(NotImplementedError, match=what):
        engine(model, device="cpu", **{knob: value})


def test_unported_runner_paths_are_refused():
    """The training forward now goes through the flash wrapper, which takes
    only CPU or CUDA tensors (a meta tensor is refused there, not computed
    some other way); the MoE variant is still refused."""
    meta = LlamaForCausalLM(LlamaConfig.tiny(
        hidden_size=256, num_attention_heads=2, num_key_value_heads=1),
        device="cpu").to("meta")                 # head_dim 128: the kernels'
    before = flash_attention_bshd.launches_fwd
    with pytest.raises(ValueError, match="cuda or cpu"):
        meta(torch.zeros(1, 128, dtype=torch.long, device="meta"))
    assert flash_attention_bshd.launches_fwd == before
    with pytest.raises(NotImplementedError, match="MoE"):
        LlamaForCausalLM(LlamaConfig.tiny_moe(), device="cpu")


@pytest.mark.parametrize("case", ["kv_cache_dtype_int8", "spec_decode",
                                  "run_verify"])
def test_ported_options_serve_on_the_cpu(model, case):
    """What was refused until its kernel was ported now serves: an int8-page
    engine (K6), a speculative engine (K7), and the runner's verify step,
    each on the CPU through the kernels' plain versions."""
    if case == "run_verify":
        runner = ModelRunner(model, max_batch=2, page_size=8, n_pages=8,
                             device="cpu")
        tables = np.zeros((2, 4), np.int32)
        ones = np.ones(2, np.int32)
        toks = runner.run_verify(
            4, np.ones((2, 4), np.int32), np.asarray([3, 0], np.int32),
            tables, np.asarray([3, 0], np.int32), ones,
            np.ones(2, np.float32), np.ones(2, np.float32),
            np.zeros(2, np.int32), np.zeros(2, np.int32),
            np.zeros(2, np.int32))
        assert toks.shape == (2, 4) and toks.dtype == np.int32
        assert runner.has_verify_program(4)
        return
    knob = ({"kv_cache_dtype": "int8"} if case == "kv_cache_dtype_int8"
            else {"spec_decode": SpecConfig(max_draft=2)})
    eng = LLMEngine(model, device="cpu", max_batch=2, max_len=32,
                    page_size=8, **knob)
    rid = eng.add_request([5, 6, 7, 5, 6, 7, 5, 6], max_new_tokens=6)
    eng.run_until_done()
    assert len(eng.result(rid)) == 6


def test_creation_needs_the_card_or_an_explicit_cpu(no_cuda):
    """The default place is the card: without CUDA, ``to_tensor`` with no
    place raises through ``resolve_device``; after ``set_device("cpu")``
    (or with ``place="cpu"``) it works, and the previous place comes
    back."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import device as core_device
    prev = core_device._current_device
    core_device._current_device = None
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            paddle.to_tensor([1.0])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            paddle.zeros([2])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            paddle.get_device()
        assert paddle.to_tensor([1.0], place="cpu").place.is_cpu_place()
        paddle.set_device("cpu")
        t = paddle.to_tensor([1.0, 2.0])
        assert t.place.is_cpu_place() and paddle.get_device() == "cpu"
        assert (t + 1).numpy().tolist() == [2.0, 3.0]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            paddle.set_device("gpu")
    finally:
        core_device._current_device = prev


def test_resolve_device_still_imports_from_the_device_package():
    from paddle_tpu_torch import device as device_pkg
    from paddle_tpu_torch.core.device import resolve_device as core_resolve
    assert resolve_device is core_resolve is device_pkg.resolve_device
    assert device_pkg.is_compiled_with_cuda()
    assert not device_pkg.is_compiled_with_xpu()


def test_enforce_is_a_copy_of_the_reference():
    """``core/enforce.py`` has no JAX in it, so the port carries a copy; its
    AST equals the reference's."""
    ref = ast.parse((REPO / "paddle_tpu" / "core" / "enforce.py").read_text())
    port = ast.parse((REPO / "paddle_tpu_torch" / "core" / "enforce.py")
                     .read_text())
    assert ast.dump(port) == ast.dump(ref)


def _unported(case):
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.models import gpt2
    cfg = dict(vocab_size=64, hidden_size=64, num_layers=1, num_heads=1,
               max_position_embeddings=16, hidden_dropout_prob=0.0,
               attention_dropout_prob=0.0)
    ids = paddle.to_tensor(np.zeros((1, 8), np.int32))
    if case == "embedding_sparse":
        nn.Embedding(8, 4, sparse=True)(ids)
    elif case == "sync_batch_norm":
        bn = nn.SyncBatchNorm(4)
        x = paddle.to_tensor(np.arange(16.0, dtype=np.float32)
                             .reshape(2, 4, 2, 1))
        ref = nn.BatchNorm2D(4)
        np.testing.assert_allclose(bn(x).numpy(), ref(x).numpy(), atol=1e-6)
        np.testing.assert_allclose(bn._mean.numpy(), ref._mean.numpy())
    elif case == "gpt2_use_recompute":
        m = gpt2.GPT2ForCausalLM(gpt2.GPT2Config(use_recompute=True, **cfg))
        m.train()
        _, loss = m(ids, labels=ids)
        loss.backward()
        assert m.gpt2.wte.weight.grad is not None


@pytest.mark.parametrize("case,what", [
    ("embedding_sparse", "SelectedRows"), ("sync_batch_norm", None),
    ("gpt2_use_recompute", None)])
def test_unported_nn_options_are_refused(case, what):
    """The options of the Layer slice whose modules are not ported yet
    refuse, naming what they wait for, and never run some other way; since
    M12's first part ``SyncBatchNorm`` (one rank: the batch norm) and GPT-2's
    ``use_recompute`` (``fleet.recompute``) run."""
    from paddle_tpu_torch.core import device as core_device
    prev = core_device._current_device
    core_device._current_device = torch.device("cpu")
    try:
        if what is None:
            _unported(case)
        else:
            with pytest.raises(NotImplementedError, match=what):
                _unported(case)
    finally:
        core_device._current_device = prev


def test_layers_and_optimizers_need_the_card_or_an_explicit_cpu(no_cuda):
    """A Layer's parameters go to the card by default: without CUDA a Layer
    (and the Layer GPT-2) raises unless the caller asked for the CPU."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.core import device as core_device
    from paddle_tpu_torch.models import gpt2
    prev = core_device._current_device
    core_device._current_device = None
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            nn.Linear(2, 2)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            gpt2.gpt2_tiny()
        paddle.set_device("cpu")
        lin = nn.Linear(2, 2)
        opt = paddle.optimizer.AdamW(parameters=lin.parameters())
        assert lin.weight.place.is_cpu_place()
        assert opt._lr_t.place.is_cpu_place()
    finally:
        core_device._current_device = prev


def _m2_entry(case):
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.models import ernie, llama
    from paddle_tpu_torch.nn.functional import rope
    if case == "llama_layer":
        llama.llama_tiny()
    elif case == "kv_cache":
        llama.KVCache(1, 8, 2, 4)
    elif case == "lstm":
        nn.LSTM(4, 4, num_layers=2, direction="bidirect")
    elif case == "gru_cell":
        nn.GRUCell(4, 4).get_initial_states(2)
    elif case == "adaptive_log_softmax":
        nn.AdaptiveLogSoftmaxWithLoss(8, 10, cutoffs=[4])
    elif case == "hsigmoid":
        nn.HSigmoidLoss(4, 8)
    elif case == "ernie":
        ernie.ErnieForMaskedLM(ernie.ErnieConfig.tiny())
    elif case == "multi_head_attention":
        nn.MultiHeadAttention(16, 2)
    elif case == "conv2d":
        nn.Conv2D(3, 4, 3)
    elif case == "spectral_norm":
        nn.SpectralNorm([4, 4])
    elif case == "rand":
        paddle.rand([4])
    elif case == "randint":
        paddle.randint(0, 5, [4])
    elif case == "rotary_sin_cos":
        rope.rotary_embedding_sin_cos(8, 4)


@pytest.mark.parametrize("case", ["ernie", "multi_head_attention", "conv2d",
                                  "spectral_norm", "rand", "randint",
                                  "rotary_sin_cos", "llama_layer", "kv_cache",
                                  "lstm", "gru_cell", "adaptive_log_softmax",
                                  "hsigmoid"])
def test_m2_entry_points_need_the_card_or_an_explicit_cpu(no_cuda, case):
    """The models, layers and random ops of M2's rest make their tensors on
    the current place: without CUDA they raise unless the caller asked for
    the CPU, and with ``set_device("cpu")`` they run there."""
    from paddle_tpu_torch.core import device as core_device
    prev = core_device._current_device
    core_device._current_device = None
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _m2_entry(case)
        core_device._current_device = torch.device("cpu")
        _m2_entry(case)
    finally:
        core_device._current_device = prev


def _refused(case):
    from paddle_tpu_torch.models import llama
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.nn.functional.attention import flash_attn_unpadded
    cfg = llama.LlamaConfig.tiny()
    if case == "llama_moe":
        m = llama.LlamaForCausalLM(llama.LlamaConfig.tiny_moe())
        assert m.llama.layers[0].mlp.num_experts == 4
    elif case == "llama_sep":
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch.distributed.fleet import topology
        m = llama.llama_tiny()
        saved = topology._hcg
        topology._hcg = topology.HybridCommunicateGroup(
            topology.CommunicateTopology(dims=[1, 1, 1, 2, 1, 1]), rank=0)
        try:
            out = m(paddle.to_tensor(np.zeros((1, 4), np.int32)))
            assert out.shape == [1, 4, cfg.vocab_size]
        finally:
            topology._hcg = saved
    elif case == "shard_llama":
        from paddle_tpu_torch.distributed.fleet import topology
        m = llama.llama_tiny()
        assert llama.shard_llama(
            m, topology.get_hybrid_communicate_group().get_mesh()) is m
    elif case == "make_decoder_stage":
        init, apply = llama.make_decoder_stage(cfg)
        p = init(torch.Generator().manual_seed(0))
        x = torch.zeros(1, 4, cfg.hidden_size)
        assert tuple(apply(p, x).shape) == (1, 4, cfg.hidden_size)
    elif case == "llama_pipe":
        assert llama.LlamaForCausalLMPipe(cfg).num_chunks == 2
    elif case == "llama_stage_pipe":
        import paddle_tpu_torch as paddle
        layer = llama.LlamaDecoderLayerPipe(cfg)
        h, aux = layer((paddle.zeros([1, 4, cfg.hidden_size]),
                        paddle.zeros([])))
        assert h.shape == [1, 4, cfg.hidden_size] and float(aux) == 0.0
    elif case == "flash_attn_varlen_qkvpacked":
        F.flash_attn_varlen_qkvpacked(None)
    elif case == "sparse_attention":
        F.sparse_attention()
    elif case == "flash_attn_unpadded":
        flash_attn_unpadded()
    elif case == "fractional_max_pool3d_mask":
        import paddle_tpu_torch as paddle
        F.fractional_max_pool3d(paddle.zeros([1, 1, 4, 4, 4]), 2,
                                return_mask=True)


@pytest.mark.parametrize("case,what", [
    ("llama_moe", None), ("llama_sep", None), ("shard_llama", None),
    ("make_decoder_stage", None), ("llama_pipe", None),
    ("llama_stage_pipe", None),
    ("flash_attn_varlen_qkvpacked", "varlen"),
    ("sparse_attention", "block-sparse"), ("flash_attn_unpadded", "varlen"),
    ("fractional_max_pool3d_mask", "return_mask")])
def test_layer_llama_and_m2_rest_refusals(case, what):
    """What the Layer Llama and M2's rest refuse, as the reference does:
    each raises, naming it, and never runs some other way.  The MoE Llama
    and ``shard_llama`` came with M12's first part and run; the sep group
    (a group of one in a single process), ``make_decoder_stage`` and the
    pipe classes with its second, and run."""
    from paddle_tpu_torch.core import device as core_device
    prev = core_device._current_device
    core_device._current_device = torch.device("cpu")
    try:
        if what is None:
            _refused(case)
        else:
            with pytest.raises(NotImplementedError, match=what):
                _refused(case)
    finally:
        core_device._current_device = prev


def _workflow_refusal(case, tmp):
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch import io
    from paddle_tpu_torch.jit import InputSpec
    if case == "distributed_batch_sampler":
        s = io.DistributedBatchSampler(io.TensorDataset([np.zeros((4, 2))]),
                                       2)
        assert (s.nranks, s.local_rank, list(s)) == (1, 0, [[0, 1], [2, 3]])
    elif case == "model_save_inference":
        paddle.Model(nn.Linear(2, 2), inputs=[InputSpec([None, 2])]).save(
            str(tmp / "m"), training=False)


@pytest.mark.parametrize("case,what", [
    ("distributed_batch_sampler", None), ("model_save_inference",
                                          "jit.save")])
def test_workflow_refusals(case, what, tmp_path):
    """What the workflow slice leaves for later: ``Model.save(training=
    False)``, which goes through ``jit.save`` (M13), raises, naming it; the
    distributed sampler's default ranks come from ``distributed``'s
    environment since M12's first part (one process: rank 0 of 1)."""
    from paddle_tpu_torch.core import device as core_device
    prev = core_device._current_device
    core_device._current_device = torch.device("cpu")
    try:
        if what is None:
            _workflow_refusal(case, tmp_path)
        else:
            with pytest.raises(NotImplementedError, match=what):
                _workflow_refusal(case, tmp_path)
    finally:
        core_device._current_device = prev


@pytest.mark.parametrize("case", ["load", "data_loader", "model", "quanter"])
def test_workflow_entry_points_need_the_card_or_an_explicit_cpu(
        no_cuda, case, tmp_path):
    """A loaded checkpoint, the loader's batches, a Model's network and a
    quanter's buffers go to the current place: without CUDA they raise
    unless the caller asked for the CPU."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch import io, quantization
    from paddle_tpu_torch.core import device as core_device
    prev = core_device._current_device
    core_device._current_device = torch.device("cpu")
    path = str(tmp_path / "t.pdparams")
    paddle.save({"w": paddle.to_tensor(np.ones(2, np.float32))}, path)

    def run():
        if case == "load":
            return paddle.load(path)["w"].place
        if case == "data_loader":
            ds = io.TensorDataset([np.arange(4)])
            return next(iter(io.DataLoader(ds, batch_size=2)))[0].place
        if case == "model":
            return paddle.Model(nn.Linear(2, 2)).network.weight.place
        return quantization.FakeQuanterWithAbsMaxObserverLayer().scale.place
    try:
        core_device._current_device = None
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()
        core_device._current_device = torch.device("cpu")
        assert run().is_cpu_place()
    finally:
        core_device._current_device = prev


@pytest.mark.parametrize("name,item", [
    ("watchdog", "part 3"), ("checkpoint", "part 3"), ("ps_sparse", "part 3"),
    ("ps", "part 3"), ("rpc", "part 3"), ("auto_tuner", "part 3"),
    ("sequence_parallel", "part 2"), ("ring_attention", "part 2"),
    ("ulysses", "part 2"), ("pipeline", "part 2"), ("pipeline_layer", "part 2"),
    ("CommTaskManager", "part 3"), ("Engine", "part 3"),
    ("Strategy", "part 3"), ("parallelize", "part 3"),
    ("to_distributed", "part 3")])
def test_unported_distributed_names_raise_naming_their_item(name, item):
    """The reference's ``paddle.distributed`` names whose modules the port
    does not have yet stay on the surface and raise, naming their ROADMAP
    item (M12 part 3); they never vanish or run some other way.  Those of
    M12 part 2 came: each is the port's module of the reference's
    ``parallel/`` module of that name, with its public names."""
    import importlib
    import paddle_tpu.distributed as jdist
    import paddle_tpu_torch.distributed as tdist
    ref = REPO / "paddle_tpu"
    assert hasattr(jdist, name) or any(
        (ref / pkg / name).exists() or (ref / pkg / f"{name}.py").exists()
        for pkg in ("distributed", "parallel"))
    obj = getattr(tdist, name)
    if item == "part 2":
        assert obj.__name__ == f"paddle_tpu_torch.parallel.{name}"
        jmod = importlib.import_module(f"paddle_tpu.parallel.{name}")
        public = [n for n, v in vars(jmod).items() if not n.startswith("_")
                  and getattr(v, "__module__", None) == jmod.__name__]
        assert public and all(hasattr(obj, n) for n in public), public
        return
    with pytest.raises(NotImplementedError, match=f"M12 {item}"):
        if callable(obj):
            obj()
        else:
            obj.anything
