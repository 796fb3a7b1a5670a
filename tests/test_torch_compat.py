"""The port's top-level compat pieces (``paddle_tpu_torch/framework/
compat.py``, ``version.py``) against the JAX package's, on the CPU:
``dtype``, ``iinfo`` and ``finfo`` for every dtype both name alike,
``set_printoptions``, the places, dlpack, ``LazyGuard``, ``batch``,
``check_shape``, ``pstring`` / ``raw`` and ``__version__``; the CUDA RNG
state on the port's card generator is ``cuda``-marked."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import device as tdevice

NAMES = ("bool", "uint8", "int8", "int16", "int32", "int64", "float16",
         "bfloat16", "float32", "float64")


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev


@pytest.mark.parametrize("name", NAMES)
def test_dtype_names_and_equality(name):
    assert tp.dtype(name).name == pt.dtype(name).name
    assert repr(tp.dtype(name)) == repr(pt.dtype(name))
    assert tp.dtype(name) == tp.dtype(name) and tp.dtype(name) == name
    assert hash(tp.dtype(name)) == hash(tp.dtype(name))


@pytest.mark.parametrize("name", ("uint8", "int8", "int16", "int32", "int64"))
def test_iinfo_matches_the_reference(name):
    a, b = tp.iinfo(name), pt.iinfo(name)
    assert (a.min, a.max, a.bits, a.dtype) == (b.min, b.max, b.bits, b.dtype)
    assert repr(a) == repr(b)


@pytest.mark.parametrize("name", ("float16", "bfloat16", "float32", "float64"))
def test_finfo_matches_the_reference(name):
    a, b = tp.finfo(name), pt.finfo(name)
    for attr in ("min", "max", "eps", "tiny", "smallest_normal", "bits",
                 "dtype"):
        assert getattr(a, attr) == getattr(b, attr), attr
    assert repr(a) == repr(b)


def test_set_printoptions_drives_numpy():
    saved = np.get_printoptions()
    try:
        tp.set_printoptions(precision=3, threshold=20, edgeitems=2,
                            linewidth=60, sci_mode=False)
        opts = np.get_printoptions()
        assert (opts["precision"], opts["threshold"], opts["edgeitems"],
                opts["linewidth"], opts["suppress"]) == (3, 20, 2, 60, True)
    finally:
        np.set_printoptions(**saved)


def test_places():
    p = tp.CUDAPlace(0)
    assert p.is_gpu_place() and p.get_device_id() == 0 and p.platform == "gpu"
    assert tp.CUDAPlace(1).device == torch.device("cuda", 1)
    assert tp.CUDAPinnedPlace().is_cpu_place()


@pytest.mark.parametrize("src", ["numpy", "torch", "tensor"])
def test_dlpack_round_trip(src):
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    obj = {"numpy": a, "torch": torch.from_numpy(a.copy()),
           "tensor": tp.to_tensor(a)}[src]
    t = tp.from_dlpack(obj)
    np.testing.assert_array_equal(t.numpy(), a)
    back = tp.from_dlpack(tp.to_dlpack(t))
    np.testing.assert_array_equal(back.numpy(), a)
    back._buf[0, 0] = 7.0                 # the capsule shares the memory
    assert float(t.numpy()[0, 0]) == 7.0


def test_lazy_guard_batch_check_shape_and_string_dtypes():
    with tp.LazyGuard() as g:
        lin = tp.nn.Linear(2, 2)
    assert isinstance(g, tp.LazyGuard) and lin.weight.shape == [2, 2]

    def reader():
        yield from range(7)
    assert list(tp.batch(reader, 3)()) == list(pt.batch(reader, 3)()) == [
        [0, 1, 2], [3, 4, 5], [6]]
    assert list(tp.batch(reader, 3, drop_last=True)()) == [[0, 1, 2],
                                                           [3, 4, 5]]
    assert tp.check_shape([2, -1, None]) == [2, -1, None]
    assert tp.check_shape(3) == 3
    with pytest.raises(TypeError):
        tp.check_shape([2.5])
    with pytest.raises(ValueError):
        tp.check_shape([-2])
    with pytest.raises(TypeError):
        tp.check_shape("x")
    for d in (tp.pstring, tp.raw):
        with pytest.raises(TypeError):
            d()


def test_version_and_framework_namespace():
    assert tp.__version__ == pt.__version__
    from paddle_tpu_torch import version
    assert (version.major, version.minor, version.patch) == (0, 5, 0)
    assert tp.framework.seed is tp.seed
    assert tp.framework.get_default_dtype() == tp.get_default_dtype()
    assert tp.framework.in_dynamic_mode()


@pytest.mark.cuda
def test_cuda_rng_state_round_trip_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tp.set_device("cuda")
    try:
        state = tp.get_cuda_rng_state()
        assert len(state) == torch.cuda.device_count()
        a = tp.rand([16]).numpy()
        tp.set_cuda_rng_state(state)
        b = tp.rand([16]).numpy()
        np.testing.assert_array_equal(a, b)
    finally:
        tp.set_device("cpu")
