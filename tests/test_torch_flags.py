"""The port's flag registry (``paddle_tpu_torch/core/flags.py``) against the
JAX package's: the same flags with the same values, the same errors, and
the ``FLAGS_<name>`` environment override."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.core import flags as jflags
from paddle_tpu_torch.core import flags as tflags

REPO = Path(__file__).resolve().parent.parent


def test_get_flags_matches_the_reference_for_every_flag():
    want = jpt.get_flags()
    assert tpt.get_flags() == want
    assert set(tflags._registry) == set(jflags._registry)
    for name in jflags._registry:
        assert tpt.get_flags(name) == jpt.get_flags(name)
        assert tpt.get_flags(f"FLAGS_{name}") == jpt.get_flags(name)
        t, j = tflags._registry[name], jflags._registry[name]
        assert (t["default"], t["type"]) == (j["default"], j["type"])


@pytest.mark.parametrize("name,value,want", [
    ("FLAGS_flash_layout_direct", "true", True),
    ("weight_only_use_kernel", 0, False),
    ("check_nan_inf_level", "2", 2),
    ("eager_delete_tensor_gb", "0.5", 0.5),
])
def test_set_flags_coerces_as_the_reference(name, value, want):
    key = name[6:] if name.startswith("FLAGS_") else name
    saved = (tflags.flag(key), jflags.flag(key))
    try:
        tpt.set_flags({name: value})
        jpt.set_flags({name: value})
        assert tflags.flag(key) == jflags.flag(key) == want
        assert tpt.get_flags([name]) == jpt.get_flags([name])
    finally:
        tpt.set_flags({key: saved[0]})
        jpt.set_flags({key: saved[1]})


def test_unknown_flags_raise_key_error_as_the_reference():
    with pytest.raises(KeyError, match="unknown flag"):
        jpt.set_flags({"FLAGS_no_such_flag": 1})
    with pytest.raises(KeyError, match="unknown flag"):
        tpt.set_flags({"FLAGS_no_such_flag": 1})
    with pytest.raises(KeyError):
        tpt.get_flags("no_such_flag")
    with pytest.raises(KeyError):
        tflags.flag("no_such_flag")


def test_on_change_hooks_see_the_coerced_value():
    seen = []
    tflags.on_change("log_level", seen.append)
    try:
        tpt.set_flags({"log_level": "3"})
        assert seen == [3]
    finally:
        tflags._hooks["log_level"].remove(seen.append)
        tpt.set_flags({"log_level": 0})


def test_environment_override_in_a_fresh_process():
    code = ("import paddle_tpu_torch as p, sys\n"
            "f = p.get_flags(['flash_layout_direct', 'weight_only_use_kernel',"
            " 'log_level'])\n"
            "assert f == {'FLAGS_flash_layout_direct': True, "
            "'FLAGS_weight_only_use_kernel': False, 'FLAGS_log_level': 4}, f\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'paddle_tpu')]\n")
    env = dict(os.environ, FLAGS_flash_layout_direct="1",
               FLAGS_weight_only_use_kernel="off", FLAGS_log_level="4")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
