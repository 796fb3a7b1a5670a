"""paddle_tpu_torch.testing — deterministic chaos/fault tooling for tier-1 tests.

The reference repo validates its fault paths with live multi-node kill tests;
on a single CPU host the equivalent is *injected* failure: named fault points
threaded through the serving engine and the control-plane store, driven by
seeded schedules so every failure path is exercised deterministically (see
:mod:`.faults`).
"""
from .faults import (FAULTS, KNOWN_POINTS, Always, FailNth,  # noqa: F401
                     FailProb, FaultInjector, InjectedFault, Never, injected)

__all__ = ["FAULTS", "KNOWN_POINTS", "FaultInjector", "InjectedFault",
           "FailNth", "FailProb", "Always", "Never", "injected"]
