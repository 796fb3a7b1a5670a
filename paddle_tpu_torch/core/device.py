"""Device / place management: counterpart of ``paddle_tpu/core/device.py``.

Paddle's Place hierarchy (phi/common/place.h) collapses here to
``torch.device``: the card is the first-class target, the CPU the test
backend.  ``set_device`` / ``get_device`` keep the Paddle string surface
("gpu", "gpu:0", "cpu"; "cuda" and "tpu" name the card too).

The default place is the card.  Nothing carries on on the CPU by itself:
without CUDA, an op that needs a device (a creation op called without
``place=``) raises through :func:`resolve_device` unless the caller asked
for the CPU with ``set_device("cpu")``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names CUDA and
    no card is present, or names a device type the port does not serve."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    return dev


class Place:
    """Lightweight place wrapper over a torch.device (phi/common/place.h
    analog)."""

    __slots__ = ("device",)

    def __init__(self, device: torch.device):
        self.device = device

    @property
    def platform(self) -> str:
        return "gpu" if self.device.type == "cuda" else self.device.type

    def is_tpu_place(self) -> bool:
        return False

    def is_cpu_place(self) -> bool:
        return self.device.type == "cpu"

    def is_gpu_place(self) -> bool:
        return self.device.type == "cuda"

    def get_device_id(self) -> int:
        return self.device.index or 0

    def __eq__(self, other):
        if isinstance(other, Place):
            return self.device == other.device
        return NotImplemented

    def __hash__(self):
        return hash(self.device)

    def __repr__(self):
        return f"Place({self.platform}:{self.get_device_id()})"


_current_device = None


def _parse(device) -> torch.device:
    """A device spec (Paddle string, torch.device, Place) as a checked
    torch.device; the card's index is filled in."""
    if device is None:
        return None
    if isinstance(device, Place):
        device = device.device
    if isinstance(device, str):
        name, _, idx = device.partition(":")
        if name in ("gpu", "tpu", "xpu"):
            name = "cuda"
        device = f"{name}:{idx or 0}" if name == "cuda" else name
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def set_device(device) -> Place:
    """paddle.set_device analog (python/paddle/device/__init__.py)."""
    global _current_device
    _current_device = _parse(device)
    return Place(_current_device)


def current_device() -> torch.device:
    """The place new tensors go to: the one ``set_device`` chose, else the
    card (raises without CUDA)."""
    return _current_device or _parse("gpu")


def get_device() -> str:
    d = current_device()
    return "cpu" if d.type == "cpu" else f"gpu:{d.index}"


def current_place() -> Place:
    return Place(current_device())


def is_compiled_with_cuda() -> bool:
    return True


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_cinn() -> bool:
    return False


def device_count() -> int:
    return torch.cuda.device_count()
