"""paddle.device surface: counterpart of ``paddle_tpu/device/__init__.py``
(reference: python/paddle/device/__init__.py), on ``torch.cuda``.

Every entry point (``LLMEngine``, ``ModelRunner``, ``LlamaForCausalLM``)
takes ``device=`` and defaults to the card through :func:`resolve_device`.
Nothing carries on on the CPU by itself: without CUDA, a caller that did
not ask for the CPU gets an error, never a silent slow path.
"""
from __future__ import annotations

import contextlib

import torch

from ..core.device import (Place, current_place, device_count,  # noqa: F401
                           get_device, is_compiled_with_cinn,
                           is_compiled_with_cuda, is_compiled_with_xpu,
                           resolve_device, set_device)


def _cuda(device=None) -> torch.device:
    from ..core.device import _parse, current_device
    dev = _parse(device) if device is not None else current_device()
    if dev.type != "cuda":
        raise ValueError(f"{dev} is not a CUDA device")
    return dev


def get_available_device():
    return [f"gpu:{i}" for i in range(device_count())]


def get_all_device_type():
    return ["cpu", "gpu"] if device_count() else ["cpu"]


def get_available_custom_device():
    return []


def is_compiled_with_rocm():
    return False


def is_compiled_with_custom_device(name):
    return False


def synchronize(device=None):
    """Block until all queued work on the card completes."""
    torch.cuda.synchronize(_cuda(device))


class Stream:
    """A CUDA stream (``torch.cuda.Stream``) behind Paddle's names."""

    def __init__(self, device=None, priority=2):
        self.device = _cuda(device)
        # Paddle: priority 1 is high, 2 normal; torch: -1 high, 0 normal
        self.stream = torch.cuda.Stream(self.device,
                                        priority=-1 if priority == 1 else 0)

    def synchronize(self):
        self.stream.synchronize()

    def wait_stream(self, stream):
        self.stream.wait_stream(stream.stream)

    def record_event(self, event=None):
        event = event or Event()
        event.record(self)
        return event

    def wait_event(self, event):
        self.stream.wait_event(event.event)

    def query(self):
        return self.stream.query()


class Event:
    """A CUDA event (``torch.cuda.Event``)."""

    def __init__(self, enable_timing=False, blocking=False, interprocess=False):
        self.event = torch.cuda.Event(enable_timing=enable_timing,
                                      blocking=blocking,
                                      interprocess=interprocess)

    def record(self, stream=None):
        self.event.record(stream.stream if stream is not None else None)

    def query(self):
        return self.event.query()

    def synchronize(self):
        self.event.synchronize()

    def elapsed_time(self, end):
        return self.event.elapsed_time(end.event)


def current_stream(device=None):
    s = Stream.__new__(Stream)
    s.device = _cuda(device)
    s.stream = torch.cuda.current_stream(s.device)
    return s


def set_stream(stream):
    prev = current_stream(stream.device)
    torch.cuda.set_stream(stream.stream)
    return prev


@contextlib.contextmanager
def stream_guard(stream):
    with torch.cuda.stream(stream.stream):
        yield


class cuda:
    """paddle.device.cuda compat namespace."""

    Stream = Stream
    Event = Event

    @staticmethod
    def device_count():
        return device_count()

    @staticmethod
    def synchronize(device=None):
        synchronize(device)

    @staticmethod
    def current_stream(device=None):
        return current_stream(device)

    @staticmethod
    def max_memory_allocated(device=None):
        return torch.cuda.max_memory_allocated(_cuda(device))

    @staticmethod
    def memory_allocated(device=None):
        return torch.cuda.memory_allocated(_cuda(device))

    @staticmethod
    def memory_reserved(device=None):
        return torch.cuda.memory_reserved(_cuda(device))

    @staticmethod
    def empty_cache():
        torch.cuda.empty_cache()


def get_cudnn_version():
    return torch.backends.cudnn.version()


def is_compiled_with_ipu():
    return False


def is_compiled_with_distribute():
    return True


def get_all_custom_device_type():
    return []


class IPUPlace:
    def __init__(self, *a, **k):
        raise NotImplementedError("IPU support is not part of the CUDA build")
