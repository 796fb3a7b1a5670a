"""RNG — stateful seed surface: counterpart of ``paddle_tpu/core/rng.py``.

Analog of phi::Generator (phi/core/generator.h): Paddle exposes a global
stateful seed.  Here it is one ``torch.Generator`` a device, made at first
use on that device and seeded from the generator's seed.  Its draws are
torch's (Philox on the card, Mersenne Twister on the CPU), so they do not
match the reference's threefry keys for the same seed.
"""
from __future__ import annotations

import torch

from .tensor import Tensor


class Generator:
    """Lazy: no torch.Generator exists until a device asks for one, so
    importing the package touches no card."""

    def __init__(self, seed: int = 0):
        self._seed = seed
        self._gens: dict = {}

    def manual_seed(self, seed: int):
        self._seed = seed
        for g in self._gens.values():
            g.manual_seed(seed)
        return self

    def generator(self, device=None) -> torch.Generator:
        """The torch.Generator that draws on ``device`` (the current
        place when None)."""
        if device is None:
            from .device import current_device
            device = current_device()
        device = torch.device(device)
        g = self._gens.get(device)
        if g is None:
            g = self._gens[device] = torch.Generator(device).manual_seed(
                self._seed)
        return g

    def get_state(self) -> Tensor:
        """The current device's generator state, as a uint8 Tensor on the
        CPU (``torch.Generator.get_state``)."""
        t = Tensor(self.generator().get_state())
        t.name = "global_rng_state"
        return t

    def set_state(self, state):
        buf = state._data if isinstance(state, Tensor) else torch.as_tensor(state)
        self.generator().set_state(buf.cpu())

    def initial_seed(self) -> int:
        return self._seed


_default_generator = Generator(0)


def default_generator() -> Generator:
    return _default_generator


def seed(s: int) -> Generator:
    """paddle.seed analog."""
    _default_generator.manual_seed(int(s))
    return _default_generator


def get_rng_state():
    return [_default_generator.get_state()]


def set_rng_state(states):
    _default_generator.set_state(states[0] if isinstance(states, (list, tuple)) else states)


def next_generator(device=None) -> torch.Generator:
    """The default generator's torch.Generator for ``device``: what a
    random op draws from."""
    return _default_generator.generator(device)
