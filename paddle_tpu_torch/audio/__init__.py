"""paddle.audio analog (reference: python/paddle/audio — functional DSP,
feature Layers, WAV backends, datasets)."""
from . import functional
from . import features
from . import backends
from . import datasets
from .backends import load, save, info

__all__ = ["functional", "features", "backends", "datasets", "load", "save",
           "info"]
