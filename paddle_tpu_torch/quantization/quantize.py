"""QAT / PTQ passes (reference: python/paddle/quantization/qat.py QAT,
ptq.py PTQ, quantize.py Quantization, wrapper.py ObserveWrapper).

Model surgery walks the Layer tree and swaps matched sublayers for their
quanted counterparts (QAT) or wraps them with observers (PTQ); `convert`
freezes to int8-weight inference layers."""
from __future__ import annotations

import copy

from ..nn.layer.layers import Layer
from .config import QuantConfig

__all__ = ["Quantization", "QAT", "PTQ", "ObserveWrapper"]


class ObserveWrapper(Layer):
    """Runs the observer on the sublayer's OUTPUT activations
    (reference: wrapper.py ObserveWrapper)."""

    def __init__(self, observer, observed, observe_input=True):
        super().__init__()
        self._observer = observer
        self._observed = observed
        self._observe_input = observe_input

    def forward(self, *args, **kwargs):
        if self._observe_input and args and self._observer is not None:
            args = (self._observer(args[0]),) + tuple(args[1:])
        out = self._observed(*args, **kwargs)
        if not self._observe_input and self._observer is not None:
            out = self._observer(out)
        return out


def _walk_replace(model, fn, prefix=""):
    """Depth-first: fn(name, sublayer) -> replacement or None."""
    for name, sub in list(model._sub_layers.items()):
        full = f"{prefix}.{name}" if prefix else name
        repl = fn(full, sub)
        if repl is not None:
            model._sub_layers[name] = repl
        else:
            _walk_replace(sub, fn, full)
    return model


class Quantization:
    """reference: quantize.py Quantization base."""

    def __init__(self, config: QuantConfig):
        self._config = config

    def quantize(self, model, inplace=False):
        raise NotImplementedError

    def convert(self, model, inplace=False, remain_weight=False):
        """Swap QAT/observed layers for frozen int8 inference layers."""
        target = model if inplace else copy.deepcopy(model)

        def fn(name, sub):
            if isinstance(sub, ObserveWrapper):
                inner = sub._observed
                conv = getattr(inner, "convert", None)
                return conv() if conv is not None else inner
            if hasattr(sub, "convert"):
                try:
                    return sub.convert()
                except NotImplementedError:
                    return None
            return None
        out = _walk_replace(target, fn)
        out.eval()
        return out

    def _details(self):
        return str(self._config)

    def __str__(self):
        return self._details()

    __repr__ = __str__


class QAT(Quantization):
    """Quantization-aware training pass (reference: qat.py:27)."""

    def quantize(self, model: Layer, inplace: bool = False) -> Layer:
        target = model if inplace else copy.deepcopy(model)

        def fn(name, sub):
            qtype = self._config.quanted_type_of(sub)
            if qtype is not None and self._config._is_quantifiable(sub, name):
                return qtype(sub, self._config, name)
            return None
        return _walk_replace(target, fn)


class PTQ(Quantization):
    """Post-training quantization pass (reference: ptq.py:29): insert
    observers, calibrate by running data, then convert()."""

    def quantize(self, model: Layer, inplace: bool = False) -> Layer:
        target = model if inplace else copy.deepcopy(model)

        def fn(name, sub):
            qtype = self._config.quanted_type_of(sub)
            if qtype is None or not self._config._is_quantifiable(sub, name):
                return None
            quanted = qtype(sub, self._config, name)
            # PTQ: weights observed once (they're fixed); activations
            # observed during calibration via the wrapper
            if quanted.weight_quanter is not None:
                quanted.weight_quanter.eval()
                quanted.weight_quanter(quanted.weight)
            obs = quanted.activation_quanter
            quanted.activation_quanter = None
            if obs is not None:
                obs.eval()
                return ObserveWrapper(obs, quanted, observe_input=True)
            return quanted
        target = _walk_replace(target, fn)
        target.eval()
        return target
