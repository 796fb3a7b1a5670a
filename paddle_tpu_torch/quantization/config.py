"""QuantConfig (reference: python/paddle/quantization/config.py:67).

Maps layers (by instance, type, or name) to activation/weight quanter
factories and declares which layer types have quantized (QAT) counterparts."""
from __future__ import annotations

from ..nn.layer.layers import Layer

__all__ = ["QuantConfig"]


class QuantConfig:
    def __init__(self, activation=None, weight=None):
        self._global_act, self._global_wt = activation, weight
        self._layer_cfg = {}       # id(layer) -> (act, wt)
        self._type_cfg = {}        # type -> (act, wt)
        self._name_cfg = {}        # layer name -> (act, wt)
        self._qat_mapping = {}     # source type -> quanted type
        self._customized_leaves = []

    # -- registration (reference config.py add_layer_config etc.) ------------
    def add_layer_config(self, layer, activation=None, weight=None):
        layers = layer if isinstance(layer, (list, tuple)) else [layer]
        for l in layers:
            self._layer_cfg[id(l)] = (activation, weight)

    def add_type_config(self, layer_type, activation=None, weight=None):
        types = layer_type if isinstance(layer_type, (list, tuple)) \
            else [layer_type]
        for t in types:
            self._type_cfg[t] = (activation, weight)

    def add_name_config(self, layer_name, activation=None, weight=None):
        names = layer_name if isinstance(layer_name, (list, tuple)) \
            else [layer_name]
        for n in names:
            self._name_cfg[n] = (activation, weight)

    def add_qat_layer_mapping(self, source, target):
        self._qat_mapping[source] = target

    def add_customized_leaves(self, layer_type):
        self._customized_leaves.append(layer_type)

    @property
    def customized_leaves(self):
        return self._customized_leaves

    # -- lookup ---------------------------------------------------------------
    def _get_config_by_layer(self, layer, name=None):
        if id(layer) in self._layer_cfg:
            return self._layer_cfg[id(layer)]
        if name is not None and name in self._name_cfg:
            return self._name_cfg[name]
        for t, cfg in self._type_cfg.items():
            if isinstance(layer, t):
                return cfg
        return (self._global_act, self._global_wt)

    def _is_quantifiable(self, layer, name=None):
        act, wt = self._get_config_by_layer(layer, name)
        return act is not None or wt is not None

    def quanted_type_of(self, layer):
        from .qat_layers import default_qat_mapping
        mapping = default_qat_mapping()
        mapping.update(self._qat_mapping)
        for src, dst in mapping.items():
            if type(layer) is src:
                return dst
        return None

    def __str__(self):
        return (f"QuantConfig(global_act={self._global_act}, "
                f"global_wt={self._global_wt}, "
                f"types={list(self._type_cfg)})")
