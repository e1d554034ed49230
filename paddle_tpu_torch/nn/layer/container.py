"""Container layers (counterpart of the reference's
``nn/layer/container.py``): ``Sequential``, ``LayerList``,
``ParameterList`` and ``LayerDict``.

Sublayers are named as in the reference -- ``"0"``, ``"1"``, ... for
positional layers, the given name for ``(name, layer)`` pairs or an
``OrderedDict`` -- so parameter names (``features.0.weight``) match its
and ``convert.load_reference_params`` carries them across."""
from __future__ import annotations

import collections
from typing import Iterable

from torch import nn

from ...core.errors import InvalidArgumentError


class Sequential(nn.Module):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            for name, layer in layers[0].items():
                self.add_module(name, layer)
        else:
            for i, item in enumerate(layers):
                if isinstance(item, tuple):
                    self.add_module(item[0], item[1])
                else:
                    self.add_module(str(i), item)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(nn.Module):
    def __init__(self, sublayers: Iterable[nn.Module] = None):
        super().__init__()
        if sublayers is not None:
            for i, layer in enumerate(sublayers):
                self.add_module(str(i), layer)

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __setitem__(self, idx, layer):
        keys = list(self._modules.keys())
        self._modules[keys[idx]] = layer

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer: nn.Module) -> "LayerList":
        self.add_module(str(len(self._modules)), layer)
        return self

    def insert(self, index: int, layer: nn.Module) -> None:
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, sub in enumerate(layers):
            self._modules[str(i)] = sub

    def extend(self, sublayers: Iterable[nn.Module]) -> "LayerList":
        for layer in sublayers:
            self.append(layer)
        return self


class ParameterList(nn.Module):
    def __init__(self, parameters: Iterable[nn.Parameter] = None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.register_parameter(str(i), p)

    def __len__(self):
        return len(self._parameters)

    def __getitem__(self, idx):
        return list(self._parameters.values())[idx]

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter: nn.Parameter) -> "ParameterList":
        self.register_parameter(str(len(self._parameters)), parameter)
        return self


class LayerDict(nn.Module):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_module(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __contains__(self, key):
        return key in self._modules

    def __iter__(self):
        return iter(self._modules)

    def keys(self):
        return self._modules.keys()

    def values(self):
        return self._modules.values()

    def items(self):
        return self._modules.items()

    def clear(self):
        self._modules.clear()

    def pop(self, key):
        return self._modules.pop(key)

    def update(self, sublayers) -> None:
        if isinstance(sublayers, dict):
            sublayers = sublayers.items()
        for item in sublayers:
            if not isinstance(item, (list, tuple)) or len(item) != 2:
                raise InvalidArgumentError(
                    "LayerDict.update expects (name, layer) pairs")
            self.add_module(item[0], item[1])
