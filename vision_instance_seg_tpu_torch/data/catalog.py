"""Dataset and metadata registries: the port's own, apart from the JAX
package's (a name registered in one is unknown to the other).

Replaces Detectron2's ``DatasetCatalog``/``MetadataCatalog`` (which the
reference uses for lazy dataset registration — reference
scripts/data_utils/register_experiments.py:67-96, training/maskdino/
train_original.py:198-244) with an in-process registry carrying the same
semantics: lazy loader functions keyed by name, and attribute-style metadata
(``thing_classes``, ``thing_colors``, ``evaluator_type``, paths).
"""

from __future__ import annotations

import copy
import types
from typing import Any, Callable, Dict, List


class _DatasetCatalog:
    def __init__(self):
        self._registry: Dict[str, Callable[[], List[dict]]] = {}

    def register(self, name: str, func: Callable[[], List[dict]]) -> None:
        if not callable(func):
            raise TypeError("you must register a callable producing dataset dicts")
        if name in self._registry:
            raise KeyError(f"dataset '{name}' is already registered")
        self._registry[name] = func

    def get(self, name: str) -> List[dict]:
        try:
            f = self._registry[name]
        except KeyError:
            avail = ", ".join(sorted(self._registry))
            raise KeyError(f"dataset '{name}' is not registered. available: {avail}")
        return f()

    def list(self) -> List[str]:
        return sorted(self._registry)

    def remove(self, name: str) -> None:
        self._registry.pop(name)

    def clear(self) -> None:
        self._registry.clear()

    def __contains__(self, name: str) -> bool:
        return name in self._registry


class Metadata(types.SimpleNamespace):
    """Attribute bag for dataset metadata; assign-once like detectron2's."""

    name: str = "N/A"

    def __getattr__(self, key):
        raise AttributeError(
            f"metadata '{getattr(self, 'name', '?')}' has no attribute '{key}'"
        )

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)

    def set(self, **kwargs) -> "Metadata":
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self

    def as_dict(self) -> Dict[str, Any]:
        return copy.copy(self.__dict__)


class _MetadataCatalog:
    def __init__(self):
        self._store: Dict[str, Metadata] = {}

    def get(self, name: str) -> Metadata:
        if name not in self._store:
            self._store[name] = Metadata(name=name)
        return self._store[name]

    def list(self) -> List[str]:
        return sorted(self._store)

    def remove(self, name: str) -> None:
        self._store.pop(name)

    def clear(self) -> None:
        self._store.clear()

    def __contains__(self, name: str) -> bool:
        return name in self._store


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()
