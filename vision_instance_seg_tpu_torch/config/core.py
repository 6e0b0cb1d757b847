"""Hierarchical config system.

The reference drives everything through Detectron2's ``CfgNode`` (YAML merge,
programmatic override, free-form ``opts`` CLI override, ``freeze()``) — see
reference training/maskdino/train_experiments.py:48-87 and evaluate.py:58-89.
This module provides an independent implementation of that contract so the
training CLIs keep their exact surface (``merge_from_file``, ``merge_from_list``,
``freeze``, ``set_new_allowed``) without depending on detectron2.

It is a plain attribute-dict: configs are static metadata that model code
reads at construction, so every shape the model sees is fixed up front.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List

import yaml

_VALID_TYPES = (int, float, bool, str, bytes, type(None), tuple, list)


class CfgNode(dict):
    """An attribute-accessible, freezable, YAML-mergeable config node."""

    _FROZEN = "__frozen__"
    _NEW_ALLOWED = "__new_allowed__"

    def __init__(self, init_dict: Dict[str, Any] | None = None, new_allowed: bool = False):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, CfgNode._FROZEN, False)
        object.__setattr__(self, CfgNode._NEW_ALLOWED, new_allowed)
        for k, v in init_dict.items():
            self[k] = self._to_node(v, new_allowed)

    @classmethod
    def _to_node(cls, value: Any, new_allowed: bool = False) -> Any:
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            return cls(value, new_allowed=new_allowed)
        return value

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(f"config has no attribute {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        # yacs semantics: direct programmatic assignment of new keys is always
        # allowed when not frozen; only *merges* enforce key existence.
        if object.__getattribute__(self, CfgNode._FROZEN):
            raise AttributeError(f"cannot set {name!r}: config is frozen (call defrost())")
        super().__setitem__(name, self._to_node(value))

    def __delattr__(self, name: str) -> None:
        if object.__getattribute__(self, CfgNode._FROZEN):
            raise AttributeError("config is frozen")
        del self[name]

    # -- freeze protocol ----------------------------------------------------
    def freeze(self) -> "CfgNode":
        object.__setattr__(self, CfgNode._FROZEN, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()
        return self

    def defrost(self) -> "CfgNode":
        object.__setattr__(self, CfgNode._FROZEN, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()
        return self

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode._FROZEN)

    def set_new_allowed(self, flag: bool) -> None:
        object.__setattr__(self, CfgNode._NEW_ALLOWED, flag)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.set_new_allowed(flag)

    # -- merging ------------------------------------------------------------
    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        self._merge_dict(other)

    def _merge_dict(self, other: Dict[str, Any], prefix: str = "") -> None:
        for k, v in other.items():
            full = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict) and isinstance(self.get(k), CfgNode):
                self[k]._merge_dict(v, full)
            else:
                if k not in self and not object.__getattribute__(self, CfgNode._NEW_ALLOWED):
                    raise KeyError(f"non-existent config key: {full}")
                self[k] = self._to_node(v, object.__getattribute__(self, CfgNode._NEW_ALLOWED))

    def merge_from_file(self, cfg_filename: str, allow_unsafe: bool = False) -> None:
        with open(cfg_filename, "r") as f:
            loaded = yaml.safe_load(f) or {}
        base = loaded.pop("_BASE_", None)
        if base is not None:
            import os

            if not os.path.isabs(base):
                base = os.path.join(os.path.dirname(cfg_filename), base)
            self.merge_from_file(base, allow_unsafe=allow_unsafe)
        self._merge_dict(loaded)

    def merge_from_list(self, opts: List[Any]) -> None:
        """Merge from a flat ``[key1, val1, key2, val2, ...]`` list of dotted keys.

        Mirrors the reference CLIs' free-form ``opts`` override
        (train_experiments.py:84 ``cfg.merge_from_list(args.opts)``).
        """
        if len(opts) % 2 != 0:
            raise ValueError(f"override list has odd length: {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
                if not isinstance(node, CfgNode):
                    raise KeyError(f"{key}: {p} is not a config node")
            leaf = parts[-1]
            if leaf in node:
                value = _coerce(value, node[leaf])
            node[leaf] = value

    # -- IO -----------------------------------------------------------------
    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return out

    def dump(self, **kwargs) -> str:
        return yaml.safe_dump(_plain(self.to_dict()), **kwargs)

    def __deepcopy__(self, memo):
        node = CfgNode(new_allowed=True)
        for k, v in self.items():
            dict.__setitem__(node, k, copy.deepcopy(v, memo))
        object.__setattr__(node, CfgNode._NEW_ALLOWED,
                           object.__getattribute__(self, CfgNode._NEW_ALLOWED))
        object.__setattr__(node, CfgNode._FROZEN, False)
        return node

    def __repr__(self) -> str:
        return f"CfgNode({dict.__repr__(self)})"


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return list(obj)
    return obj


def _coerce(value: Any, like: Any) -> Any:
    """Coerce a CLI string to the type of the existing value, CfgNode-style."""
    if not isinstance(value, str):
        return value
    if isinstance(like, bool):
        if value.lower() in ("true", "1", "yes"):
            return True
        if value.lower() in ("false", "0", "no"):
            return False
        raise ValueError(f"cannot coerce {value!r} to bool")
    if isinstance(like, int) and not isinstance(like, bool):
        return int(value)
    if isinstance(like, float):
        return float(value)
    if isinstance(like, (tuple, list)):
        parsed = yaml.safe_load(value)
        if isinstance(like, tuple):
            return tuple(parsed)
        return list(parsed)
    return value
