"""Minimal yacs-compatible config node.

A copy of `csbsr_tpu/config/node.py` with PyYAML imported only where a YAML
file or a YAML-typed override string is read, so the GPU main path runs
without it. Attribute access, YAML merge with type checking, freeze/clone and
`merge_from_list` behave as in the JAX package.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List


class CfgNode(dict):
    """Dict subclass with attribute access and yacs-style merging."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Dict | None = None):
        super().__init__()
        self.__dict__[CfgNode.IMMUTABLE] = False
        if init_dict:
            for k, v in init_dict.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if self.__dict__.get(CfgNode.IMMUTABLE, False):
            raise AttributeError(
                f"Attempted to set {name} to {value}, but CfgNode is immutable"
            )
        self[name] = value

    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return self.__dict__[CfgNode.IMMUTABLE]

    def _set_immutable(self, flag: bool) -> None:
        self.__dict__[CfgNode.IMMUTABLE] = flag
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(flag)

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def merge_from_file(self, path: str) -> None:
        import yaml

        with open(path, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        self._merge(loaded, [])

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        self._merge(other, [])

    def merge_from_list(self, opts: List[Any]) -> None:
        assert len(opts) % 2 == 0, "Override list must be key/value pairs"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            node[leaf] = _coerce(value, node[leaf], key)

    def _merge(self, other: Dict, path: List[str]) -> None:
        for k, v in other.items():
            full = ".".join(path + [str(k)])
            if k not in self:
                raise KeyError(f"Non-existent config key: {full}")
            cur = self[k]
            if isinstance(cur, CfgNode):
                if not isinstance(v, dict):
                    raise TypeError(f"Cannot merge non-dict into dict at {full}")
                cur._merge(v, path + [str(k)])
            else:
                self[k] = _coerce(v, cur, full)

    def dump(self) -> str:
        import yaml

        return yaml.safe_dump(self._to_plain(), sort_keys=False)

    def _to_plain(self) -> Dict:
        return {k: v._to_plain() if isinstance(v, CfgNode) else v for k, v in self.items()}


def _coerce(value: Any, old: Any, key: str) -> Any:
    """yacs-style type coercion: allow compatible replacement values."""
    if isinstance(value, str) and not isinstance(old, str):
        import yaml

        value = yaml.safe_load(value)
        if isinstance(value, str) and isinstance(old, (int, float)):
            # YAML 1.1 reads '2e-5' (no dot) as a string; yacs coerces it
            try:
                value = float(value)
            except ValueError:
                pass
    if old is None or value is None:
        return value
    if isinstance(old, bool) is not isinstance(value, bool) and (
        isinstance(old, bool) or isinstance(value, bool)
    ):
        raise TypeError(f"Type mismatch for {key}: {type(old)} vs {type(value)}")
    if isinstance(old, (int, float)) and isinstance(value, (int, float)):
        return value
    if isinstance(old, (list, tuple)):
        if not isinstance(value, (list, tuple)):
            raise TypeError(f"Type mismatch for {key}: {type(old)} vs {type(value)}")
        return list(value)
    if type(old) is not type(value):
        raise TypeError(f"Type mismatch for {key}: {type(old)} vs {type(value)}")
    return value
