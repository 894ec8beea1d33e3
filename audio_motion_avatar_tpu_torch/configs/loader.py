"""YAML config system (copy of the JAX package's configs/loader.py).

The reference's mini-Hydra composition, read with the port's own YAML
subset parser (`yaml_subset`, which resolves scalars as PyYAML's safe_load
does) instead of PyYAML, the one code path on every machine:

  * `defaults:` list — child YAMLs merged in order, paths relative to the
    config dir, `_self_` marks where the main file's own keys merge
    (config_loader.py:26-43);
  * `${a.b.c}` interpolation across the merged tree, including a recursive
    key search fallback for bare names (:88-187);
  * arithmetic string expressions like "${x}*3" evaluated with a character
    whitelist (:118-125);
  * dotted CLI overrides (`a.b.c=value`, main.py:58-61);
  * `create_model_config` flattening model.* + training + top-level keys
    into one flat namespace for module constructors (:189-235).
"""

from __future__ import annotations

import os
import re
from typing import Any, Iterable, Optional

from . import yaml_subset

_INTERP = re.compile(r"\$\{([^}]+)\}")
_ARITH_OK = re.compile(r"^[\d\s\.\+\-\*\/\(\)]+$")


class Config(dict):
    """dict with attribute access, nested-aware."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @classmethod
    def wrap(cls, obj):
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [cls.wrap(v) for v in obj]
        return obj

    def to_dict(self):
        def un(o):
            if isinstance(o, dict):
                return {k: un(v) for k, v in o.items()}
            if isinstance(o, list):
                return [un(v) for v in o]
            return o
        return un(self)


def _deep_merge(base: dict, extra: dict) -> dict:
    out = dict(base)
    for k, v in extra.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _get_path(tree: dict, dotted: str):
    cur = tree
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            raise KeyError(dotted)
        cur = cur[part]
    return cur


def _search_key(tree: dict, name: str):
    """Recursive search for a bare key name (config_loader.py fallback)."""
    if isinstance(tree, dict):
        if name in tree:
            return tree[name], True
        for v in tree.values():
            found, ok = _search_key(v, name)
            if ok:
                return found, True
    return None, False


def _resolve_value(val: Any, root: dict, depth: int = 0) -> Any:
    if depth > 20:
        raise ValueError(f"interpolation loop: {val!r}")
    if isinstance(val, str) and "${" in val:
        def lookup(ref: str):
            try:
                return _get_path(root, ref)
            except KeyError:
                found, ok = _search_key(root, ref.split(".")[-1])
                if ok:
                    return found
                raise KeyError(f"cannot resolve ${{{ref}}}")

        m = _INTERP.fullmatch(val.strip())
        if m:  # pure reference: keep the referenced type
            return _resolve_value(lookup(m.group(1)), root, depth + 1)

        # embedded reference(s): substitute textually, then maybe eval
        def sub(match):
            v = _resolve_value(lookup(match.group(1)), root, depth + 1)
            return str(v)

        text = _INTERP.sub(sub, val)
        if _ARITH_OK.match(text):
            try:
                return eval(text, {"__builtins__": {}}, {})  # whitelisted chars only
            except Exception:
                return text
        return text
    if isinstance(val, dict):
        return {k: _resolve_value(v, root, depth) for k, v in val.items()}
    if isinstance(val, list):
        return [_resolve_value(v, root, depth) for v in val]
    return val


class ConfigLoader:
    @staticmethod
    def load_config(path: str, overrides: Optional[Iterable[str]] = None) -> Config:
        cfg_dir = os.path.dirname(os.path.abspath(path))
        main = yaml_subset.load(path) or {}

        merged: dict = {}
        defaults = main.pop("defaults", None)
        self_merged = False
        if defaults:
            for entry in defaults:
                if entry == "_self_":
                    merged = _deep_merge(merged, main)
                    self_merged = True
                    continue
                sub_path = os.path.join(cfg_dir, str(entry))
                if not sub_path.endswith(".yaml"):
                    sub_path += ".yaml"
                sub = yaml_subset.load(sub_path) or {}
                sub.pop("defaults", None)
                merged = _deep_merge(merged, sub)
        if not self_merged:
            merged = _deep_merge(merged, main)

        if overrides:
            for ov in overrides:
                if "=" not in ov:
                    continue
                key, _, raw = ov.partition("=")
                val = yaml_subset.loads(raw)
                node = merged
                parts = key.strip().split(".")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = val

        resolved = _resolve_value(merged, merged)
        return Config.wrap(resolved)

    @staticmethod
    def create_model_config(cfg: Config) -> Config:
        """Flatten model.* sub-trees + training + scalar top-level keys into
        one namespace (config_loader.py:189-235)."""
        flat: dict = {}
        model = cfg.get("model", {})
        for sub in ("ptv3_encoder", "triplane_net", "renderer",
                    "sapiens_encoder", "triplane_audio_net"):
            if sub in model:
                flat.update(model[sub])
        flat.update(cfg.get("training", {}))
        if "dataset" in cfg:
            for k, v in cfg["dataset"].items():
                if not isinstance(v, (dict, list)):
                    flat.setdefault(k, v)
        for k, v in cfg.items():
            if not isinstance(v, (dict, list)):
                flat.setdefault(k, v)
        return Config.wrap(flat)
