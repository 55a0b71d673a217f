"""Config system: Python-module / YAML configs with ``_base_`` inheritance.

Same semantics as `jnerf_tpu/utils/config.py`: a global ``Config``
singleton with attribute access (missing keys read as None), ``_base_``
multi-file recursive merge, ``_cover_`` replace-instead-of-merge markers,
and the ``init_cfg / get_cfg / update_cfg / save_cfg / print_cfg`` entry
points, so the configs under ``projects/`` load unchanged.

``yaml`` is imported only where a ``.yaml`` file is read or a config is
dumped: the machines the port trains on need not have it.
"""

from __future__ import annotations

import copy
import importlib.util
import inspect
import os
import sys
from collections import OrderedDict

__all__ = ["Config", "get_cfg", "init_cfg", "update_cfg", "save_cfg", "print_cfg"]

BASE_KEY = "_base_"
COVER_KEY = "_cover_"

_py_cfg_counter = 0


def _load_raw(filename: str) -> dict:
    """Load a single config file (no _base_ handling) into a plain dict."""
    global _py_cfg_counter
    ext = os.path.splitext(filename)[1]
    if not os.path.isfile(filename):
        raise FileNotFoundError(f"config file not found: {filename}")
    if ext in (".yaml", ".yml"):
        import yaml

        with open(filename, "r") as f:
            return yaml.safe_load(f.read()) or {}
    if ext == ".py":
        # Import the module under a unique synthetic name so sibling configs
        # with identical basenames (e.g. many projects' `base.py`) don't clash.
        _py_cfg_counter += 1
        mod_name = f"_jnerf_tpu_torch_cfg_{_py_cfg_counter}"
        spec = importlib.util.spec_from_file_location(mod_name, filename)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        try:
            spec.loader.exec_module(mod)
            return {
                k: v
                for k, v in vars(mod).items()
                if not k.startswith("__") and not inspect.ismodule(v)
            }
        finally:
            sys.modules.pop(mod_name, None)
    raise ValueError(f"unsupported config extension {ext!r} for {filename}")


def _strip_cover(node):
    if not isinstance(node, dict):
        return node
    return {k: _strip_cover(v) for k, v in node.items() if k != COVER_KEY}


def _merge_into(a: dict, b: dict) -> None:
    """Merge b into a, recursively; dict values carrying _cover_ replace."""
    if COVER_KEY in b:
        a.clear()
        a.update(_strip_cover(copy.deepcopy(b)))
        return
    for k, v in b.items():
        if (
            k not in a
            or not isinstance(v, dict)
            or not isinstance(a.get(k), dict)
            or (isinstance(v, dict) and v.get(COVER_KEY, False))
        ):
            a[k] = _strip_cover(copy.deepcopy(v))
        else:
            _merge_into(a[k], v)


def _load_with_bases(filename: str) -> dict:
    cfg = _load_raw(filename)
    cfg_dir = os.path.dirname(os.path.abspath(filename))
    if BASE_KEY in cfg:
        bases = cfg.pop(BASE_KEY)
        if isinstance(bases, str):
            bases = [bases]
        merged: dict = {}
        for b in bases:
            _merge_into(merged, _load_with_bases(os.path.join(cfg_dir, b)))
        _merge_into(merged, cfg)
        cfg = merged
    return cfg


_warned_missing_keys = set()


class Config(OrderedDict):
    """An attribute-accessible ordered dict; missing keys read as None.

    A missing-key read that closely matches an existing key warns once
    (e.g. cfg.hash_indexng with hash_indexing set), so that a typo does
    not silently select a default.
    """

    def __init__(self, *args):
        super().__init__()
        if len(args) == 1:
            self.load_from_file(args[0])
        elif args:
            raise TypeError("Config() takes at most one filename argument")

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        if name not in self and name not in _warned_missing_keys and self:
            import difflib

            close = difflib.get_close_matches(name, self.keys(), n=1,
                                              cutoff=0.85)
            if close:
                _warned_missing_keys.add(name)
                import warnings

                warnings.warn(
                    f"config key {name!r} was never set but {close[0]!r} is "
                    f"— likely a typo; reading None",
                    stacklevel=2,
                )
        return self.get(name, None)

    def __setattr__(self, name, value):
        self[name] = value

    def __deepcopy__(self, memo):
        new = Config()
        for k, v in self.items():
            new[k] = copy.deepcopy(v, memo)
        return new

    @staticmethod
    def _wrap(node):
        if isinstance(node, dict):
            out = Config()
            for k, v in node.items():
                out[k] = Config._wrap(v)
            return out
        if isinstance(node, list):
            return [Config._wrap(v) for v in node]
        return node

    def load_from_file(self, filename: str) -> None:
        raw = _load_with_bases(filename)
        self.clear()
        for k, v in raw.items():
            self[k] = Config._wrap(v)
        if self.name is None:
            self.name = os.path.splitext(os.path.basename(filename))[0]
        if self.work_dir is None:
            self.work_dir = f"work_dirs/{self.name}"

    def dump(self) -> dict:
        """Convert back to plain dicts/lists (for YAML serialization)."""

        def _plain(node):
            if isinstance(node, dict):
                return {k: _plain(v) for k, v in node.items()}
            if isinstance(node, list):
                return [_plain(v) for v in node]
            return node

        # Live objects injected by runners (dataset_obj etc.) aren't dumpable.
        return {
            k: _plain(v)
            for k, v in self.items()
            if not k.endswith("_obj") and not callable(v)
        }


_cfg = Config()


def init_cfg(filename: str) -> None:
    print("Loading config from:", filename)
    _cfg.load_from_file(filename)


def get_cfg() -> Config:
    return _cfg


def update_cfg(**kwargs) -> None:
    _cfg.update(kwargs)


def save_cfg(save_file: str) -> None:
    import yaml

    with open(save_file, "w") as f:
        f.write(yaml.dump(_cfg.dump()))


def print_cfg() -> None:
    import yaml

    print(yaml.dump(_cfg.dump()))
