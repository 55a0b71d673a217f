"""String-keyed component registries.

Same public surface as `jnerf_tpu/utils/registry.py`: named registries map
type strings to classes, and ``build_from_cfg`` recursively instantiates
``dict(type=..., **kwargs)`` specs.  The port keeps its own registries so
that building a component never imports the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class Registry:
    """A name -> class mapping with a decorator-style registration API."""

    def __init__(self, name: str = ""):
        self.name = name
        self._modules: Dict[str, Any] = {}

    def register_module(self, name: Optional[str] = None, module: Any = None):
        def _register(mod):
            key = name if name is not None else mod.__name__
            if key in self._modules:
                raise KeyError(f"{key!r} is already registered in {self.name or 'registry'}.")
            self._modules[key] = mod
            return mod

        if module is not None:
            return _register(module)
        return _register

    def get(self, name: str):
        if name not in self._modules:
            raise KeyError(
                f"{name!r} is not registered in {self.name or 'registry'}; "
                f"known: {sorted(self._modules)}"
            )
        return self._modules[name]

    def __contains__(self, name: str) -> bool:
        return name in self._modules

    def keys(self):
        return self._modules.keys()


def build_from_cfg(cfg, registry: Registry, **kwargs):
    """Instantiate a component from a config node.

    - str            -> look up the class and call it with **kwargs
    - dict(type=...) -> pop 'type', call the class with remaining keys + kwargs
    - list           -> build each element (returned as a plain list)
    - None           -> None
    """
    if cfg is None:
        return None
    if isinstance(cfg, str):
        return registry.get(cfg)(**kwargs)
    if isinstance(cfg, dict):
        args = dict(cfg)
        args.update(kwargs)
        obj_type = args.pop("type")
        obj_cls = registry.get(obj_type)
        return obj_cls(**args)
    if isinstance(cfg, (list, tuple)):
        return [build_from_cfg(c, registry, **kwargs) for c in cfg]
    raise TypeError(f"unsupported config node type {type(cfg)}")


DATASETS = Registry("DATASETS")
ENCODERS = Registry("ENCODERS")
NETWORKS = Registry("NETWORKS")
SAMPLERS = Registry("SAMPLERS")
LOSSES = Registry("LOSSES")
OPTIMS = Registry("OPTIMS")
SCHEDULERS = Registry("SCHEDULERS")
