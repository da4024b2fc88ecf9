"""Generic name -> object registries.

Copy of ``semireward_tpu/registry.py`` (framework-free, carried into the
port so that it never imports the JAX package). Registration is explicit at
import time of ``semireward_tpu_torch.algorithms`` / ``.models``.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Tuple


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, object] = {}

    @property
    def name(self) -> str:
        return self._name

    def _do_register(self, name: str, obj: object) -> None:
        if name in self._obj_map:
            raise KeyError(
                f"An object named '{name}' was already registered in "
                f"'{self._name}' registry!"
            )
        self._obj_map[name] = obj

    def register(self, obj: object = None, *, name: Optional[str] = None):
        """Use as decorator (`@REG.register()` / `@REG.register('alias')`)
        or as a function call (`REG.register(obj, name='x')`)."""
        if obj is None or isinstance(obj, str):
            alias = obj if isinstance(obj, str) else name

            def deco(fn_or_class):
                key = alias or fn_or_class.__name__.lower()
                self._do_register(key, fn_or_class)
                return fn_or_class

            return deco
        key = name or getattr(obj, "__name__", None)
        if key is None:
            raise ValueError("Provide a name when registering a plain object")
        self._do_register(key.lower() if name is None else key, obj)
        return obj

    def get(self, name: str) -> object:
        ret = self._obj_map.get(name)
        if ret is None:
            raise KeyError(
                f"No object named '{name}' found in '{self._name}' registry! "
                f"Available: {sorted(self._obj_map)}"
            )
        return ret

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def __iter__(self) -> Iterator[Tuple[str, object]]:
        return iter(self._obj_map.items())

    def keys(self):
        return self._obj_map.keys()


ALGORITHMS = Registry("ALGORITHMS")
IMB_ALGORITHMS = Registry("IMB_ALGORITHMS")
NETS = Registry("NETS")
DATASETS = Registry("DATASETS")
