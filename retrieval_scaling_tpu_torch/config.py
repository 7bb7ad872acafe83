"""Hierarchical YAML configuration with interpolation and dotlist overrides.

A copy of ``retrieval_scaling_tpu/config.py`` (the port never imports the
JAX package, whose ``__init__`` loads that module), ``config_from_env``
(config.py:299) included. Two changes: ``yaml`` is
imported inside the functions that parse YAML, so the module imports
without PyYAML, and the ``${accel_name:}`` resolver names the CUDA card.
``tests/test_torch_pipeline.py`` holds this copy to the original.

  * ``${a.b.c}`` interpolation, resolved lazily against the *current* tree.
  * ``???`` mandatory-value markers that raise only when accessed.
  * dotlist CLI overrides whose values are YAML-parsed.
  * ``base: <other-config-name>`` for deep-merge inheritance.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Iterator

MISSING = "???"

_INTERP_RE = re.compile(r"\$\{([^{}]+)\}")


class MissingMandatoryValue(Exception):
    """Raised when a ``???`` config value is accessed before being set."""


class ConfigKeyError(KeyError):
    pass


def _accel_name() -> str:
    """Resolver naming the accelerator tier (the reference's ``gpu_name``):
    "h100"/"h200"/"a100"/"l40" from the CUDA device name, "cpu" without one."""
    import torch

    if not torch.cuda.is_available():
        return "cpu"
    name = torch.cuda.get_device_name(0).lower()
    for tier in ("h200", "h100", "a100", "l40"):
        if tier in name:
            return tier
    return name.replace(" ", "_")


_RESOLVERS = {
    "accel_name": lambda *a: _accel_name(),
    "gpu_name": lambda *a: _accel_name(),  # alias for reference-config interop
    "multiply": lambda a, b: float(a) * float(b),
}


class Config:
    """A mapping with attribute access and lazy ``${...}`` interpolation.

    Nodes share a single root so interpolations always resolve against the
    fully-overridden tree.
    """

    __slots__ = ("_data", "_root")

    def __init__(self, data: dict | None = None, _root: "Config | None" = None):
        object.__setattr__(self, "_data", data if data is not None else {})
        object.__setattr__(self, "_root", _root if _root is not None else self)

    # -- access ------------------------------------------------------------
    def _wrap(self, key: str, value: Any) -> Any:
        if isinstance(value, dict):
            return Config(value, _root=self._root)
        if isinstance(value, str):
            return self._resolve_str(key, value)
        if isinstance(value, list):
            return [self._wrap(key, v) for v in value]
        return value

    def _resolve_str(self, key: str, value: str) -> Any:
        if value == MISSING:
            raise MissingMandatoryValue(
                f"Missing mandatory value: {key!r} is '???' — set it via an override"
            )
        m = _INTERP_RE.fullmatch(value)
        if m:
            return self._root._interp(m.group(1))
        if "${" in value:
            def sub(match: re.Match) -> str:
                out = self._root._interp(match.group(1))
                return "" if out is None else str(out)

            return _INTERP_RE.sub(sub, value)
        return value

    def _interp(self, expr: str) -> Any:
        expr = expr.strip()
        if ":" in expr:
            name, _, argstr = expr.partition(":")
            if name in _RESOLVERS:
                args = [a.strip() for a in argstr.split(",")] if argstr else []
                # resolve args that are themselves dotted config paths
                resolved = []
                for a in args:
                    try:
                        resolved.append(self.select(a))
                    except (ConfigKeyError, MissingMandatoryValue, AttributeError):
                        resolved.append(a)
                return _RESOLVERS[name](*resolved)
        return self.select(expr)

    def select(self, dotted: str) -> Any:
        node: Any = self._root
        for part in dotted.split("."):
            if isinstance(node, Config):
                node = node[part]
            elif isinstance(node, list):
                node = node[int(part)]
            else:
                raise ConfigKeyError(f"Cannot descend into {dotted!r} at {part!r}")
        return node

    def __getitem__(self, key: str) -> Any:
        if key not in self._data:
            raise ConfigKeyError(key)
        return self._wrap(key, self._data[key])

    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self[key]
        except ConfigKeyError:
            raise AttributeError(f"Config has no key {key!r}")

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = value._data if isinstance(value, Config) else value

    def __setitem__(self, key: str, value: Any) -> None:
        self.__setattr__(key, value)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def keys(self):
        return self._data.keys()

    def items(self):
        return [(k, self._wrap(k, v)) for k, v in self._data.items()]

    def get(self, key: str, default: Any = None) -> Any:
        if key not in self._data:
            return default
        try:
            return self[key]
        except MissingMandatoryValue:
            return default

    # -- mutation ----------------------------------------------------------
    def set_dotted(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node = self._data
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                node[p] = {}
            node = node[p]
        node[parts[-1]] = value

    def merge_overrides(self, overrides: list[str]) -> None:
        import yaml

        for ov in overrides:
            if "=" not in ov:
                raise ValueError(f"Override {ov!r} must be key=value")
            key, _, raw = ov.partition("=")
            key = key.lstrip("+").strip()
            # reference-config interop: the reference spells batch sizes
            # per-GPU (ric/conf/default.yaml per_gpu_batch_size); here the
            # accelerator-neutral name is canonical
            if key.rsplit(".", 1)[-1] == "per_gpu_batch_size":
                key = key[: -len("per_gpu_batch_size")] + "per_device_batch_size"
            self.set_dotted(key, yaml.safe_load(raw) if raw != "" else None)

    def __deepcopy__(self, memo):
        # A deep copy re-roots at this node (callers clone whole configs to
        # tweak task settings); interpolations then resolve within the copy.
        return Config(copy.deepcopy(self._data, memo))

    # -- export ------------------------------------------------------------
    def to_dict(self, resolve: bool = False) -> dict:
        if not resolve:
            return copy.deepcopy(self._data)

        def conv(node: Any) -> Any:
            if isinstance(node, Config):
                return {k: conv(node._wrap(k, v)) for k, v in node._data.items()}
            if isinstance(node, list):
                return [conv(v) for v in node]
            return node

        return conv(self)

    def pretty(self, resolve: bool = False) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(resolve=resolve), sort_keys=False)

    def __repr__(self) -> str:
        return f"Config({self._data!r})"


def _normalize_interop_keys(tree):
    """Rename reference-config spellings to the canonical ones
    (per_gpu_batch_size -> per_device_batch_size), recursively. When a
    dict carries BOTH spellings, the canonical key wins."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "per_gpu_batch_size":
                if "per_device_batch_size" in tree:
                    continue  # explicit canonical key wins
                k = "per_device_batch_size"
            out[k] = _normalize_interop_keys(v)
        return out
    if isinstance(tree, list):
        return [_normalize_interop_keys(v) for v in tree]
    return tree


def _deep_merge(base: dict, overlay: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def default_config_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def load_config(
    config_name: str,
    config_dir: str | None = None,
    overrides: list[str] | None = None,
) -> Config:
    """Load ``<config_dir>/<config_name>.yaml``, following ``base:`` chains."""
    import yaml

    config_dir = config_dir or default_config_dir()

    def load_tree(name: str, seen: tuple = ()) -> dict:
        if name in seen:
            raise ValueError(f"Config inheritance cycle: {seen + (name,)}")
        path = name if name.endswith((".yaml", ".yml")) else os.path.join(config_dir, name + ".yaml")
        if not os.path.isabs(path) and not os.path.exists(path):
            alt = os.path.join(config_dir, name)
            path = alt if os.path.exists(alt) else path
        with open(path) as f:
            tree = yaml.safe_load(f) or {}
        tree = _normalize_interop_keys(tree)
        base = tree.pop("base", None)
        if base:
            tree = _deep_merge(load_tree(base, seen + (name,)), tree)
        return tree

    cfg = Config(load_tree(config_name))
    if overrides:
        cfg.merge_overrides(overrides)
    return cfg


def config_from_dict(data: dict, overrides: list[str] | None = None) -> Config:
    cfg = Config(copy.deepcopy(data))
    if overrides:
        cfg.merge_overrides(overrides)
    return cfg



def config_from_env(cfg: Config, prefix: str = "RST_OVERRIDE_") -> Config:
    """Apply env-var overrides ``RST_OVERRIDE_FOO__BAR=x`` -> ``foo.bar=x``.

    Mirrors the reference serving tier's ``HYDRA_OVERRIDE_*`` scheme
    (reference: api/serve_worker_node.py:27-48).
    """
    import yaml

    for name, raw in os.environ.items():
        if name.startswith(prefix):
            key = name[len(prefix):].lower().replace("__", ".")
            cfg.set_dotted(key, yaml.safe_load(raw))
    return cfg
