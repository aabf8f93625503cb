"""Hierarchical configuration system.

Port of nerficg_tpu/core/config.py (reference: src/Framework.py:39-212): a
YAML file becomes a nested attribute-access tree, ``KEY.SUBKEY=value`` CLI
overrides are parsed with ``ast.literal_eval``, and every component declares
typed defaults that are merged with the loaded section.
"""

from __future__ import annotations

import ast
import copy
from pathlib import Path
from typing import Any, Iterable, Mapping

import yaml

from nerficg_torch.core.logging import Logger

__all__ = [
    'ConfigNode', 'Configurable', 'load_config', 'save_config',
    'apply_overrides', 'recursive_update', 'default_global_config',
]


class ConfigNode(dict):
    """Nested dict with attribute access; the framework's config tree node."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        source = dict(*args, **kwargs)
        for key, value in source.items():
            self[key] = self._wrap(value)

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, ConfigNode):
            return value
        if isinstance(value, Mapping):
            return ConfigNode(value)
        if isinstance(value, (list, tuple)):
            return type(value)(ConfigNode._wrap(v) for v in value)
        return value

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(
                f'config key {name!r} not found (available: {sorted(self.keys())})'
            ) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = self._wrap(value)

    def __setitem__(self, key, value):
        super().__setitem__(key, self._wrap(value))

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split('.'):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split('.')
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], ConfigNode):
                node[part] = ConfigNode()
            node = node[part]
        node[parts[-1]] = value

    def to_dict(self) -> dict:
        out = {}
        for key, value in self.items():
            if isinstance(value, ConfigNode):
                out[key] = value.to_dict()
            elif isinstance(value, (list, tuple)):
                out[key] = [v.to_dict() if isinstance(v, ConfigNode) else v for v in value]
            else:
                out[key] = value
        return out


def recursive_update(base: ConfigNode, update: Mapping, warn_unknown: bool = False,
                     _prefix: str = '') -> ConfigNode:
    """Recursively overlay ``update`` onto ``base`` (reference: Framework.py:39-53)."""
    for key, value in update.items():
        if warn_unknown and key not in base:
            Logger.warning(f'unknown config parameter: {_prefix}{key}')
        if isinstance(value, Mapping) and isinstance(base.get(key), Mapping):
            recursive_update(base[key], value, warn_unknown, _prefix=f'{_prefix}{key}.')
        else:
            base[key] = value
    return base


def default_global_config() -> ConfigNode:
    """Global defaults (reference: Framework.py:202-212)."""
    return ConfigNode({
        'LOG_LEVEL': 'NORMAL',
        'RANDOM_SEED': 42,
        'FILTER_WARNINGS': True,
        'METHOD_TYPE': None,
        'DATASET_TYPE': None,
    })


def _parse_override_value(raw: str) -> Any:
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw  # plain string


def apply_overrides(config: ConfigNode, overrides: Iterable[str]) -> ConfigNode:
    """Apply CLI ``KEY.SUBKEY=value`` overrides (reference: Framework.py:184-199)."""
    for item in overrides:
        if '=' not in item:
            raise ValueError(f'invalid override (expected KEY=VALUE): {item!r}')
        key, _, raw = item.partition('=')
        config.set_path(key.strip(), _parse_override_value(raw.strip()))
    return config


def load_config(path: str | Path | None, overrides: Iterable[str] = ()) -> ConfigNode:
    """Load a YAML config file, merge onto global defaults, apply overrides
    (reference: Framework.load_config, Framework.py:163-199)."""
    config = ConfigNode({'GLOBAL': default_global_config()})
    if path is not None:
        path = Path(path)
        if not path.is_file():
            from nerficg_torch.core.errors import ConfigError
            raise ConfigError(f'config file not found: {path}')
        with open(path) as f:
            loaded = yaml.safe_load(f) or {}
        recursive_update(config, loaded)
    if overrides:
        apply_overrides(config, overrides)
    return config


def save_config(config: ConfigNode, path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, 'w') as f:
        yaml.safe_dump(config.to_dict(), f, default_flow_style=None, sort_keys=False)


class Configurable:
    """Mixin: classes declare config defaults; instances get them as attributes.

    Reference equivalent: ``Framework.Configurable`` (src/Framework.py:73-108).
    Defaults declared with the ``configure`` class decorator merge up the MRO;
    at construction the config section named by ``config_section`` is laid
    over them and every parameter becomes an instance attribute.
    """

    _config_defaults: dict = {}

    def __init__(self, config: ConfigNode | None, config_section: str):
        defaults = ConfigNode(self.default_parameters())
        section = None if config is None else config.get(config_section)
        if section is not None:
            for key in section:
                if key not in defaults:
                    Logger.warning(
                        f'{type(self).__name__}: unknown config parameter '
                        f'{config_section}.{key} (ignored defaults merge, kept)')
            recursive_update(defaults, section)
        self._configuration = defaults
        for key, value in defaults.items():
            setattr(self, key, value)

    @classmethod
    def default_parameters(cls) -> dict:
        """Merge ``_config_defaults`` up the MRO (reference: Framework.py:103-106)."""
        merged: dict = {}
        for klass in reversed(cls.__mro__):
            merged.update(getattr(klass, '_config_defaults', {}) or {})
        return copy.deepcopy(merged)

    @staticmethod
    def configure(**defaults):
        def decorator(cls):
            cls._config_defaults = defaults
            return cls
        return decorator
