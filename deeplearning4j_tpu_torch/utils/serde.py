"""Polymorphic JSON serde for config dataclasses.

Every config dataclass registers itself under its class name; dicts carry a
``"@type"`` discriminator so config trees (layers, updaters, schedules,
distributions) round-trip through JSON. The wire form is the JAX package's
(``deeplearning4j_tpu/utils/serde.py``) byte for byte: the same class names,
the same field order, the same ``json.dumps`` call, so a ``config.json``
written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import typing

_REGISTRY: dict[str, type] = {}

# modules whose import registers config classes (imported lazily: doing it
# at module load would create an import cycle)
_CATALOG_MODULES = ("deeplearning4j_tpu_torch.nn.layers",
                    "deeplearning4j_tpu_torch.nn.conf.inputs",
                    "deeplearning4j_tpu_torch.nn.conf.network",
                    "deeplearning4j_tpu_torch.nn.graph",
                    "deeplearning4j_tpu_torch.nn.fusion",
                    "deeplearning4j_tpu_torch.nn.initializers",
                    "deeplearning4j_tpu_torch.nn.updaters",
                    "deeplearning4j_tpu_torch.nn.constraints")


def register_config(cls):
    """Class decorator: make a dataclass JSON round-trippable by name."""
    _REGISTRY[cls.__name__] = cls
    return cls


def _prime_catalog():
    import importlib
    for mod in _CATALOG_MODULES:
        importlib.import_module(mod)


def lookup(name: str) -> type:
    if name not in _REGISTRY:
        _prime_catalog()  # registry may simply not be populated yet
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"Unknown config type {name!r}: it is not ported to "
            f"deeplearning4j_tpu_torch yet. Registered: "
            f"{sorted(_REGISTRY)}") from None


def config_to_dict(obj):
    """Recursively convert a registered dataclass tree to plain JSON types."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, (list, tuple)):
        return [config_to_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: config_to_dict(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        d = {"@type": type(obj).__name__}
        for f in dataclasses.fields(obj):
            d[f.name] = config_to_dict(getattr(obj, f.name))
        return d
    # numpy / torch scalars and arrays
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return obj.item()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    raise TypeError(f"Cannot serialize {type(obj)}: {obj!r}")


def config_from_dict(d):
    if isinstance(d, list):
        return [config_from_dict(v) for v in d]
    if isinstance(d, dict):
        if "@enum" in d:
            return lookup(d["@enum"])[d["value"]]
        if "@type" in d:
            cls = lookup(d["@type"])
            fields = {f.name for f in dataclasses.fields(cls)}
            kwargs = {k: config_from_dict(v) for k, v in d.items() if k in fields}
            # tuple-typed fields arrive as lists from JSON
            hints = typing.get_type_hints(cls)
            for f in dataclasses.fields(cls):
                hint = hints.get(f.name)
                if (hint is tuple or typing.get_origin(hint) is tuple) and \
                        isinstance(kwargs.get(f.name), list):
                    kwargs[f.name] = tuple(kwargs[f.name])
            return cls(**kwargs)
        return {k: config_from_dict(v) for k, v in d.items()}
    return d


def to_json(obj, **kwargs) -> str:
    return json.dumps(config_to_dict(obj), **kwargs)


def from_json(s: str):
    return config_from_dict(json.loads(s))
