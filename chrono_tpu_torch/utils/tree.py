"""Plain dataclasses of tensors (the role of ``chrono_tpu.utils.pytree``).

The JAX package registers its data carriers as pytrees so that ``jit``,
``vmap`` and ``lax.scan`` can walk them.  PyTorch runs eagerly and needs no
registry: a carrier is a frozen dataclass with a ``replace`` method.
Fields marked with :func:`static_field` are configuration (floats, ints),
not tensors: stacking motor profiles and converting from numpy keep them
as they are.
"""

from __future__ import annotations

import dataclasses

import torch


def static_field(**kwargs):
    """A dataclass field that holds configuration, not a tensor."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def is_static(field: dataclasses.Field) -> bool:
    return bool(field.metadata.get("static", False))


#: class name → class of every carrier, for ``io.archive``
REGISTRY: dict[str, type] = {}


def tensor_dataclass(cls):
    """Decorator: a frozen dataclass with ``replace(**changes)``, entered in
    :data:`REGISTRY` under its name."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    if REGISTRY.setdefault(cls.__name__, cls) is not cls:
        raise TypeError(f"two carriers named {cls.__name__}")
    return cls


def fields_as_tensors(obj, like):
    """``obj`` with every non-static field that holds a number turned into
    a 0-d tensor of ``like``'s dtype and device.  Tensor fields are kept as
    they are (no copy), so once a carrier's fields live on the card a CUDA
    graph can capture the functions that call this."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if not is_static(f) and isinstance(v, (int, float)):
            changes[f.name] = torch.tensor(float(v), dtype=like.dtype,
                                           device=like.device)
    return dataclasses.replace(obj, **changes) if changes else obj
