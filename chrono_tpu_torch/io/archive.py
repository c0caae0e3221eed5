"""Versioned object archive: any carrier ↔ JSON.

Counterpart of ``chrono_tpu/io/archive.py`` (the reference's ``ChArchive``
and class factory): registry-driven (de)serialisation of whole scenes — a
``Model`` with its joints, motors and springs round-trips through one JSON
document, its carriers rebuilt from ``utils.tree.REGISTRY`` (each node
names its class and the module that defines it).  Tensors are stored
inline with their dtype, shape and device and come back bit for bit;
bulk state belongs in ``io.checkpoint`` instead.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from typing import Any

import numpy as np
import torch

from chrono_tpu_torch.utils.tree import REGISTRY

ARCHIVE_VERSION = 1


def _encode(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, torch.Tensor):
        return {"__tensor__": obj.detach().cpu().tolist(),
                "dtype": str(obj.dtype).removeprefix("torch."),
                "shape": list(obj.shape), "device": str(obj.device)}
    if isinstance(obj, (np.ndarray, np.generic)):
        a = np.asarray(obj)
        return {"__array__": a.tolist(), "dtype": str(a.dtype),
                "shape": list(a.shape)}
    cls = type(obj)
    if dataclasses.is_dataclass(obj) and REGISTRY.get(cls.__name__) is cls:
        return {"__class__": cls.__name__, "module": cls.__module__,
                "fields": {f.name: _encode(getattr(obj, f.name))
                           for f in dataclasses.fields(obj) if f.init}}
    if isinstance(obj, dict):
        return {"__dict__": {k: _encode(v) for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {"__seq__": [_encode(v) for v in obj],
                "tuple": isinstance(obj, tuple)}
    raise TypeError(f"cannot archive {cls.__name__}: not a registered "
                    "carrier or a primitive")


def _decode(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if "__tensor__" in obj:
        return torch.tensor(obj["__tensor__"],
                            dtype=getattr(torch, obj["dtype"]),
                            device=obj["device"]).reshape(obj["shape"])
    if "__array__" in obj:
        return np.asarray(obj["__array__"],
                          dtype=obj["dtype"]).reshape(obj["shape"])
    if "__class__" in obj:
        importlib.import_module(obj["module"])
        cls = REGISTRY[obj["__class__"]]
        return cls(**{k: _decode(v) for k, v in obj["fields"].items()})
    if "__dict__" in obj:
        return {k: _decode(v) for k, v in obj["__dict__"].items()}
    if "__seq__" in obj:
        seq = [_decode(v) for v in obj["__seq__"]]
        return tuple(seq) if obj["tuple"] else seq
    raise TypeError(f"cannot decode archive node: {obj!r}")


def archive_out(obj: Any, path: str | None = None) -> str:
    """Serialise to a JSON string (and write it to ``path`` if given)."""
    s = json.dumps({"archive_version": ARCHIVE_VERSION,
                    "root": _encode(obj)})
    if path is not None:
        with open(path, "w") as f:
            f.write(s)
    return s


def archive_in(source: str) -> Any:
    """Deserialise from a JSON string or a file path; every tensor comes
    back on the device it was archived from."""
    if source.lstrip().startswith("{"):
        doc = json.loads(source)
    else:
        with open(source) as f:
            doc = json.load(f)
    if doc.get("archive_version", 0) > ARCHIVE_VERSION:
        raise ValueError("archive written by a newer version")
    return _decode(doc["root"])
