"""Checkpoint and resume: a whole simulation state to disk and back.

Counterpart of ``chrono_tpu/io/checkpoint.py`` (``save_checkpoint``,
``load_checkpoint``, ``load_metadata``).  A state is a tree of tensor
dataclasses; a checkpoint is an npz archive with one entry per leaf,
named ``"<index>|<path>"`` in the order and with the paths the JAX
package's pytree flattening gives (a dataclass's fields in declaration
order, its static fields and None fields leaving no leaf), plus optional
JSON metadata.  So a file the JAX package writes for a ``DEMState`` loads
into the port's ``DEMState`` leaf for leaf, and the other way round.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

from chrono_tpu_torch.io.writers import _host
from chrono_tpu_torch.utils.tree import is_static


def _children(node):
    """(name, child) pairs of a dataclass, or None for a leaf."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node) if not is_static(f)]
    return None


def _leaves(node, path=()):
    """(path, leaf) pairs in flattening order; None and strings leave
    none."""
    if node is None or isinstance(node, str):
        return []
    kids = _children(node)
    if kids is None:
        return [("/".join(path), node)]
    out = []
    for key, child in kids:
        out += _leaves(child, path + (key,))
    return out


def save_checkpoint(path: str, state: Any, metadata: dict | None = None):
    """Write a state to ``path`` (.npz) with optional JSON metadata."""
    arrays = {f"{i:04d}|{p}": _host(leaf)
              for i, (p, leaf) in enumerate(_leaves(state))}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **arrays)
    if metadata is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(metadata, f, indent=1)


def _rebuild(node, leaves):
    """``node`` with each of its leaves replaced by the next of
    ``leaves``."""
    if node is None or isinstance(node, str):
        return node
    kids = _children(node)
    if kids is None:
        return next(leaves)
    return dataclasses.replace(node, **{key: _rebuild(child, leaves)
                                        for key, child in kids})


def load_checkpoint(path: str, template: Any) -> Any:
    """Restore a state saved by :func:`save_checkpoint` (by this package
    or the JAX package) into the structure of ``template``: each leaf
    takes the template leaf's dtype and device, and its shape must
    match."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    ordered = [data[k] for k in sorted(data.files,
                                       key=lambda s: int(s.split("|")[0]))]
    tmpl = _leaves(template)
    if len(ordered) != len(tmpl):
        raise ValueError(f"checkpoint has {len(ordered)} leaves, template "
                         f"has {len(tmpl)}")
    new = []
    for (_, t), arr in zip(tmpl, ordered):
        t = t if isinstance(t, torch.Tensor) else torch.as_tensor(t)
        if tuple(t.shape) != arr.shape:
            raise ValueError(f"shape mismatch {tuple(t.shape)} vs "
                             f"{arr.shape}")
        new.append(torch.as_tensor(arr).to(dtype=t.dtype, device=t.device))
    return _rebuild(template, iter(new))


def load_metadata(path: str) -> dict:
    with open(path + ".meta.json") as f:
        return json.load(f)
