"""Checkpoint / restore for the port's streaming state objects.

Port of :mod:`yagi_tpu.utils.checkpoint`. Every stateful object of the port
is a frozen ``@struct.state`` dataclass whose non-static fields hold its
stream state, so a checkpoint is the list of those leaves: the non-static
fields in declaration order, recursing into nested states, tuples and
lists, and into dicts in sorted key order (``jax.tree_util``'s order), with
``None`` skipped. ``save_state`` writes them as numpy arrays to an ``.npz``
under the port's own magic string; ``load_state`` restores them into a
structurally identical template (the same ``create()`` configuration),
checking the leaf count, shapes and dtypes, each leaf on the template
leaf's device and dtype. A field that holds a Python number comes back as
the same Python type.

Static configuration (lengths, rates, modes) is not serialized: it comes
from the template. A restored object continues the stream bit-identically
(tests/test_torch_cvsd_checkpoint.py). Not to be confused with
:func:`yagi_tpu_torch._src.struct.load_state`, which builds a port object
from a yagi_tpu object's fields.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["save_state", "load_state", "state_leaves"]

_MAGIC = "yagi_tpu_torch_ckpt_v1"


def _is_state(obj) -> bool:
    return dataclasses.is_dataclass(obj) and not isinstance(obj, type) and hasattr(obj, "replace")


def _leaves(obj) -> list:
    """The dynamic leaves of ``obj`` (a state, or a tuple, list or dict of
    them), tensors and Python numbers, in checkpoint order."""
    if obj is None:
        return []
    if _is_state(obj):
        return [leaf for f in dataclasses.fields(obj) if not f.metadata.get("static", False)
                for leaf in _leaves(getattr(obj, f.name))]
    if isinstance(obj, (tuple, list)):
        return [leaf for v in obj for leaf in _leaves(v)]
    if isinstance(obj, dict):
        return [leaf for k in sorted(obj) for leaf in _leaves(obj[k])]
    return [obj]


def _rebuild(obj, new):
    """``obj`` with its leaves taken in order from the iterator ``new``."""
    if obj is None:
        return None
    if _is_state(obj):
        return obj.replace(**{f.name: _rebuild(getattr(obj, f.name), new)
                              for f in dataclasses.fields(obj)
                              if not f.metadata.get("static", False)})
    if isinstance(obj, (tuple, list)):
        return type(obj)(_rebuild(v, new) for v in obj)
    if isinstance(obj, dict):
        rebuilt = {k: _rebuild(obj[k], new) for k in sorted(obj)}
        return {k: rebuilt[k] for k in obj}
    return next(new)


def _host(leaf) -> np.ndarray:
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def state_leaves(obj) -> list[np.ndarray]:
    """The dynamic (serialized) leaves of a state object, or of a tuple,
    list or dict of them, on the host."""
    return [_host(leaf) for leaf in _leaves(obj)]


def save_state(path, obj) -> None:
    """Serialize the dynamic leaves of ``obj`` to the ``.npz`` at ``path``."""
    leaves = state_leaves(obj)
    np.savez(path, __magic__=np.asarray(_MAGIC), __n_leaves__=np.asarray(len(leaves)),
             **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})


def load_state(path, template):
    """Restore a state saved by :func:`save_state` into ``template``, a
    structurally identical object (typically a freshly ``create()``-ed one
    with the same configuration). Returns a new object with the template's
    statics and the checkpoint's leaves, each on the template leaf's device;
    ``ValueError`` where the count, a shape or a dtype differs."""
    data = np.load(path, allow_pickle=False)
    if "__magic__" not in data or str(data["__magic__"]) != _MAGIC:
        raise ValueError(f"not a yagi_tpu_torch checkpoint: {path}")
    tleaves = _leaves(template)
    n = int(data["__n_leaves__"])
    if n != len(tleaves):
        raise ValueError(f"checkpoint/template structure mismatch: {n} saved leaves vs "
                         f"{len(tleaves)} in template")
    new = []
    for i, tl in enumerate(tleaves):
        arr, tarr = data[f"leaf_{i}"], _host(tl)
        if arr.shape != tarr.shape or arr.dtype != tarr.dtype:
            raise ValueError(f"leaf {i}: checkpoint {arr.dtype}{arr.shape} vs template "
                             f"{tarr.dtype}{tarr.shape}")
        if isinstance(tl, torch.Tensor):
            new.append(torch.from_numpy(arr.copy()).to(device=tl.device, dtype=tl.dtype))
        else:  # a Python number comes back as its own type
            new.append(type(tl)(arr.item()))
    return _rebuild(template, iter(new))
