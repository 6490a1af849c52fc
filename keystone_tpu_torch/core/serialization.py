"""Fitted-pipeline persistence — port of
``keystone_tpu/core/serialization.py``.

A fitted node is a dataclass (or a list, tuple, dict or plain object)
holding tensors and static config. :func:`_to_host` moves every tensor
of it to the CPU, once, and marks it; the structure is pickled around the
host arrays, as the JAX package pickles a pytree of host arrays (torch
≥ 2.6 refuses pickled objects in ``torch.load`` by default, and
``torch.save`` would not carry the node classes either). A load puts the
tensors back on the device the caller names, the card by default.

Two formats:

- :func:`save_pipeline` / :func:`load_pipeline` — the bare pickle;
- :func:`save_fitted` / :func:`load_fitted` — the *serving* format: the
  pickle travels with a structural **spec** (node classes, their current
  fields, static values, each tensor's shape and dtype), and the load
  re-derives the spec from the object it rebuilt and refuses drift with
  :class:`PipelineSpecError`: a server must not serve a pipeline whose
  node classes changed shape underneath the checkpoint.

Every write goes through :func:`atomic_write`: a temp name, fsync, rename,
then an fsync of the directory.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import os
import pickle
import types
from typing import Any, Callable

import numpy as np
import torch

_MAGIC = b"KSTT1\n"
_MAGIC_FITTED = b"KSTTF1\n"


def _fsync_dir(dirname: str) -> None:
    """fsync a directory so a just-committed ``os.replace`` survives power
    loss: without it the data blocks are durable but the entry pointing at
    them may not be. Best-effort where the filesystem refuses a directory
    descriptor."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_write(path: str):
    """Write to a temp name beside ``path``, then ``os.replace``: a reader
    (the refit daemon tailing a state file, a reload reading what the
    daemon just published) sees the old complete artifact or the new one,
    never a torn one. Yields the open binary file; the replace happens only
    when the body completes (a failed write keeps the old file and removes
    the temp). The temp is fsynced before the rename and the directory
    after it. The ``ckpt.disk_full`` fault site fires here, keyed by the
    artifact's file name (ENOSPC before the fsync)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            yield f
            from keystone_tpu_torch.resilience import faults as _faults

            _faults.maybe_disk_full(key=os.path.basename(path), note=path)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(os.path.abspath(path)))
    finally:
        with contextlib.suppress(OSError):
            os.unlink(tmp)


class PipelineSpecError(ValueError):
    """The saved pipeline's structure disagrees with what the current code
    rebuilds — other node classes or fields, another leaf count, other
    leaf shapes or dtypes. Loud by design: drift served silently would
    return plausible but wrong predictions."""


class HostTensor:
    """A tensor leaf on its way through a pickle: one host copy of it as a
    numpy array (bfloat16 viewed as int16) and its dtype. A transposed leaf
    stays transposed (numpy pickles it in Fortran order), so a loaded
    model runs the same kernels, and gives the same bits, as the saved
    one."""

    def __init__(self, t: torch.Tensor):
        self.dtype = str(t.dtype).removeprefix("torch.")
        host = t.detach().cpu()
        if host.dtype == torch.bfloat16:
            host = host.view(torch.int16)
        self.array = host.numpy()

    def to(self, device) -> torch.Tensor:
        t = torch.from_numpy(self.array)
        if self.dtype == "bfloat16":
            t = t.view(torch.bfloat16)
        return t.to(device)


_OPAQUE = (
    type, types.ModuleType, types.FunctionType, types.MethodType, types.BuiltinFunctionType,
    functools.partial, torch.Tensor, np.ndarray, torch.device, torch.dtype,
)


def _is_struct(obj: Any) -> bool:
    """A node to walk into: a dataclass instance, or an object with
    attributes that is not a class, module, function, tensor or array."""
    if isinstance(obj, _OPAQUE):
        return False
    return dataclasses.is_dataclass(obj) or hasattr(obj, "__dict__")


def _attrs(obj: Any) -> list[str]:
    """The attribute names a node is walked by: a dataclass's current
    fields (so a field added or removed since the save shows as drift),
    else its instance attributes."""
    if dataclasses.is_dataclass(obj):
        return [f.name for f in dataclasses.fields(obj)]
    return list(vars(obj))


_MISSING = object()


def map_leaves(fn: Callable, obj: Any, is_leaf: Callable[[Any], bool], memo=None) -> Any:
    """``obj`` with every leaf (``is_leaf``) replaced by ``fn(leaf)``,
    walking lists, tuples, dicts and nodes; other values are kept. A node
    is shallow-copied and its walked attributes set on the copy, so the
    original is never changed; a leaf shared by two places maps once."""
    memo = {} if memo is None else memo
    if is_leaf(obj):
        key = id(obj)
        if key not in memo:
            memo[key] = (obj, fn(obj))
        return memo[key][1]
    if isinstance(obj, tuple):
        items = [map_leaves(fn, x, is_leaf, memo) for x in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else type(obj)(items)
    if isinstance(obj, list):
        return [map_leaves(fn, x, is_leaf, memo) for x in obj]
    if isinstance(obj, dict):
        out = copy.copy(obj)
        for k, v in obj.items():
            out[k] = map_leaves(fn, v, is_leaf, memo)
        return out
    if _is_struct(obj):
        out = copy.copy(obj)
        for name in _attrs(obj):
            value = getattr(obj, name, _MISSING)
            if value is not _MISSING:
                object.__setattr__(out, name, map_leaves(fn, value, is_leaf, memo))
        return out
    return obj


def _to_host(node: Any) -> Any:
    """``node`` with every tensor replaced by a :class:`HostTensor`: one
    host copy of each, ready to pickle."""
    return map_leaves(HostTensor, node, lambda x: isinstance(x, torch.Tensor))


def _from_host(node: Any, device) -> Any:
    """The inverse of :func:`_to_host`: each host leaf back to a tensor on
    ``device``."""
    return map_leaves(lambda h: h.to(device), node, lambda x: isinstance(x, HostTensor))


def _load_device(device):
    from keystone_tpu_torch.core.runtime import resolve_device

    return resolve_device(device)


def save_pipeline(node, path: str) -> None:
    """Persist a fitted Transformer/Pipeline (any node) to ``path``,
    atomically."""
    host = _to_host(node)
    with atomic_write(path) as f:
        f.write(_MAGIC)
        pickle.dump(host, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_pipeline(path: str, device=None):
    """Load a pipeline saved by :func:`save_pipeline`, its tensors on
    ``device`` (the card unless the caller asks for the CPU). Also accepts
    the :func:`save_fitted` format, spec-checked as :func:`load_fitted`
    checks it."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC_FITTED))
        if magic == _MAGIC_FITTED:
            return _load_fitted_fh(f, path, _load_device(device))
        if magic[: len(_MAGIC)] != _MAGIC:
            raise ValueError(f"{path} is not a keystone_tpu_torch pipeline checkpoint")
        f.seek(len(_MAGIC))
        return _from_host(pickle.load(f), _load_device(device))


def _structure(obj: Any, leaves: list) -> str:
    if isinstance(obj, (torch.Tensor, HostTensor, np.ndarray)):
        if isinstance(obj, HostTensor):
            shape, dtype = obj.array.shape, obj.dtype
        else:
            shape, dtype = obj.shape, str(obj.dtype).removeprefix("torch.")
        leaves.append({"shape": [int(s) for s in shape], "dtype": dtype})
        return "*"
    if isinstance(obj, (bool, int, float, str, bytes, type(None))):
        return repr(obj)
    if isinstance(obj, (torch.device, torch.dtype)):
        return str(obj)
    if isinstance(obj, (list, tuple)):
        inner = ",".join(_structure(x, leaves) for x in obj)
        return f"{type(obj).__name__}[{inner}]"
    if isinstance(obj, dict):
        inner = ",".join(f"{k!r}:{_structure(v, leaves)}" for k, v in obj.items())
        return "{" + inner + "}"
    if _is_struct(obj):
        parts = []
        for name in _attrs(obj):
            value = getattr(obj, name, _MISSING)
            parts.append(f"{name}={'<missing>' if value is _MISSING else _structure(value, leaves)}")
        return f"{type(obj).__module__}.{type(obj).__qualname__}({','.join(parts)})"
    return type(obj).__qualname__


def pipeline_spec(node) -> dict:
    """The structural identity of a fitted pipeline: the node classes with
    their current fields and static values, plus each tensor's shape and
    dtype — everything that decides the served program and nothing that
    depends on the weights' values."""
    leaves: list = []
    structure = _structure(node, leaves)
    return {"version": 1, "structure": structure, "leaves": leaves}


def _spec_drift(saved: dict, current: dict) -> str | None:
    """First human-readable difference between two specs, or None."""
    if saved.get("structure") != current.get("structure"):
        return (
            "structure differs\n"
            f"  saved:  {saved.get('structure')}\n"
            f"  loaded: {current.get('structure')}"
        )
    a, b = saved.get("leaves", []), current.get("leaves", [])
    if len(a) != len(b):
        return f"leaf count differs: saved {len(a)}, loaded {len(b)}"
    for i, (la, lb) in enumerate(zip(a, b)):
        if la != lb:
            return f"leaf {i} differs: saved {la}, loaded {lb}"
    return None


def save_fitted(node, path: str, **meta) -> dict:
    """Persist a *fitted* pipeline with its structural spec, so a server
    can load it without refitting and refuse it if the code drifted.
    Extra ``meta`` keys ride along verbatim. Returns the spec written."""
    spec = pipeline_spec(node)
    payload = {"spec": spec, "meta": meta, "tree": _to_host(node)}
    with atomic_write(path) as f:
        f.write(_MAGIC_FITTED)
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    return spec


def _load_fitted_fh(f, path: str, device, with_meta: bool = False):
    try:
        payload = pickle.load(f)
        tree, spec = payload["tree"], payload.get("spec") or {}
    except (pickle.UnpicklingError, EOFError, KeyError, TypeError, AttributeError) as e:
        raise PipelineSpecError(f"{path}: unreadable fitted pipeline ({e!r})") from e
    node = _from_host(tree, device)
    drift = _spec_drift(spec, pipeline_spec(node))
    if drift:
        raise PipelineSpecError(
            f"{path}: fitted-pipeline spec drift — the checkpoint was written "
            f"by different code than just rebuilt it; refusing to serve it ({drift})"
        )
    if with_meta:
        return node, payload.get("meta") or {}
    return node


def load_fitted(path: str, with_meta: bool = False, device=None):
    """Load a pipeline saved by :func:`save_fitted`, its tensors on
    ``device`` (the card unless the caller asks for the CPU), verifying
    the stored spec against the rebuilt object. ``with_meta=True`` returns
    ``(node, meta)``. Raises :class:`PipelineSpecError` on drift."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC_FITTED))
        if magic != _MAGIC_FITTED:
            raise ValueError(
                f"{path} is not a keystone_tpu_torch fitted-pipeline checkpoint "
                "(for bare save_pipeline files use load_pipeline)"
            )
        return _load_fitted_fh(f, path, _load_device(device), with_meta=with_meta)
