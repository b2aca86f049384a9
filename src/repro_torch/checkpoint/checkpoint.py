"""Checkpointing: a tree of tensors <-> ``.npz`` with a JSON manifest.

The port's copy of ``repro.checkpoint.checkpoint``, writing the same files:
``ckpt_{step:08d}.npz`` holds one array per leaf under its key path, and
``manifest.json`` the step, the sorted keys, each leaf's dtype name, the
file name and an optional ``metadata`` document.  A checkpoint written by
either package restores in the other, bit for bit.

Key paths are the JAX package's: a dict key is ``str(key)``, a NamedTuple
field its name, a list or tuple entry its index, joined with ``/``; ``None``
flattens away, so a state without its VR slot or ``h_down`` carries no dead
keys.  The port's flat ``{path: tensor}`` dicts (``"blocks/layer0/mixer/wq"``)
read as the JAX nested dicts' joined paths.  A Python ``int`` leaf (the
optimizer's ``DianaOptState.step``, ``AdamState.count``: 0-dim int32 arrays
in the JAX package) is stored as a 0-dim int32.  bf16 and float8 leaves,
which numpy cannot hold, are stored as their uint16 / uint8 bits with the
real dtype in the manifest.  Writes are atomic (a temp file and
``os.replace``): a crashed save never corrupts the previous checkpoint.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "load_metadata", "participation_restore_hint",
           "controller_restore_hint"]

_MANIFEST = "manifest.json"

# dtypes numpy cannot hold: stored as bit-equal uint views, reached through
# the signed dtype of the same width (torch's own uint16 has few ops):
# name -> (torch dtype, torch signed, numpy signed, numpy unsigned)
_EXOTIC = {
    "bfloat16": (torch.bfloat16, torch.int16, np.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.int8, np.int8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.int8, np.int8, np.uint8),
}


def _dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: numpy's and ml_dtypes' names."""
    return str(dtype).rsplit(".", 1)[-1]


def _children(node):
    """``(path component, child)`` pairs of an inner node, in
    ``jax.tree_util``'s order (a dict's keys sorted, their ``/``-joined
    paths by component), ``None`` children dropped; ``None`` for a leaf."""
    if isinstance(node, Mapping):
        keys = sorted(node, key=lambda k: tuple(str(k).split("/")))
        return [(str(k), node[k]) for k in keys if node[k] is not None]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, v) for f, v in zip(node._fields, node) if v is not None]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node) if v is not None]
    return None


def _check_leaf(node) -> None:
    if isinstance(node, torch.Tensor) or (isinstance(node, int)
                                          and not isinstance(node, bool)):
        return
    raise TypeError(f"checkpoint leaves are tensors or ints, not {type(node).__name__}")


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """``{key path: leaf}`` in flatten order."""
    kids = _children(tree)
    if kids is None:
        _check_leaf(tree)
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for part, child in kids:
        out.update(_flatten(child, f"{prefix}/{part}" if prefix else part))
    return out


def _to_numpy(leaf):
    """A leaf -> ``(dtype name, the array stored)``."""
    if not isinstance(leaf, torch.Tensor):
        return "int32", np.asarray(leaf, np.int32)
    t = leaf.detach()
    name = _dtype_name(t.dtype)
    if name in _EXOTIC:
        _, signed, _, unsigned = _EXOTIC[name]
        return name, t.view(signed).cpu().numpy().view(unsigned)
    return name, t.cpu().numpy()


def save_checkpoint(directory: str, step: int, tree, metadata=None) -> str:
    """Write ``tree`` (nested dicts, NamedTuples, lists and tuples of tensors
    and ints) as the checkpoint of ``step``; returns the npz path.

    ``metadata`` (a JSON-serializable dict, e.g. the serialized
    :class:`~repro_torch.core.policy.CompressionPolicy` that shaped a grouped
    state) rides in the manifest next to the keys and dtypes: read it back
    with :func:`load_metadata` to rebuild a matching template."""
    os.makedirs(directory, exist_ok=True)
    dtypes: Dict[str, str] = {}
    stored: Dict[str, np.ndarray] = {}
    for k, v in _flatten(tree).items():
        dtypes[k], stored[k] = _to_numpy(v)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **stored)
    os.replace(tmp, path)
    manifest = {"step": step, "keys": sorted(stored), "dtypes": dtypes,
                "file": os.path.basename(path)}
    if metadata is not None:
        manifest["metadata"] = metadata
    mtmp = path + ".manifest.tmp"
    with open(mtmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(mtmp, os.path.join(directory, _MANIFEST))
    return path


def _missing(key: str) -> KeyError:
    hint = ""
    parts = key.split("/")
    if "vr" in parts:
        hint = (" — the checkpoint was saved without a VR slot "
                "(vr=False); restore into a matching template or "
                "re-init the VR state after restoring the rest")
    elif "h_down" in parts:
        hint = (" — the checkpoint was saved without a downlink "
                "memory (down_method=None); restore into a matching "
                "template or re-init h_down (zeros) after restoring "
                "the rest")
    return KeyError(f"checkpoint missing leaf {key!r}{hint}")


def _load_leaf(key: str, like, data, dtypes):
    """The stored leaf ``key``, its shape checked against the template
    leaf's, cast to that leaf's dtype (as ``jnp.asarray(arr,
    dtype=leaf.dtype)``) on its device; an ``int`` for an int template, an
    ``nn.Parameter`` for a parameter."""
    if key not in data:
        raise _missing(key)
    arr = data[key]
    saved = dtypes.get(key, str(arr.dtype))
    shape = () if not isinstance(like, torch.Tensor) else tuple(like.shape)
    if tuple(arr.shape) != shape:
        raise ValueError(f"{key}: shape {arr.shape} != template {shape}")
    if not isinstance(like, torch.Tensor):
        return int(arr)
    if saved in _EXOTIC:
        real, _, signed, _ = _EXOTIC[saved]
        t = torch.from_numpy(np.ascontiguousarray(arr).view(signed)).view(real)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    t = t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, nn.Parameter):
        return nn.Parameter(t, requires_grad=like.requires_grad)
    return t


def _rebuild(node, prefix: str, data, dtypes):
    """A tree of ``node``'s own types with each leaf read from ``data``."""
    if node is None:
        return None
    part = lambda k: f"{prefix}/{k}" if prefix else str(k)  # noqa: E731
    if isinstance(node, Mapping):
        return type(node)((k, _rebuild(v, part(k), data, dtypes)) for k, v in node.items())
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_rebuild(v, part(f), data, dtypes)
                            for f, v in zip(node._fields, node)))
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, part(i), data, dtypes) for i, v in enumerate(node))
    _check_leaf(node)
    return _load_leaf(prefix, node, data, dtypes)


def restore_checkpoint(directory: str, template, step: int | None = None):
    """Restore into the structure of ``template``: ``(tree, step)``.

    Each leaf's shape is checked against the template's (``ValueError``), it
    is cast to the template leaf's dtype and placed on its device; the tree
    has the template's own types (dicts, lists, NamedTuples, ``int``,
    ``nn.Parameter``).  A leaf the checkpoint lacks raises ``KeyError``
    (naming a missing VR slot or ``h_down``); no checkpoint in
    ``directory`` raises ``FileNotFoundError``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with open(os.path.join(directory, _MANIFEST)) as f:
        dtypes = json.load(f).get("dtypes", {})
    with np.load(path, allow_pickle=False) as data:
        return _rebuild(template, "", data, dtypes), step


def latest_step(directory: str) -> int | None:
    mpath = os.path.join(directory, _MANIFEST)
    if not os.path.exists(mpath):
        return None
    with open(mpath) as f:
        return int(json.load(f)["step"])


def load_metadata(directory: str):
    """The manifest's ``metadata`` dict (``None`` for checkpoints written
    without one)."""
    mpath = os.path.join(directory, _MANIFEST)
    if not os.path.exists(mpath):
        return None
    with open(mpath) as f:
        return json.load(f).get("metadata")


def participation_restore_hint(directory: str, policy) -> str | None:
    """A warning when the restore template's elastic spec differs from the
    one the checkpoint was trained under, else ``None``.

    Participation adds no state leaves, so :func:`restore_checkpoint` cannot
    catch a changed spec; the mismatch is legal (every worker memory is a
    valid h_i), but the step-keyed participation mask then samples a
    different worker sequence from the resume step on.  ``policy`` is the
    restore template's :class:`~repro_torch.core.policy.CompressionPolicy`;
    the saved side is the manifest's ``metadata["policy"]["participation"]``
    (absent: a save without participation)."""
    meta = load_metadata(directory)
    saved = (meta or {}).get("policy", {}).get("participation")
    spec = getattr(policy, "participation", None)
    live = spec.to_json_dict() if spec is not None and not spec.is_trivial else None
    if saved == live:
        return None
    return (
        f"participation spec changed between save and restore "
        f"(checkpoint: {saved!r}, template: {live!r}) — state shapes are "
        f"unaffected, but the step-keyed participation mask (and any churn "
        f"schedule) will sample a different worker sequence from step "
        f"{latest_step(directory)} onward; pass the saved spec to resume "
        f"the exact trajectory"
    )


def controller_restore_hint(directory: str, controller) -> str | None:
    """A warning when a resume expects budget-controller state the
    checkpoint does not carry (or carries under another budget), else
    ``None``.

    The controller's state rides the manifest metadata
    (:func:`~repro_torch.core.controller.controller_metadata`), not the npz
    leaves.  ``controller`` is the live
    :class:`~repro_torch.core.controller.BudgetController`, or ``None`` for
    a resume without one (then a checkpoint that carries controller state
    gives the inverse hint)."""
    meta = load_metadata(directory)
    saved = (meta or {}).get("controller")
    if controller is None:
        if saved is None:
            return None
        return (
            f"checkpoint carries budget-controller state (budget "
            f"{saved.get('budget_bits_per_dim')!r} bits/dim, step "
            f"{saved.get('step')!r}) but the resume runs without a "
            f"controller — the policy freezes at whatever the controller "
            f"last emitted; pass --budget-bits-per-dim to keep adapting"
        )
    if saved is None:
        return (
            "checkpoint predates the budget controller (no controller "
            "metadata) — telemetry EMAs and the dwell clock start fresh; "
            "the run steps with the base/warmup policy until "
            f"{controller.interval} steps of new telemetry justify the "
            "first allocation"
        )
    if saved.get("budget_bits_per_dim") != controller.budget_bits_per_dim:
        return (
            f"controller budget changed between save and restore "
            f"(checkpoint: {saved.get('budget_bits_per_dim')!r}, live: "
            f"{controller.budget_bits_per_dim!r} bits/dim) — the restored "
            f"telemetry EMAs stay valid, but the next allocation may "
            f"switch policies immediately after the dwell window"
        )
    return None
