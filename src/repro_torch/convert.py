"""Load JAX-package state (as numpy) into the port.

``params_from_jax`` turns the JAX parameter tree (a nested dict of numpy
arrays, e.g. ``jax.tree_util.tree_map(np.asarray, params)``) into the port's
``{path: nn.Parameter}`` tree; ``state_from_jax`` does the same for a
``repro.core.diana.ReferenceState`` (``h_worker``, ``h_server``, ``v``, and
the VR slot's ``snapshot`` / ``mu`` and ``h_down`` when present), flat or
grouped (dicts keyed by group name, a list of arrays for a per-leaf group);
``adam_state_from_jax`` turns the inner optimizer's
``repro.optim.optimizers.AdamState`` into the port's, and
``caches_from_jax`` the serving caches of ``repro.models.init_caches``
(after decode steps or not) into the port's.  Arrays are copied bit
for bit and keep their JAX dtypes: a bf16 model's f32 leaves (the MoE
router, the SSD scalars ``dt_bias`` / ``A_log`` / ``D``) stay f32.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from repro_torch.core.diana import ReferenceState
from repro_torch.core.tree import flatten_nested
from repro_torch.core.vr import VRState
from repro_torch.models.layers import AttnCache
from repro_torch.models.mamba2 import MambaCache
from repro_torch.optim.optimizers import AdamState

__all__ = ["params_from_jax", "state_from_jax", "adam_state_from_jax", "caches_from_jax",
           "tensor_from_numpy"]


def tensor_from_numpy(a, device, dtype=None) -> torch.Tensor:
    """A numpy array (bf16 arrives as ``ml_dtypes.bfloat16``) -> tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def params_from_jax(np_tree: Mapping[str, Any], cfg, device) -> Dict[str, nn.Parameter]:
    """The JAX parameter tree -> ``{path: nn.Parameter}``, each leaf in its
    JAX dtype (``cfg`` names the model the tree belongs to)."""
    return {p: nn.Parameter(tensor_from_numpy(a, device))
            for p, a in flatten_nested(np_tree).items()}


def adam_state_from_jax(adam_state, device) -> AdamState:
    """``AdamState(mu, nu, count)`` with numpy leaves (nested ``mu`` / ``nu``
    trees, a 0-dim int32 ``count``) -> the port's, ``count`` a Python int."""
    return AdamState(mu=_tree(adam_state.mu, device), nu=_tree(adam_state.nu, device),
                     count=int(np.asarray(adam_state.count)))


def _leaf(a, device):
    """An array, or a per-leaf group's list of arrays."""
    if isinstance(a, (list, tuple)):
        return [tensor_from_numpy(x, device) for x in a]
    return tensor_from_numpy(a, device)


def _tree(x, device):
    if x is None:
        return None
    if isinstance(x, Mapping):
        return {p: _leaf(a, device) for p, a in flatten_nested(x).items()}
    return tensor_from_numpy(x, device)


def state_from_jax(ref_state, device) -> ReferenceState:
    """``ReferenceState`` (numpy leaves, bucketed or per-leaf) -> the port's."""
    vr = ref_state.vr
    if vr is not None:
        vr = VRState(snapshot=_tree(vr.snapshot, device), mu=_tree(vr.mu, device))
    return ReferenceState(h_worker=_tree(ref_state.h_worker, device),
                          h_server=_tree(ref_state.h_server, device),
                          v=_tree(ref_state.v, device), vr=vr,
                          h_down=_tree(ref_state.h_down, device))


def _cache_leaf(a, device) -> torch.Tensor:
    """A cache leaf; the JAX package stores a bf16 KV cache's bits as
    uint16, read here as the bf16 it holds (through int16: torch has little
    uint16 support)."""
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return tensor_from_numpy(a, device)


def caches_from_jax(np_caches, device) -> tuple:
    """The JAX caches (per pattern position an ``AttnCache`` (k, v, pos) or
    a ``MambaCache`` (conv, ssm, pos), numpy leaves stacked over the blocks)
    -> the port's, ``pos`` carried across."""
    out = []
    for c in np_caches:
        kind = AttnCache if hasattr(c, "k") else MambaCache
        out.append(kind(*(_cache_leaf(getattr(c, f), device) for f in kind._fields)))
    return tuple(out)
