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

On a model mesh (``--mesh NxM``, M > 1) a rank holds shards:
``params_shard_from_jax`` takes its shard of each global JAX array, and
``gather_train_state`` / ``shard_train_state`` move a trainer's state
between the ranks' shards and the global arrays of the JAX trainer's state
on the same mesh (parameters and the inner optimizer's buffers whole; a
per-leaf memory ``h_worker`` ``(N, d)`` and ``h_server`` ``(d,)`` whose
model-split leaves lay the shards' flattened memories end to end, shard 0
first, as ``h_flat_specs``' ``P("model")`` lays them out).  Served over a
mesh, ``caches_shard_from_jax`` takes a rank's shard of each JAX cache leaf
(the placement a rank of the port holds, ``held_cache_specs``) and
``caches_to_global`` gathers the ranks' caches back into the global arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from repro_torch.core import transport
from repro_torch.core.diana import DianaState, ReferenceState
from repro_torch.core.tree import flatten_nested
from repro_torch.launch.sharding_rules import (cache_specs, gather_caches, gather_leaf,
                                               h_flat_specs, held_cache_specs, param_specs,
                                               shard_caches, shard_leaf)
from repro_torch.core.vr import VRState
from repro_torch.models.layers import AttnCache
from repro_torch.models.mamba2 import MambaCache
from repro_torch.models.transformer import param_shapes
from repro_torch.optim.optimizers import AdamState

__all__ = ["params_from_jax", "state_from_jax", "adam_state_from_jax", "caches_from_jax",
           "tensor_from_numpy", "params_shard_from_jax", "gather_train_state",
           "shard_train_state", "caches_shard_from_jax", "caches_to_global"]


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


def params_shard_from_jax(np_tree: Mapping[str, Any], cfg, device, model: int,
                          index: int) -> Dict[str, nn.Parameter]:
    """Shard ``index`` of a model axis of size ``model`` of each leaf of the
    JAX parameter tree (global numpy arrays), by ``param_specs``."""
    flat = flatten_nested(np_tree)
    specs = param_specs({p: np.shape(a) for p, a in flat.items()}, cfg, model)
    return {p: nn.Parameter(shard_leaf(tensor_from_numpy(a, device), specs[p], model, index))
            for p, a in flat.items()}


def _map_inner(inner, fn):
    """The inner optimizer's state with ``fn(path, tensor)`` on each
    parameter-shaped buffer (momentum's dict, AdamW's ``mu`` / ``nu``)."""
    if isinstance(inner, AdamState):
        return inner._replace(mu={p: fn(p, x) for p, x in inner.mu.items()},
                              nu={p: fn(p, x) for p, x in inner.nu.items()})
    return {p: fn(p, x) for p, x in inner.items()}


def gather_train_state(params, opt_state, cfg, mesh, groups):
    """This rank's shards (parameters and a per-leaf ``DianaOptState`` with
    its own ``h_worker`` row) -> ``(params, opt_state)`` as the JAX trainer's
    global arrays on the same mesh; collective over the rank's model and
    data groups (a :class:`~repro_torch.launch.mesh.MeshGroups`), every
    rank gets the whole."""
    specs = param_specs(param_shapes(cfg), cfg, mesh.model)
    hspecs = h_flat_specs(specs)
    whole = lambda p, x: gather_leaf(x, specs[p], groups.model)  # noqa: E731
    # a memory's flat dimension is its last (h_worker's row leads)
    flat = lambda p, h: gather_leaf(h, None if hspecs[p] is None else h.dim() - 1,  # noqa: E731
                                    groups.model)
    d = opt_state.diana
    h_w = {p: transport.all_gather_bytes(flat(p, h)[0], mesh.n_workers, groups.data)
           for p, h in d.h_worker.items()}
    diana = DianaState(h_worker=h_w, h_server={p: flat(p, h) for p, h in d.h_server.items()})
    return ({p: whole(p, x) for p, x in params.items()},
            opt_state._replace(inner=_map_inner(opt_state.inner, whole), diana=diana))


def shard_train_state(params, opt_state, cfg, mesh, worker: int, shard: int):
    """The inverse of :func:`gather_train_state`: the global arrays ->
    worker ``worker``'s shard ``shard`` (parameters as ``nn.Parameter``,
    ``h_worker`` the worker's row)."""
    m = mesh.model
    specs = param_specs(params, cfg, m)
    hspecs = h_flat_specs(specs)
    part = lambda p, x: shard_leaf(x, specs[p], m, shard)  # noqa: E731
    flat = lambda p, h: shard_leaf(h, None if hspecs[p] is None else h.dim() - 1,  # noqa: E731
                                   m, shard)
    d = opt_state.diana
    diana = DianaState(h_worker={p: flat(p, h[worker:worker + 1]) for p, h in d.h_worker.items()},
                       h_server={p: flat(p, h) for p, h in d.h_server.items()})
    return ({p: nn.Parameter(part(p, x.detach()).clone()) for p, x in params.items()},
            opt_state._replace(inner=_map_inner(opt_state.inner,
                                                lambda p, x: part(p, x).clone()), diana=diana))


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


def caches_shard_from_jax(np_caches, cfg, mesh, rank: int, device="cpu") -> tuple:
    """Rank ``rank``'s shard of the JAX caches (global numpy leaves, as
    :func:`caches_from_jax` reads them) on ``mesh``, as the port holds it
    (:func:`~repro_torch.launch.sharding_rules.held_cache_specs`: the JAX
    ``cache_specs`` with the Mamba-2 caches whole over ``model``)."""
    whole = caches_from_jax(np_caches, device)
    specs = cache_specs(whole, cfg, mesh, batch=whole[0][0].shape[1])   # leaves (nb, B, ...)
    return shard_caches(whole, held_cache_specs(specs), mesh, *mesh.coords(rank))


def caches_to_global(caches, cfg, mesh, groups, shape) -> tuple:
    """The ranks' caches for ``shape`` (a decode ShapeConfig) gathered into
    the global arrays on every rank (collective over ``groups``, a
    :class:`~repro_torch.launch.mesh.MeshGroups`)."""
    from repro_torch.launch.serve import serve_cache_shardings

    return gather_caches(caches, held_cache_specs(serve_cache_shardings(cfg, mesh, shape)[0]),
                         groups)
