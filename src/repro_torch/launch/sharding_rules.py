"""Which dimension of each leaf the model axis splits: the counterpart of
``repro.launch.sharding_rules`` (``param_specs``, ``batch_specs``,
``cache_specs``) and of ``repro.launch.train.h_flat_specs``.

The JAX package writes a ``PartitionSpec`` per leaf; the port holds one
worker axis and no FSDP, so a spec here is the index of the dimension split
over the model axis, or None for a replicated leaf.  The rules are the JAX
package's, rule for rule (``repro/launch/sharding_rules.py:47-103``), with
its divisibility fallback (``_fits`` / ``_dim``): a dimension the model axis
does not divide stays whole.  The JAX meshes always carry a ``model`` axis
(of size 1 on ``--mesh Nx1``), and so do these rules: at ``model = 1`` a
"split" leaf is its own single shard.

A rank holds shard ``m`` of a split leaf: the ``m``-th of ``model``
contiguous, equal slices along that dimension (``torch.chunk``), as a
``NamedSharding`` lays a global array out over the model axis.

The serving caches split over the data axes as well (:func:`cache_specs`):
a cache leaf's spec is a :class:`CacheSpec`, the dimension over ``model``
and the one over the flattened ``pod`` / ``data`` axes, and a rank holds
the slice of its worker index (pod-major, as ``P(("pod", "data"))`` lays it
out) along the second and of its model index along the first.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core import transport
from repro_torch.models.sharding import ModelGroup

__all__ = ["param_specs", "undivided", "batch_specs", "h_flat_specs", "shard_leaf",
           "shard_tree", "gather_leaf", "gather_tree", "CacheSpec", "cache_specs",
           "held_cache_specs", "local_shape", "shard_caches", "gather_caches"]


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _rule(names: Sequence[str], shape: tuple, cfg, model: int) -> Optional[int]:
    """One leaf's rule (``spec_for`` in ``param_specs``) before the
    divisibility fallback: the dimension it splits over ``model``, or None
    for a leaf the rules replicate by design.  ``names`` its path
    components, ``shape`` its (stacked) shape."""
    name, nd = names[-1], len(shape)
    lead = 1 if "blocks" in names else 0     # the stacked layer dimension

    if name in ("embed", "lm_head"):
        # the vocabulary stays whole (the token gather), the features split
        return 1
    if name in ("wq", "wk", "wv", "w_in", "w_gate", "in_proj") and nd - lead == 2:
        return lead + 1                            # column-parallel
    if name in ("wo", "w_out", "out_proj") and nd - lead == 2:
        return lead                                # row-parallel
    if "mlp" in names and name in ("w_in", "w_gate", "w_out") and nd - lead == 3:
        # MoE experts (E, D, F) / (E, F, D)
        if cfg.moe and cfg.moe.partition == "expert" and shape[-3] % model == 0:
            return lead
        return lead + 1 if name == "w_out" else lead + 2
    if name == "conv_w":
        return lead + 1
    if name == "w" and "frontend_proj" in names:
        return 1
    # norms, biases, the router, the SSD scalars ...
    return None


def _spec_for(names: Sequence[str], shape: tuple, cfg, model: int) -> Optional[int]:
    """One leaf's spec: its rule's dimension when ``model`` divides it
    (``_fits`` / ``_dim``), else None."""
    dim = _rule(names, shape, cfg, model)
    return dim if dim is not None and shape[dim] % model == 0 else None


def param_specs(tree: Mapping[str, object], cfg, model: int) -> Dict[str, Optional[int]]:
    """``{path: the dimension split over a model axis of size model, or
    None}`` for a parameter tree (``{path: tensor}`` or ``{path: shape}``),
    as ``repro.launch.sharding_rules.param_specs`` on a ``("data",
    "model")`` mesh with no FSDP axes."""
    return {p: _spec_for(p.split("/"), _shape(leaf), cfg, model) for p, leaf in tree.items()}


def undivided(tree: Mapping[str, object], cfg, model: int) -> List[str]:
    """The leaves of ``tree`` that a rule splits but a model axis of size
    ``model`` does not divide, which the fallback keeps whole on every rank;
    the leaves replicated by design (the router, norms, biases) are not
    among them."""
    out = []
    for p, leaf in tree.items():
        dim = _rule(p.split("/"), _shape(leaf), cfg, model)
        if dim is not None and _shape(leaf)[dim] % model:
            out.append(p)
    return out


def batch_specs(batch: Mapping[str, object], mesh) -> Dict[str, Optional[int]]:
    """``{key: 0 when the batch dimension splits over the mesh's ``pod`` and
    ``data`` axes, else None}`` (``batch_specs``: the rows over those axes
    when they divide; a ``node`` axis is not among them, and a mesh with
    neither replicates the batch)."""
    if "pod" not in mesh.axes and "data" not in mesh.axes:
        return {k: None for k in batch}
    rows = mesh.size("pod") * mesh.size("data")
    return {k: 0 if _shape(v)[0] % rows == 0 else None for k, v in batch.items()}


def h_flat_specs(specs: Mapping[str, Optional[int]]) -> Dict[str, Optional[int]]:
    """The flat DIANA memories' specs (``repro/launch/train.py:325``): a
    split leaf's memory splits its one dimension, a replicated leaf's stays
    whole, so that each memory's local length is the flattened local
    gradient shard's."""
    return {p: None if s is None else 0 for p, s in specs.items()}


def shard_leaf(x: torch.Tensor, spec: Optional[int], model: int, index: int) -> torch.Tensor:
    """Shard ``index`` of ``x`` (a contiguous copy with storage of its own,
    so that dropping ``x`` frees it: a slice along the leading dimensions,
    e.g. one layer's experts, is already contiguous, and ``.contiguous()``
    would keep the whole leaf alive; ``x`` itself when replicated)."""
    if spec is None:
        return x
    return x.chunk(model, dim=spec)[index].clone(memory_format=torch.contiguous_format)


def shard_tree(tree: Mapping[str, torch.Tensor], specs: Mapping[str, Optional[int]],
               model: int, index: int) -> Dict[str, torch.Tensor]:
    """Shard ``index`` of every leaf of ``tree``."""
    return {p: shard_leaf(x, specs[p], model, index) for p, x in tree.items()}


def gather_leaf(x: torch.Tensor, spec: Optional[int], mp) -> torch.Tensor:
    """The whole leaf from every shard of ``mp`` (a
    :class:`~repro_torch.models.sharding.ModelGroup`; collective over it),
    ``x`` itself when replicated."""
    if spec is None:
        return x
    parts = transport.all_gather_bytes(x.detach(), mp.size, mp.group)
    return torch.cat(parts.unbind(0), dim=spec)


def gather_tree(tree: Mapping[str, torch.Tensor], specs: Mapping[str, Optional[int]],
                mp) -> Dict[str, torch.Tensor]:
    """Every leaf of ``tree`` gathered whole (the global arrays of the JAX
    package's ``NamedSharding`` over the model axis)."""
    return {p: gather_leaf(x, specs[p], mp) for p, x in tree.items()}


class CacheSpec(NamedTuple):
    """A cache leaf's placement: the dimension split over ``model`` and the
    one split over the data axes (``pod`` and ``data`` flattened), each None
    when the leaf stays whole along that axis."""

    model: Optional[int]
    data: Optional[int]


def _data_size(mesh) -> Optional[int]:
    """The flattened ``pod`` x ``data`` axes, or None when the mesh has
    neither."""
    if "pod" not in mesh.axes and "data" not in mesh.axes:
        return None
    return mesh.size("pod") * mesh.size("data")


def cache_specs(caches, cfg, mesh, *, batch: int) -> tuple:
    """The decode caches' placement (``repro/launch/sharding_rules.py:126``),
    rule for rule: ``caches`` the port's tuple of ``AttnCache`` /
    ``MambaCache`` (tensors, ``meta`` tensors or shapes, stacked over the
    blocks), the result the same tuple with a :class:`CacheSpec` per leaf.

    * ``k`` / ``v`` (nb, B, S, Hkv, Dh): the KV heads over ``model`` when it
      divides them, else ``Dh`` when it divides that; the batch over the
      data axes when they divide it, else the cache's sequence (long_500k's
      batch of 1: sequence parallelism), else neither;
    * ``conv`` (nb, B, W-1, CH) and ``ssm`` (nb, B, H, P, N): the batch over
      the data axes when they divide it, the channels / the SSD heads over
      ``model`` when it divides them;
    * ``pos``: replicated."""
    nd, m = _data_size(mesh), mesh.model
    rows = nd is not None and batch % nd == 0

    def fits(size, n):
        return n is not None and size % n == 0

    def spec_for(field, shape):
        if field in ("k", "v"):
            model = 3 if fits(shape[3], m) else (4 if fits(shape[4], m) else None)
            return CacheSpec(model, 1 if rows else (2 if fits(shape[2], nd) else None))
        if field == "conv":
            return CacheSpec(3 if fits(shape[3], m) else None, 1 if rows else None)
        if field == "ssm":
            return CacheSpec(2 if fits(shape[2], m) else None, 1 if rows else None)
        return CacheSpec(None, None)

    return tuple(type(c)(*(spec_for(f, _shape(t)) for f, t in zip(c._fields, c)))
                 for c in caches)


def held_cache_specs(specs: tuple) -> tuple:
    """What a rank of the port holds: :func:`cache_specs` with the Mamba-2
    caches (``conv``, ``ssm``) whole over ``model``.  The port's mixer runs
    replicated on a model group (``repro_torch.models.mamba2``), so its
    state is whole on every model rank; the JAX placement splits the
    channels and SSD heads, which a head-parallel mixer would match."""
    return tuple(type(c)(*(s._replace(model=None) if f in ("conv", "ssm") else s
                           for f, s in zip(c._fields, c))) for c in specs)


def local_shape(shape, spec: CacheSpec, mesh) -> tuple:
    """A leaf's shape on one rank."""
    out = list(_shape(shape))
    if spec.model is not None:
        out[spec.model] //= mesh.model
    if spec.data is not None:
        out[spec.data] //= _data_size(mesh)
    return tuple(out)


def shard_caches(caches: tuple, specs: tuple, mesh, worker: int, shard: int) -> tuple:
    """Worker ``worker``'s shard ``shard`` of every cache leaf (each a copy
    with storage of its own, as :func:`shard_leaf` cuts it)."""
    nd = _data_size(mesh)

    def cut(x, s):
        return shard_leaf(shard_leaf(x, s.data, nd, worker), s.model, mesh.model, shard)

    return tuple(type(c)(*(cut(t, s) for t, s in zip(c, cs))) for c, cs in zip(caches, specs))


def gather_caches(caches: tuple, specs: tuple, groups) -> tuple:
    """Every cache leaf whole on every rank (the global arrays of the JAX
    caches' ``NamedSharding``): gathered over the model group, then over
    the data group (``groups`` a :class:`~repro_torch.launch.mesh.MeshGroups`;
    collective over both)."""
    data = ModelGroup(groups.data, dist.get_world_size(groups.data), groups.worker)

    def whole(x, s):
        return gather_leaf(gather_leaf(x.contiguous(), s.model, groups.model), s.data, data)

    return tuple(type(c)(*(whole(t, s) for t, s in zip(c, cs))) for c, cs in zip(caches, specs))
