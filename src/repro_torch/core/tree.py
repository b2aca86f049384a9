"""Parameter trees as flat ``{path: tensor}`` dicts.

The JAX package keeps parameters in nested dicts, and ``jax.tree_util``
flattens them in sorted-key order at every level.  The port keys each leaf by
its ``/``-joined path (``"blocks/layer0/mixer/wq"``); sorting paths by their
components reproduces JAX's leaf order, which fixes the bucket layout and
which PRNG key each leaf draws from (``split(key, n_leaves)[i]``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

__all__ = ["paths", "flatten_nested"]


def paths(tree: Mapping[str, Any]) -> List[str]:
    """Leaf paths in ``jax.tree_util`` flatten order."""
    return sorted(tree, key=lambda p: tuple(p.split("/")))


def flatten_nested(nested: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> ``{path: leaf}``."""
    out: Dict[str, Any] = {}
    for k, v in nested.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_nested(v, key + "/"))
        else:
            out[key] = v
    return out
