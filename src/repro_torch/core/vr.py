"""VR-DIANA variance reduction: L-SVRG control variates under compression
(the port's copy of ``repro.core.vr``).

DIANA removes the compression noise of the gradient differences, but with
stochastic finite-sum gradients the iterates still stall at a variance ball
set by the sampling noise (Thm 2's sigma term).  Horváth et al.,
"Stochastic Distributed Learning with Gradient Quantization and Variance
Reduction" (arXiv:1904.05115), close that gap: each worker layers an L-SVRG
control variate under the same compressed-difference mechanism,

    k_i^t = g_i^t - grad f_{ij_t}(w_i^t) + mu_i^t,
    mu_i^t = (1/m) sum_j grad f_{ij}(w_i^t),

and feeds ``k_i`` instead of ``g_i`` into DIANA's compressor input.  The
snapshot ``w_i`` refreshes with probability ``p`` (default ``1/m``): then
``w_i <- x^t`` and ``mu_i`` is recomputed.

This module owns the state and the algebra only; callers supply the
gradients at the snapshot and the refresh candidate for ``mu``.
:mod:`repro_torch.core.diana` applies :func:`control_variate` before any
layout decision, so VR composes with every operator in both layouts.

PRNG schedule: worker ``i``'s coin at a step keyed ``key`` is
``bernoulli(fold_in(fold_in(key, i), VR_FOLD), p)``.  The distributed round
receives the worker-folded key and folds ``VR_FOLD``; the reference folds
the worker index itself, so both draw the same coin.  ``VR_FOLD`` is folded
into no compression key, so enabling VR never moves a compression draw.

Trees are ``{path: tensor}``; ``snapshot`` and ``mu`` leaves carry a leading
worker axis ``(n_local, *shape)``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional

import torch

from . import prng

__all__ = ["VRState", "VR_FOLD", "VarianceReducer", "init_vr", "control_variate",
           "vr_coin", "reference_coins", "refresh", "resolve_vr_p"]

VR_FOLD = 0x5652  # 'VR'


class VRState(NamedTuple):
    """Per-worker L-SVRG state, in the parameter layout whatever the
    aggregation layout.

    snapshot: the snapshot points ``w_i``, ``{path: (n_local, *shape)}`` in
              the parameter dtype (a second backward runs on them).
    mu:       the control variates ``mu_i``, ``{path: (n_local, *shape)}`` f32.
    """

    snapshot: Any
    mu: Any


def init_vr(params: Mapping[str, torch.Tensor], n_workers: int, mu=None) -> VRState:
    """``w_i^0 = x^0`` for every worker (a copy in the parameter dtype);
    ``mu`` defaults to zeros (f32).  Exact L-SVRG wants ``mu_i^0 = grad
    f_i(w_i^0)``: the convex harness installs it, and the trainer forces a
    refresh at step 0 instead."""
    snapshot = {p: x.detach().unsqueeze(0).expand(n_workers, *x.shape).clone()
                for p, x in params.items()}
    if mu is None:
        mu = {p: torch.zeros((n_workers, *x.shape), dtype=torch.float32, device=x.device)
              for p, x in params.items()}
    return VRState(snapshot=snapshot, mu=mu)


def control_variate(g: Mapping[str, torch.Tensor], g_snapshot: Mapping[str, torch.Tensor],
                    mu: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The L-SVRG estimator ``k = g - grad f_j(w) + mu`` per leaf, in f32 and
    in the reference's order ``(a - b) + c``."""
    return {p: g[p].float() - g_snapshot[p].float() + mu[p].float() for p in g}


def vr_coin(worker_key: torch.Tensor, p: float) -> bool:
    """This worker's Bernoulli(p) snapshot coin; ``worker_key`` is already
    folded with the worker index (the distributed convention)."""
    return bool(prng.bernoulli(prng.fold_in(worker_key, VR_FOLD), p))


def reference_coins(key: torch.Tensor, p: float, n_workers: int) -> torch.Tensor:
    """All workers' coins ``(n,)`` bool from the step key: the draws
    :func:`vr_coin` makes on the distributed path."""
    return torch.tensor([vr_coin(prng.fold_in(key, w), p) for w in range(n_workers)],
                        dtype=torch.bool)


def refresh(vr: VRState, coins, params: Mapping[str, torch.Tensor],
            mu_candidate: Mapping[str, torch.Tensor]) -> VRState:
    """L-SVRG snapshot step: rows whose coin is set take ``w_i <- params``
    (cast to the snapshot dtype) and ``mu_i <- mu_candidate_i`` (f32); the
    other rows keep theirs.  ``coins`` is ``(n_local,)`` bool (host values);
    ``params`` leaves are parameter-shaped, ``mu_candidate`` leaves carry the
    worker axis.  A where-select by row, so the reference (n rows) and the
    distributed round (one row) give the same rows; a leaf whose rows all
    keep comes back as the same tensor."""
    coins = torch.as_tensor(coins, dtype=torch.bool).reshape(-1).cpu()
    if not bool(coins.any()):
        return vr

    def sel(new, old):
        c = coins.to(old.device).reshape((-1,) + (1,) * (old.dim() - 1))
        return torch.where(c, new.to(old.dtype), old)

    snapshot = {p: sel(params[p].unsqueeze(0), s) for p, s in vr.snapshot.items()}
    mu = {p: sel(mu_candidate[p], m) for p, m in vr.mu.items()}
    return VRState(snapshot=snapshot, mu=mu)


def resolve_vr_p(vr_p: Optional[float], m: int) -> float:
    """The snapshot probability: an explicit one, else the paper's ``1/m``
    (``m`` the local finite-sum size; the trainer takes its per-worker batch)."""
    if vr_p is not None:
        return float(vr_p)
    return 1.0 / max(int(m), 1)


class VarianceReducer:
    """The snapshot probability bundled with the VR algebra, for callers
    that drive the layer directly (the aggregation paths use the free
    functions, with the probability in the config)."""

    def __init__(self, p: float):
        if not 0.0 < p <= 1.0:
            raise ValueError(f"snapshot probability must be in (0, 1], got {p}")
        self.p = float(p)

    init = staticmethod(init_vr)
    control_variate = staticmethod(control_variate)
    refresh = staticmethod(refresh)

    def coin(self, worker_key: torch.Tensor) -> bool:
        return vr_coin(worker_key, self.p)

    def coins(self, key: torch.Tensor, n_workers: int) -> torch.Tensor:
        return reference_coins(key, self.p, n_workers)

    @classmethod
    def for_finite_sum(cls, m: int, vr_p: Optional[float] = None) -> "VarianceReducer":
        return cls(resolve_vr_p(vr_p, m))
