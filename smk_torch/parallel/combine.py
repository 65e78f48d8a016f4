"""Quantile-grid combiners — twin of ``wasserstein_barycenter``,
``weiszfeld_median``, ``apply_survival_mask`` and
``combine_quantile_grids`` in ``smk_tpu/parallel/combine.py``, with the
survival errors, and the mesh's data movement (:func:`gather_grids`,
:func:`replicate_to_mesh`).

Under ``fault_policy="quarantine"`` a subset whose retry ladder ran
out ships non-finite grids home; the survival mask drops it from the
reduction, and the combine fails only when fewer than
``min_surviving_frac`` of the subsets (or of the failure domains)
survive. An all-True mask changes nothing."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class SubsetSurvivalError(RuntimeError):
    """Too few subsets survived the fit to combine."""

    def __init__(self, n_surviving: int, n_total: int, min_frac: float):
        self.n_surviving = int(n_surviving)
        self.n_total = int(n_total)
        self.min_frac = float(min_frac)
        super().__init__(
            f"only {self.n_surviving}/{self.n_total} subsets survived the fit but "
            f"min_surviving_frac={min_frac} requires at least "
            f"{max(1, int(np.ceil(min_frac * n_total)))} — the combined posterior "
            "would silently summarize a rump of the data; inspect the dropped "
            "subsets (NaN grids, find_failed_subsets) or lower "
            "config.min_surviving_frac deliberately"
        )


class DomainSurvivalError(SubsetSurvivalError):
    """Too few failure domains still own a surviving subset (a
    :class:`SubsetSurvivalError`, so its handlers catch both)."""

    def __init__(self, n_surviving: int, n_total: int, min_frac: float):
        self.n_surviving = int(n_surviving)
        self.n_total = int(n_total)
        self.min_frac = float(min_frac)
        RuntimeError.__init__(
            self,
            f"only {self.n_surviving}/{self.n_total} failure domains still own a "
            f"surviving subset but min_surviving_frac={min_frac} requires at least "
            f"{max(1, int(np.ceil(min_frac * n_total)))} — most of the run's hosts "
            "are gone; inspect the dropped domains (result.domains_dropped, the "
            "checkpoint manifest's fault_domain fields) or lower "
            "config.min_surviving_frac deliberately",
        )


def gather_grids(grids: torch.Tensor, mesh, *, axis: Optional[str] = None,
                 timeout_s: float = 120.0) -> torch.Tensor:
    """The (K, ...) stack of a meshed fit, whole, on the mesh's first
    local device (``mesh.home``), so the combiner's small reduction runs
    there. Pure data movement, bitwise:

    - within a process the rows already sit on ``mesh.home`` (the
      executor gathers its entries' results there) or are peer-copied;
    - across processes (a mesh over every rank of the process group,
      each process holding its own rows, executor.process_row_range; a
      world of one included) it is an all-gather over the process group — NCCL between cards, gloo on the CPU — of equal
      row counts (the layout oracle guarantees them), concatenated in
      process order. A barrier on the group's store (bounded by
      ``timeout_s``, parallel/distributed.barrier_sync) comes first, so a
      dead peer is a typed ``CollectiveTimeoutError`` and not a hang in
      the backend.

    ``axis`` is accepted for symmetry with the twin."""
    del axis
    import torch.distributed as dist

    from smk_torch.parallel.distributed import barrier_sync, process_count

    home = mesh.home
    local = grids.to(home)
    if not (dist.is_available() and dist.is_initialized()
            and mesh.process_indices == tuple(range(process_count()))):
        return local
    barrier_sync("gather_grids", timeout_s=timeout_s)
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local.contiguous())
    return torch.cat(parts)


def replicate_to_mesh(tree, mesh):
    """Every tensor of ``tree`` on the mesh's first local device (a
    process holds its inputs whole, so nothing crosses processes).
    Bitwise."""
    from torch.utils._pytree import tree_map

    home = mesh.home
    return tree_map(lambda a: a.to(home) if isinstance(a, torch.Tensor) else a, tree)


def wasserstein_barycenter(grids: torch.Tensor) -> torch.Tensor:
    """Mean of (K, n_q, d) quantile grids over K (R:123-133)."""
    return torch.mean(grids, dim=0)


def weiszfeld_median(
    grids: torch.Tensor, n_iter: int = 50, eps: float = 1e-8
) -> torch.Tensor:
    """W2 geometric median of (K, n_q, d) quantile grids, per column d,
    by Weiszfeld iterations from the barycenter with the Vardi–Zhang
    guard for an iterate that lands on one of the curves (see the
    twin's docstring). All d columns iterate together."""
    curves = torch.movedim(grids, -1, 0)  # (d, K, n_q)
    scale = torch.clamp(torch.amax(torch.abs(curves), dim=(1, 2)), min=1.0)
    tol = (eps ** 0.5 * scale)[:, None]  # (d, 1)
    tiny = (eps * scale)[:, None]
    y = torch.mean(curves, dim=1)  # (d, n_q)
    for _ in range(n_iter):
        diff = curves - y[:, None]
        dist = torch.sqrt(torch.sum(diff ** 2, dim=2))  # (d, K)
        near = dist < tol
        w = torch.where(near, 0.0, 1.0 / torch.maximum(dist, tol))
        wsum = torch.sum(w, dim=1, keepdim=True)
        t_y = torch.sum(w[..., None] * curves, dim=1) / torch.maximum(wsum, tiny)
        r = torch.sum(w[..., None] * diff, dim=1)
        rnorm = torch.sqrt(torch.sum(r ** 2, dim=1, keepdim=True))
        eta = torch.sum(near.to(curves.dtype), dim=1, keepdim=True)
        gamma = torch.clamp(eta / torch.maximum(rnorm, tiny), max=1.0)
        y_next = (1.0 - gamma) * t_y + gamma * y
        y = torch.where(wsum > 0, y_next, y)
    return torch.movedim(y, 0, -1)


def apply_survival_mask(
    grids: torch.Tensor,
    survival_mask,
    *,
    min_surviving_frac: float = 0.0,
    domain_of_subset=None,
) -> torch.Tensor:
    """Drop dead subsets (``survival_mask`` False) from a (K, n_q, d)
    grid stack. Raises :class:`SubsetSurvivalError` when fewer than
    max(1, ceil(min_surviving_frac * K)) survive, and with
    ``domain_of_subset`` (K ints) :class:`DomainSurvivalError` when
    fewer than max(1, ceil(min_surviving_frac * n_domains)) domains
    keep a survivor. An all-True mask returns ``grids`` itself."""
    mask = np.asarray(survival_mask, bool).reshape(-1)
    k = int(grids.shape[0])
    if mask.shape[0] != k:
        raise ValueError(f"survival_mask has {mask.shape[0]} entries for {k} subset grids")
    n_surv = int(mask.sum())
    if n_surv < max(1, int(np.ceil(min_surviving_frac * k))):
        raise SubsetSurvivalError(n_surv, k, min_surviving_frac)
    if domain_of_subset is not None:
        doms = np.asarray(domain_of_subset, int).reshape(-1)
        if doms.shape[0] != k:
            raise ValueError(
                f"domain_of_subset has {doms.shape[0]} entries for {k} subset grids"
            )
        n_domains = len(set(doms.tolist()))
        n_dom_surv = len(set(doms[mask].tolist()))
        if n_dom_surv < max(1, int(np.ceil(min_surviving_frac * n_domains))):
            raise DomainSurvivalError(n_dom_surv, n_domains, min_surviving_frac)
    if mask.all():
        return grids
    keep = torch.as_tensor(np.where(mask)[0], device=grids.device)
    return grids[keep]


def combine_quantile_grids(
    grids: torch.Tensor,
    method: str = "wasserstein_mean",
    *,
    n_iter: int = 50,
    eps: float = 1e-8,
    survival_mask: Optional[np.ndarray] = None,
    min_surviving_frac: float = 0.0,
    domain_of_subset=None,
) -> torch.Tensor:
    """Dispatch on the configured combiner, after dropping the dead
    subsets of ``survival_mask`` (see :func:`apply_survival_mask`)."""
    if survival_mask is not None:
        grids = apply_survival_mask(
            grids, survival_mask, min_surviving_frac=min_surviving_frac,
            domain_of_subset=domain_of_subset,
        )
    if method == "wasserstein_mean":
        return wasserstein_barycenter(grids)
    if method == "weiszfeld_median":
        return weiszfeld_median(grids, n_iter=n_iter, eps=eps)
    raise ValueError(f"unknown combiner {method!r}")
