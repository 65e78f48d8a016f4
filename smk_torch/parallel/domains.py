"""Failure domains off the mesh — twin of ``FailureDomainMap`` in
``smk_tpu/parallel/domains.py`` (numpy only; the port keeps its own
copy). The quarantine engine (parallel/recovery.py) attributes every
fault, retry and death to a domain, and handles a whole-domain fault
(every live subset of a domain non-finite at one boundary) as one
event on the domain's own retry ladder.

The mesh constructors come with the multi-GPU executor (ROADMAP A9),
the chunk watchdog with A8b. A single-process run is the one-domain
map, under which quarantine keeps its per-subset semantics.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FailureDomainMap:
    """Subset -> failure-domain attribution: ``domain_of_subset[i]`` is
    the domain subset i runs in, ``labels[d]`` names domain d. Host
    metadata only: it never enters the run identity."""

    domain_of_subset: tuple
    labels: tuple

    def __post_init__(self):
        n = len(self.labels)
        if n < 1:
            raise ValueError("FailureDomainMap needs >= 1 domain")
        for i, d in enumerate(self.domain_of_subset):
            if not 0 <= int(d) < n:
                raise ValueError(f"subset {i} maps to domain {d}, outside [0, {n})")
        if set(range(n)) - {int(d) for d in self.domain_of_subset}:
            raise ValueError("every domain label must own at least one subset")

    @property
    def k(self) -> int:
        return len(self.domain_of_subset)

    @property
    def n_domains(self) -> int:
        return len(self.labels)

    def subsets_of(self, domain: int) -> np.ndarray:
        arr = np.asarray(self.domain_of_subset)
        return np.where(arr == int(domain))[0]

    def domains_of(self, subset_ids) -> list:
        return sorted({int(self.domain_of_subset[int(j)]) for j in subset_ids})

    def whole_domain_faults(self, bad, dead) -> list:
        """Domains whose every not-yet-dead subset is in ``bad`` (with at
        least one live subset); ``bad`` excludes dead subsets."""
        bad = np.asarray(bad, bool)
        dead = np.asarray(dead, bool)
        out = []
        for d in range(self.n_domains):
            idx = self.subsets_of(d)
            live = idx[~dead[idx]]
            if live.size and bad[live].all():
                out.append(d)
        return out

    def summary(self) -> dict:
        """JSON-friendly description for records and manifests."""
        return {
            "n_domains": self.n_domains,
            "n_subsets": self.k,
            "labels": list(self.labels),
            "subsets_per_domain": {
                str(d): self.subsets_of(d).tolist() for d in range(self.n_domains)
            },
        }

    @classmethod
    def single_host(cls, k: int) -> "FailureDomainMap":
        """The one-domain map of a single-process run."""
        return cls(domain_of_subset=tuple([0] * int(k)), labels=("process:0",))

    @classmethod
    def from_n_domains(cls, k: int, n_domains: int, prefix: str = "domain") -> "FailureDomainMap":
        """Contiguous split of the K axis over ``n_domains``, the leading
        domains taking the remainder."""
        k, n_domains = int(k), int(n_domains)
        if not 1 <= n_domains <= k:
            raise ValueError(f"n_domains must be in [1, K={k}], got {n_domains}")
        base, rem = divmod(k, n_domains)
        doms = []
        for d in range(n_domains):
            doms.extend([d] * (base + (1 if d < rem else 0)))
        return cls(domain_of_subset=tuple(doms),
                   labels=tuple(f"{prefix}:{d}" for d in range(n_domains)))

    @classmethod
    def derive(cls, k: int, mesh=None) -> "FailureDomainMap":
        """The executor's default map: one domain per process of the job
        (the twin's derivation without a mesh). A process group, where
        one is initialized, gives the process count."""
        if mesh is not None:
            raise NotImplementedError(
                "FailureDomainMap.derive over a device mesh is not ported to "
                "smk_torch yet (ROADMAP A9)"
            )
        import torch.distributed as dist

        n_proc = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        if n_proc <= 1:
            return cls.single_host(k)
        return cls.from_n_domains(k, min(n_proc, int(k)), prefix="process")
