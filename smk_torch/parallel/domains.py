"""Failure domains off the mesh and the chunk watchdog — twin of
``FailureDomainMap``, ``ChunkTimeoutError`` and ``ChunkWatchdog`` in
``smk_tpu/parallel/domains.py`` (the port keeps its own copy). The
quarantine engine (parallel/recovery.py) attributes every fault, retry
and death to a domain, and handles a whole-domain fault (every live
subset of a domain non-finite at one boundary) as one event on the
domain's own retry ladder. The watchdog runs each guarded section of
the chunked executor on a worker thread under a deadline, so a hung
chunk becomes a typed :class:`ChunkTimeoutError` instead of a hang.

The mesh constructors come with the multi-GPU executor (ROADMAP A9). A
single-process run is the one-domain map, under which quarantine keeps
its per-subset semantics.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np

from smk_torch.utils.tracing import monotonic

# The deadline tracks the largest wall of the most recent guarded
# sections: a chunk's dispatch and its boundary differ widely, and the
# deadline must cover the slower one.
_ESTIMATE_WINDOW = 32


class ChunkTimeoutError(RuntimeError):
    """A guarded chunk section outran its watchdog deadline: a hung
    dispatch, a stuck kernel or a wedged device queue. Carries the chunk
    index, the global iteration, the deadline that fired and the failure
    domains in flight (a whole-K chunk spans every domain, so they are
    the candidates, not a localization)."""

    def __init__(self, chunk, iteration, deadline_s, domains, labels):
        self.chunk = int(chunk)
        self.iteration = int(iteration)
        self.deadline_s = float(deadline_s)
        self.domains = [int(d) for d in domains]
        self.domain_labels = [str(lab) for lab in labels]
        named = ", ".join(f"{d} ({lab})" for d, lab in zip(self.domains, self.domain_labels))
        super().__init__(
            f"chunk {self.chunk} (iteration {self.iteration}) exceeded its watchdog "
            f"deadline of {self.deadline_s:.1f}s — failure domains in flight: [{named}]. "
            "The dispatch or its boundary fetch is hung (a stuck kernel or a wedged "
            "device queue); the last checkpoint (if any) precedes this chunk — resume "
            "from it (under fault_policy='quarantine' the per-domain fault attribution "
            "then narrows the suspect)"
        )


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


class ChunkWatchdog:
    """Deadline guard over the chunked executor's sections (twin of the
    JAX package's ``ChunkWatchdog``).

    ``run(fn, chunk=, iteration=)`` runs ``fn`` on a fresh daemon worker
    thread and waits ``deadline_s``; a section that overruns raises
    :class:`ChunkTimeoutError` on the calling thread and the stuck
    worker is abandoned. The deadline is ``max(min_deadline_s, margin *
    estimate)``, ``estimate`` the largest wall of the last
    ``_ESTIMATE_WINDOW`` sections; until a first wall is observed a
    section runs inline, observed and unguarded. The executor bypasses
    the watchdog entirely for the first dispatch of each (kind, length)
    (``parallel/recovery.py``, ``novel``), as the twin does for the
    dispatch that compiles.

    It only observes: ``fn`` runs the same work in the same order, and
    its exceptions (the quarantine's rewind included) pass through. The
    caller makes ``fn`` carry its CUDA device, stream and grad mode to
    the worker (in torch all three are per thread). With ``run_log``
    (an obs/events.RunLog) it writes a ``watchdog`` event when the first
    deadline arms (``action="armed"``) and at each overrun
    (``action="fired"``), as the twin does.
    """

    def __init__(self, domain_map: FailureDomainMap, *, min_deadline_s: float = 60.0,
                 margin: float = 10.0, run_log=None):
        if min_deadline_s <= 0:
            raise ValueError("min_deadline_s must be > 0")
        if margin < 1.0:
            raise ValueError(
                "margin must be >= 1 (a deadline below the observed wall would kill "
                "healthy chunks)"
            )
        self.domain_map = domain_map
        self.min_deadline_s = float(min_deadline_s)
        self.margin = float(margin)
        self.run_log = run_log
        self.fired = 0
        self._walls: list = []
        self._armed_logged = False

    def observe(self, wall_s: float) -> None:
        self._walls.append(float(wall_s))
        if len(self._walls) > _ESTIMATE_WINDOW:
            del self._walls[:-_ESTIMATE_WINDOW]

    @property
    def estimate_s(self) -> Optional[float]:
        return max(self._walls) if self._walls else None

    @property
    def deadline_s(self) -> Optional[float]:
        """None until a first wall is observed."""
        est = self.estimate_s
        if est is None:
            return None
        return max(self.min_deadline_s, self.margin * est)

    def _event(self, **attrs) -> None:
        if self.run_log is None:
            return
        try:
            self.run_log.event("watchdog", **attrs)
        except Exception:
            self.run_log = None

    def run(self, fn, *, chunk: int = -1, iteration: int = -1,
            deadline_s: Optional[float] = None):
        """``fn()`` under the current deadline (or ``deadline_s``):
        returns its result, re-raises its exception, or raises
        :class:`ChunkTimeoutError` on overrun."""
        deadline = float(deadline_s) if deadline_s is not None else self.deadline_s
        if deadline is None:
            t0 = monotonic()
            out = fn()
            self.observe(monotonic() - t0)
            return out
        if not self._armed_logged:
            self._armed_logged = True
            self._event(action="armed", chunk=int(chunk), deadline_s=round(deadline, 3),
                        n_domains=self.domain_map.n_domains)
        box = {}
        done = threading.Event()

        def worker():
            t0 = monotonic()
            try:
                box["result"] = fn()
            except BaseException as e:  # re-raised on the caller
                box["exc"] = e
            finally:
                box["wall"] = monotonic() - t0
                done.set()

        threading.Thread(target=worker, name="smk-chunk-watchdog", daemon=True).start()
        if not done.wait(timeout=deadline):
            self.fired += 1
            domains = list(range(self.domain_map.n_domains))
            self._event(action="fired", chunk=int(chunk), iteration=int(iteration),
                        deadline_s=round(deadline, 3), domains=domains)
            raise ChunkTimeoutError(chunk, iteration, deadline, domains,
                                    [self.domain_map.labels[d] for d in domains])
        self.observe(box["wall"])
        if "exc" in box:
            raise box["exc"]
        return box["result"]
