"""Adaptive per-subset scheduling — twin of
``smk_tpu/parallel/schedule.py``, host-side numpy only.

The fixed chunk schedule spends the same sweeps on every subset, but
mixing is uneven. This module makes every early-stop and
budget-reallocation decision of the chunked executor
(parallel/recovery.py):

- **freeze** — a subset whose streaming diagnostics (obs/streaming.py)
  clear ``target_rhat`` and ``target_ess`` for ``adapt_patience``
  consecutive committed boundaries (after ``min_samples_before_stop``
  kept draws) stops writing draws; its statistics stay at the
  freeze-boundary values.
- **compact** — the executor shrinks the dispatch group to the
  smallest rung of the √2 K ladder (compile/buckets.compaction_rung)
  holding the active set; frozen subsets ride along as non-writing rows
  until the rung shrinks.
- **reallocate** — dispatch slots saved by compaction fund extra
  sampling chunks for the worst-mixing stragglers (ranked by streaming
  R-hat, ties by subset id), up to ``adapt_max_extra_frac * n_samples``
  extra kept draws per subset. A straggler the budget cannot afford yet
  is budget-frozen; a later, richer grant reopens it.

Every decision is a pure function of committed-boundary statistics and
this object's own state, so a kill and resume reproduces the schedule:
the state round-trips through the checkpoint's ``sched`` sidecar
(``to_arrays`` / ``restore_arrays``). The scheduler's ``__init__`` is
the one place that reads the adaptive knobs, and the executor has one
``observe`` call site.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from smk_torch.compile.buckets import compaction_rung

# Sidecar blob layout version (bump on any array-set change).
SCHED_STATE_VERSION = 1


class BoundaryDecision:
    """What the executor does next, decided at one committed boundary.

    ``active`` is the post-decision set of subsets that keep writing
    draws; ``grant`` is an optional ``(start_it, length)`` extra
    sampling chunk to append to the plan (participants = ``active``);
    ``all_done`` means nothing is left to sample — the executor may
    drop any remaining planned chunks."""

    __slots__ = (
        "active",
        "newly_frozen",
        "newly_budget_frozen",
        "newly_reopened",
        "grant",
        "all_done",
    )

    def __init__(
        self,
        active: Tuple[int, ...],
        newly_frozen: Tuple[int, ...] = (),
        newly_budget_frozen: Tuple[int, ...] = (),
        newly_reopened: Tuple[int, ...] = (),
        grant: Optional[Tuple[int, int]] = None,
        all_done: bool = False,
    ):
        self.active = active
        self.newly_frozen = newly_frozen
        self.newly_budget_frozen = newly_budget_frozen
        self.newly_reopened = newly_reopened
        self.grant = grant
        self.all_done = all_done


class AdaptiveScheduler:
    """Replayable per-subset early-stop + budget-reallocation state.

    Construction reads the adaptive knobs off the config once (the
    only read site besides config validation); afterwards the executor interacts through :meth:`observe`,
    :meth:`mark_stopped`, :meth:`rung` and the sidecar round-trip.
    """

    def __init__(
        self,
        config,
        *,
        k: int,
        n_kept: int,
        chunk_iters: int,
        n_devices: int = 1,
    ):
        if k < 1 or n_kept < 1 or chunk_iters < 1:
            raise ValueError(
                "AdaptiveScheduler needs k, n_kept, chunk_iters >= 1"
            )
        self.k = int(k)
        self.n_kept = int(n_kept)
        self.chunk_iters = int(chunk_iters)
        self.n_devices = int(n_devices)
        # the one place that reads the adaptive knobs
        self.target_rhat = float(config.target_rhat)
        self.target_ess = float(config.target_ess)
        self.patience = int(config.adapt_patience)
        self.min_fill = int(config.min_samples_before_stop)
        # Extra chunks reuse the FIRST sampling-chunk length so the
        # ladder-K' program set needs no new length buckets: the
        # (kind="samp", L=l_extra) rung programs are already warm.
        self.l_extra = min(self.chunk_iters, self.n_kept)
        self.n_extra_max = (
            int(float(config.adapt_max_extra_frac) * config.n_samples)
            // self.l_extra
        )
        self.n_chunks_base = -(-self.n_kept // self.chunk_iters)
        # --- replayable state ---------------------------------------
        self.streak = np.zeros(self.k, np.int64)
        self.conv_frozen = np.zeros(self.k, bool)
        self.budget_frozen = np.zeros(self.k, bool)
        self.frozen_at_it = np.full(self.k, -1, np.int64)
        self.frozen_at_count = np.full(self.k, -1, np.int64)
        self.it_stopped = np.full(self.k, -1, np.int64)
        self.rows_valid = np.zeros((self.k, self.n_cap), bool)
        self.saved_slots = 0
        self.spent_slots = 0
        self.extra_granted = 0
        self.dispatched_slots = 0
        self.last_obs_it = -1  # idempotency stamp (sidecar ordering)
        self.extra_starts: List[int] = []  # start_it of every grant

    # -- derived geometry --------------------------------------------

    @property
    def n_cap(self) -> int:
        """Draw-buffer capacity per subset: the fixed schedule's kept
        draws plus the worst-case extra allowance (static — buffers
        never reallocate mid-run)."""
        return self.n_kept + self.n_extra_max * self.l_extra

    @property
    def frozen(self) -> np.ndarray:
        return self.conv_frozen | self.budget_frozen

    @property
    def active_ids(self) -> Tuple[int, ...]:
        return tuple(np.flatnonzero(~self.frozen).tolist())

    def rung(self, n_active: Optional[int] = None) -> int:
        """Dispatch-group size for ``n_active`` live subsets: the
        bucket-ladder rung, ceiled to a device multiple under a mesh
        (compile/buckets.compaction_rung)."""
        if n_active is None:
            n_active = len(self.active_ids)
        if n_active <= 0:
            return 0
        return compaction_rung(n_active, self.k, self.n_devices)

    def counts(self) -> np.ndarray:
        """(K,) valid kept-draw counts (drives ``frozen_at`` telemetry
        and the finalize masks)."""
        return self.rows_valid.sum(axis=1).astype(np.int64)

    # -- bookkeeping hooks (not decisions) ---------------------------

    def mark_stopped(self, ids: Sequence[int], it: int) -> None:
        """Record the global iteration at which subsets physically
        left the dispatch group (phi proposals run until then, so
        this sets the finalize phi-acceptance divisor). Idempotent
        per subset; a reopened subset is re-marked when it leaves
        again."""
        for j in ids:
            self.it_stopped[j] = int(it)

    def pending_extras(self, resume_it: int) -> List[Tuple[int, int]]:
        """Granted extra chunks not yet committed as of a resume at
        global iteration ``resume_it`` — the executor re-appends these
        to its plan (a grant made at the crash boundary survives in
        ``extra_starts`` even when the chunk never dispatched)."""
        return [
            (int(s), self.l_extra)
            for s in self.extra_starts
            if int(s) >= int(resume_it)
        ]

    # -- THE decision function ---------------------------------------

    def observe(
        self,
        *,
        kind: str,
        it: int,
        span: Tuple[int, int],
        written: Sequence[int],
        kc_dispatched: int,
        rhat_max: np.ndarray,
        ess_min: np.ndarray,
        plan_exhausted: bool,
    ) -> BoundaryDecision:
        """Fold one COMMITTED boundary's statistics in and decide.

        kind          "samp" or "extra" (burn/fill boundaries are not
                      consulted — nothing is kept there).
        it            global iteration after the chunk.
        span          [a, b) kept-index range the chunk wrote.
        written       subset ids whose draws actually landed (the
                      dispatch group minus pads minus frozen riders).
        kc_dispatched dispatch-group size of the chunk (slot ledger).
        rhat_max /    the boundary's streaming fetch, (K,) float
        ess_min       (NaN where not yet defined -> never converged).
        plan_exhausted  no undispatched entries remain after this
                      chunk — the only boundary where grants happen,
                      keeping checkpoint segments contiguous.
        """
        if kind not in ("samp", "extra"):
            raise ValueError(f"unexpected boundary kind {kind!r}")
        if int(it) <= self.last_obs_it:
            # Idempotent replay: the sidecar is written BEFORE the
            # manifest, so a crash between the two resumes one chunk
            # back with this boundary's fold already applied — derive
            # the (state-determined) decision without re-folding.
            active = self.active_ids
            return BoundaryDecision(
                active=active,
                all_done=(
                    not active and not self.pending_extras(int(it))
                ),
            )
        self.last_obs_it = int(it)
        a, b = span
        w = np.asarray(sorted(written), np.int64)
        if w.size:
            self.rows_valid[w, a:b] = True
        self.dispatched_slots += int(kc_dispatched)
        if kind == "samp":
            # Savings accrue only against the BASE schedule's k-wide
            # chunks. An extra chunk is pure spend — crediting its
            # (k - kc) headroom as "saved" would let each grant fund
            # the next one and the ledger run away past break-even.
            self.saved_slots += self.k - int(kc_dispatched)

        rh = np.asarray(rhat_max, np.float64)
        es = np.asarray(ess_min, np.float64)

        # 1) convergence freezes — patience streak over clean boundaries
        newly_frozen: List[int] = []
        cnt = self.counts()
        for j in self.active_ids:
            ok = (
                np.isfinite(rh[j])
                and np.isfinite(es[j])
                and rh[j] <= self.target_rhat
                and es[j] >= self.target_ess
            )
            self.streak[j] = self.streak[j] + 1 if ok else 0
            if (
                cnt[j] >= self.min_fill
                and self.streak[j] >= self.patience
            ):
                self.conv_frozen[j] = True
                self.frozen_at_it[j] = int(it)
                self.frozen_at_count[j] = int(cnt[j])
                newly_frozen.append(j)

        # 2) budget reallocation — only at plan exhaustion
        newly_budget_frozen: List[int] = []
        newly_reopened: List[int] = []
        grant: Optional[Tuple[int, int]] = None
        if plan_exhausted:
            # stragglers = unconverged subsets, incl. budget-frozen
            # ones (reopen candidates); worst streaming R-hat first
            # (unknown R-hat ranks worst), ties by subset id.
            pool = np.flatnonzero(~self.conv_frozen).tolist()
            if pool and self.extra_granted < self.n_extra_max:
                key = lambda j: (
                    -(rh[j] if np.isfinite(rh[j]) else np.inf),
                    j,
                )
                ranked = sorted(pool, key=key)
                select: List[int] = []
                for take in range(len(ranked), 0, -1):
                    cost = self.rung(take)
                    # STRICT: spending every saved slot would only
                    # break even; the schedule promises a strict
                    # reduction in dispatched subset-chunks.
                    if self.spent_slots + cost < self.saved_slots:
                        select = ranked[:take]
                        break
                if select:
                    for j in select:
                        if self.budget_frozen[j]:
                            self.budget_frozen[j] = False
                            self.frozen_at_it[j] = -1
                            self.frozen_at_count[j] = -1
                            # it rejoins the dispatch group: clear the
                            # old departure stamp so finalize doesn't
                            # clamp its phi divisor to the first exit
                            self.it_stopped[j] = -1
                            newly_reopened.append(j)
                    for j in ranked[len(select):]:
                        if not self.budget_frozen[j]:
                            self.budget_frozen[j] = True
                            self.frozen_at_it[j] = int(it)
                            self.frozen_at_count[j] = int(cnt[j])
                            newly_budget_frozen.append(j)
                    self.spent_slots += self.rung(len(select))
                    self.extra_granted += 1
                    self.extra_starts.append(int(it))
                    grant = (int(it), self.l_extra)
                else:
                    for j in ranked:
                        if not self.budget_frozen[j]:
                            self.budget_frozen[j] = True
                            self.frozen_at_it[j] = int(it)
                            self.frozen_at_count[j] = int(cnt[j])
                            newly_budget_frozen.append(j)

        active = self.active_ids
        return BoundaryDecision(
            active=active,
            newly_frozen=tuple(newly_frozen),
            newly_budget_frozen=tuple(newly_budget_frozen),
            newly_reopened=tuple(newly_reopened),
            grant=grant,
            all_done=(grant is None and not active),
        )

    # -- telemetry ----------------------------------------------------

    def summary(self) -> Dict[str, object]:
        """The ChunkPipelineStats.adaptive payload: per-subset freeze iterations and
        kept counts, plus the dispatch-slot ledger. ``chunks_saved_frac``
        compares slots actually dispatched (sampling + extra) against
        the fixed schedule's ``k * n_chunks_base``."""
        baseline = self.k * self.n_chunks_base
        return {
            "frozen_at": self.frozen_at_it.tolist(),
            "frozen_counts": self.frozen_at_count.tolist(),
            "kept_counts": self.counts().tolist(),
            "subset_chunks_dispatched": int(self.dispatched_slots),
            "subset_chunks_baseline": int(baseline),
            "chunks_saved_frac": float(
                1.0 - self.dispatched_slots / baseline
            )
            if baseline
            else 0.0,
            "extra_granted": int(self.extra_granted),
            "saved_slots": int(self.saved_slots),
            "spent_slots": int(self.spent_slots),
            "n_frozen": int(self.frozen.sum()),
        }

    # -- sidecar round-trip -------------------------------------------

    def to_arrays(self) -> Dict[str, np.ndarray]:
        """npz-serializable snapshot of the full replayable state."""
        return {
            "version": np.asarray(SCHED_STATE_VERSION, np.int64),
            "k": np.asarray(self.k, np.int64),
            "n_cap": np.asarray(self.n_cap, np.int64),
            "streak": self.streak.copy(),
            "conv_frozen": self.conv_frozen.copy(),
            "budget_frozen": self.budget_frozen.copy(),
            "frozen_at_it": self.frozen_at_it.copy(),
            "frozen_at_count": self.frozen_at_count.copy(),
            "it_stopped": self.it_stopped.copy(),
            "rows_valid": self.rows_valid.copy(),
            "ledger": np.asarray(
                [
                    self.saved_slots,
                    self.spent_slots,
                    self.extra_granted,
                    self.dispatched_slots,
                    self.last_obs_it,
                ],
                np.int64,
            ),
            "extra_starts": np.asarray(self.extra_starts, np.int64),
        }

    def restore_arrays(self, blobs: Dict[str, np.ndarray]) -> None:
        """Adopt a sidecar snapshot (resume). Raises on layout
        mismatch — a sidecar from a different run geometry means the
        checkpoint identity check upstream was bypassed."""
        ver = int(blobs["version"])
        if ver != SCHED_STATE_VERSION:
            raise ValueError(
                f"scheduler sidecar version {ver} != "
                f"{SCHED_STATE_VERSION}"
            )
        if int(blobs["k"]) != self.k or int(blobs["n_cap"]) != self.n_cap:
            raise ValueError(
                "scheduler sidecar geometry mismatch: "
                f"k={int(blobs['k'])}/n_cap={int(blobs['n_cap'])} vs "
                f"run k={self.k}/n_cap={self.n_cap}"
            )
        self.streak = np.asarray(blobs["streak"], np.int64).copy()
        self.conv_frozen = np.asarray(blobs["conv_frozen"], bool).copy()
        self.budget_frozen = np.asarray(
            blobs["budget_frozen"], bool
        ).copy()
        self.frozen_at_it = np.asarray(
            blobs["frozen_at_it"], np.int64
        ).copy()
        self.frozen_at_count = np.asarray(
            blobs["frozen_at_count"], np.int64
        ).copy()
        self.it_stopped = np.asarray(blobs["it_stopped"], np.int64).copy()
        self.rows_valid = np.asarray(blobs["rows_valid"], bool).copy()
        ledger = np.asarray(blobs["ledger"], np.int64)
        self.saved_slots = int(ledger[0])
        self.spent_slots = int(ledger[1])
        self.extra_granted = int(ledger[2])
        self.dispatched_slots = int(ledger[3])
        self.last_obs_it = int(ledger[4])
        self.extra_starts = np.asarray(
            blobs["extra_starts"], np.int64
        ).tolist()
