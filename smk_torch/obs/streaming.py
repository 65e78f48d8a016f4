"""Streaming convergence monitor on the device — twin of
``smk_tpu/obs/streaming.py``.

The chunked executor keeps O(K · d) Welford and batch-means
accumulators on the fit's device, folds each sampling chunk's kept draws
in right behind the chunk, and copies two (K,) vectors per boundary to
the host (per-subset ``rhat_max`` and ``ess_min``) behind the boundary's
one synchronising wait, in the same pinned copy as the guard's stats. A
sick run shows in the progress callback and the run log at the next
boundary, where a ``ProgressAbort`` can stop it.

Estimators (the tolerance contract against utils/diagnostics.py):

- **split-R-hat** — Welford moments per split half (count, mean, M2),
  Chan-combined per chunk. The halves are the fixed kept-index ranges
  [0, n_kept // 2) and [n_kept // 2, 2 (n_kept // 2)) of each chain,
  the halves post-hoc ``diagnostics.rhat`` uses, so at the last
  boundary the streaming value is the post-hoc one to fp tolerance.
  Mid-run the halves have unequal counts and the formula uses the
  populated halves' mean count. A single chain reports NaN until its
  second half starts filling; several chains are informative from the
  first boundary.
- **ESS** — batch means, one batch per sampling chunk: tau ≈ L̄ ·
  var(batch means) / var(chain), ESS = n / tau summed over chains,
  capped at n. A different estimator from the post-hoc Geyer ESS
  (agreement within a factor of 3 on mixing chains once ~10 batches
  exist); NaN until two batches exist.

Every function here is a handful of small torch ops on the fit's device
(no synchronisation); the chunk's own sweeps are untouched, so a fit
with the monitor armed draws bitwise what it draws without it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class StreamState(NamedTuple):
    """The accumulators, leading dims (K, C) (C = 1 for one chain); the
    half axis (2) indexes the split-R-hat halves."""

    half_n: torch.Tensor  # (K, C, 2) draws per half
    half_mean: torch.Tensor  # (K, C, 2, d) running means
    half_m2: torch.Tensor  # (K, C, 2, d) sums of squared deviations
    n_batches: torch.Tensor  # () — or (K,) per subset — batches folded
    n_total: torch.Tensor  # () — or (K,) — kept draws folded, per chain
    bm_mean: torch.Tensor  # (K, C, d) Welford mean of the batch means
    bm_m2: torch.Tensor  # (K, C, d) Welford M2 of the batch means


def init_stream(k: int, n_chains: int, d: int, dtype=torch.float32, *,
                per_subset_counts: bool = False, device=None) -> StreamState:
    """Zeroed accumulators on ``device``. ``per_subset_counts=True``
    makes the batch counters (K,), as the adaptive executor's masked
    fold-in (:func:`make_stream_update_masked`) needs: frozen subsets
    stop contributing batches."""
    c = max(1, int(n_chains))

    def z(*s):
        return torch.zeros(s, dtype=dtype, device=device)

    cnt = (k,) if per_subset_counts else ()
    return StreamState(half_n=z(k, c, 2), half_mean=z(k, c, 2, d), half_m2=z(k, c, 2, d),
                       n_batches=z(*cnt), n_total=z(*cnt), bm_mean=z(k, c, d),
                       bm_m2=z(k, c, d))


def _as_kcld(chunk: torch.Tensor, dtype) -> torch.Tensor:
    x = chunk if chunk.dim() == 4 else chunk[:, None]
    return x.to(dtype)


def _half_ids(idx: torch.Tensor, n_half: int) -> torch.Tensor:
    """The half of each row by its global kept index: 0, 1, or -1 for
    the odd leftover row past 2 n_half that post-hoc R-hat ignores."""
    return torch.where(idx < n_half, torch.zeros_like(idx),
                       torch.where(idx < 2 * n_half, torch.ones_like(idx),
                                   torch.full_like(idx, -1)))


def _chan(stream: StreamState, h: int, cnt, mean_c, m2_c, one):
    """Chan's parallel combine of a chunk's half-``h`` moments (count
    ``cnt`` broadcast against (K, C)) into the accumulator."""
    n_a = stream.half_n[:, :, h]
    mean_a = stream.half_mean[:, :, h]
    m2_a = stream.half_m2[:, :, h]
    n_new = n_a + cnt
    safe_n = torch.maximum(n_new, one)[..., None]
    delta = mean_c - mean_a
    cnt_b = cnt[..., None] if torch.is_tensor(cnt) and cnt.dim() else cnt
    mean_new = mean_a + delta * (cnt_b / safe_n)
    m2_new = m2_a + m2_c + delta * delta * (n_a[..., None] * cnt_b / safe_n)
    return n_new, mean_new, m2_new


def make_stream_update(n_half: int, n_chains: int):
    """The per-chunk fold-in ``update(stream, chunk, offset)``: ``chunk``
    is the boundary's new kept draws, (K, L, d) or (K, C, L, d), and
    ``offset`` the global kept index of its first row."""
    del n_chains  # the chain axis rides in the shapes

    def update(stream: StreamState, chunk: torch.Tensor, offset: int) -> StreamState:
        dt = stream.half_mean.dtype
        x = _as_kcld(chunk, dt)
        length = x.shape[2]
        idx = int(offset) + torch.arange(length, device=x.device)
        half_id = _half_ids(idx, n_half)
        one = torch.ones((), dtype=dt, device=x.device)
        parts = []
        for h in (0, 1):
            msk = (half_id == h).to(dt)
            cnt = torch.sum(msk)
            mean_c = torch.einsum("l,kcld->kcd", msk, x) / torch.maximum(cnt, one)
            dev = x - mean_c[:, :, None, :]
            m2_c = torch.einsum("l,kcld->kcd", msk, dev * dev)
            parts.append(_chan(stream, h, cnt, mean_c, m2_c, one))
        bm = torch.mean(x, dim=2)
        nb = stream.n_batches + one
        delta_b = bm - stream.bm_mean
        bm_mean = stream.bm_mean + delta_b / nb
        bm_m2 = stream.bm_m2 + delta_b * (bm - bm_mean)
        return StreamState(
            half_n=torch.stack([parts[0][0], parts[1][0]], dim=2),
            half_mean=torch.stack([parts[0][1], parts[1][1]], dim=2),
            half_m2=torch.stack([parts[0][2], parts[1][2]], dim=2),
            n_batches=nb, n_total=stream.n_total + float(length),
            bm_mean=bm_mean, bm_m2=bm_m2,
        )

    return update


def make_stream_update_masked(n_half: int, n_chains: int):
    """The adaptive executor's fold-in ``update(stream, chunk, offset,
    mask)``: ``offset`` an int or a (K,) tensor of per-subset offsets,
    ``mask`` (K,) with 1 for a live subset and 0 for a frozen one. Every
    contribution of a frozen row (half moments, batch counter, batch
    means) is zeroed, so its statistics stay exactly the
    freeze-boundary values. Needs ``init_stream(...,
    per_subset_counts=True)``; live rows update as
    :func:`make_stream_update` does."""
    del n_chains

    def update(stream: StreamState, chunk: torch.Tensor, offset, mask) -> StreamState:
        if stream.n_batches.dim() != 1:
            raise ValueError(
                "masked stream updates need per-subset batch counters — "
                "init_stream(per_subset_counts=True)"
            )
        dt = stream.half_mean.dtype
        x = _as_kcld(chunk, dt)
        mk = mask.to(dt)
        k, length = x.shape[0], x.shape[2]
        steps = torch.arange(length, device=x.device)
        if torch.is_tensor(offset):  # per-subset offsets
            idx = offset.to(device=x.device, dtype=torch.int64)[:, None] + steps
        else:
            idx = (int(offset) + steps)[None].expand(k, length)
        half_id = _half_ids(idx, n_half)
        one = torch.ones((), dtype=dt, device=x.device)
        parts = []
        for h in (0, 1):
            msk = (half_id == h).to(dt) * mk[:, None]  # (K, L)
            cnt = torch.sum(msk, dim=1)
            mean_c = (torch.einsum("kl,kcld->kcd", msk, x)
                      / torch.maximum(cnt, one)[:, None, None])
            dev = x - mean_c[:, :, None, :]
            m2_c = torch.einsum("kl,kcld->kcd", msk, dev * dev)
            parts.append(_chan(stream, h, cnt[:, None], mean_c, m2_c, one))
        bm = torch.mean(x, dim=2)
        nb = stream.n_batches + mk
        delta_b = bm - stream.bm_mean
        w_b = (mk / torch.maximum(nb, one))[:, None, None]
        bm_mean = stream.bm_mean + delta_b * w_b
        bm_m2 = stream.bm_m2 + delta_b * (bm - bm_mean) * mk[:, None, None]
        return StreamState(
            half_n=torch.stack([parts[0][0], parts[1][0]], dim=2),
            half_mean=torch.stack([parts[0][1], parts[1][1]], dim=2),
            half_m2=torch.stack([parts[0][2], parts[1][2]], dim=2),
            n_batches=nb, n_total=stream.n_total + mk * float(length),
            bm_mean=bm_mean, bm_m2=bm_m2,
        )

    return update


def make_stream_stats(n_chains: int):
    """The boundary statistics ``stats(stream)`` -> ``(rhat, ess,
    rhat_max, ess_min)``: (K, d) per-parameter values and the (K,)
    per-subset reductions the executor copies to the host."""
    del n_chains

    def stats(stream: StreamState):
        dt = stream.half_mean.dtype
        dev_ = stream.half_mean.device
        one = torch.ones((), dtype=dt, device=dev_)
        tiny = torch.full((), 1e-30, dtype=dt, device=dev_)
        nan = torch.full((), float("nan"), dtype=dt, device=dev_)

        n_h = stream.half_n  # (K, C, 2)
        pop = (n_h >= 2.0).to(dt)  # populated halves
        m_pop = torch.sum(pop, dim=(1, 2))  # (K,)
        safe_pop = torch.maximum(m_pop, one)[:, None]
        var_h = stream.half_m2 / torch.maximum(n_h - 1.0, one)[..., None]
        w = pop[..., None]
        within = torch.sum(w * var_h, dim=(1, 2)) / safe_pop  # (K, d)
        mu = torch.sum(w * stream.half_mean, dim=(1, 2)) / safe_pop
        dev = stream.half_mean - mu[:, None, None, :]
        b_var = (torch.sum(w * dev * dev, dim=(1, 2))
                 / torch.maximum(m_pop - 1.0, one)[:, None])
        n_bar = (torch.sum(pop * n_h, dim=(1, 2)) / torch.maximum(m_pop, one))[:, None]
        var_est = (n_bar - 1.0) / torch.maximum(n_bar, one) * within + b_var
        rhat = torch.sqrt(var_est / torch.maximum(within, tiny))
        rhat = torch.where(m_pop[:, None] >= 2.0, rhat, nan)

        # per-chain overall variance: Chan-combine the two halves
        n_c = torch.sum(n_h, dim=2)  # (K, C)
        safe_c = torch.maximum(n_c, one)[..., None]
        mean_c = torch.sum(n_h[..., None] * stream.half_mean, dim=2) / safe_c
        dev_h = stream.half_mean - mean_c[:, :, None, :]
        m2_c = torch.sum(stream.half_m2 + n_h[..., None] * dev_h * dev_h, dim=2)
        var_c = m2_c / torch.maximum(n_c - 1.0, one)[..., None]

        nb, n_tot = stream.n_batches, stream.n_total
        if nb.dim() == 1:  # per-subset counters (the adaptive stream)
            nb_b, nt_b = nb[:, None, None], n_tot[:, None, None]
        else:
            nb_b, nt_b = nb, n_tot
        var_bm = stream.bm_m2 / torch.maximum(nb_b - 1.0, one)
        l_bar = nt_b / torch.maximum(nb_b, one)
        tau = l_bar * var_bm / torch.maximum(var_c, tiny)
        ess_c = nt_b / torch.maximum(tau, one / torch.maximum(nt_b, one))
        ess_c = torch.minimum(ess_c, nt_b)
        ess = torch.sum(ess_c, dim=1)  # (K, d)
        enough = (nb[:, None] if nb.dim() == 1 else nb) >= 2.0
        ess = torch.where(enough, ess, nan)
        return rhat, ess, torch.amax(rhat, dim=1), torch.amin(ess, dim=1)

    return stats


def stream_diagnostics(stream: StreamState) -> Tuple[np.ndarray, np.ndarray]:
    """The full (K, d) streaming R-hat and ESS on the host (the tests'
    comparison hook; the executor copies only the (K,) reductions)."""
    rhat, ess, _, _ = make_stream_stats(0)(stream)
    return rhat.cpu().numpy(), ess.cpu().numpy()


def fetch_nbytes(k: int) -> int:
    """Bytes of the per-boundary streaming copy: two (K,) float32
    vectors (rhat_max, ess_min)."""
    return 8 * int(k)
