"""Within-subset sharded factorization — twin of
``smk_tpu/parallel/sharded_chol.py``: one m x m matrix whose row blocks
live on the mesh's devices and never gather on one.

No north-star shape needs it (m = 3906 is ~61 MB of fp32 correlation);
it is the path for a subset that outgrows a card. The factor is the
left-looking blocked form of ``ops/chol.blocked_cholesky``: the padded
matrix's block rows of width ``block_size`` are dealt contiguously to
the entries. For block column k, the entry that holds block row k forms
its diagonal block's Schur complement, factors it once (``cholesky``)
and inverts it; the factored panel of that row and the inverse are
copied to the entries holding later rows, and each entry runs the Schur
update and the panel scaling of its own rows (two GEMMs). Within one
process there is no collective, only peer copies. The arithmetic is the
blocked form's, its GEMMs split by rows, so it agrees with
``blocked_cholesky`` to the GEMMs' summation order.

:func:`sharded_matvec` is the row-sharded product each entry computes
on its rows (the building block of a sharded CG u-solve).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from smk_torch.ops.chol import cholesky


class RowBlocks(NamedTuple):
    """A matrix (or vector) held as contiguous row blocks:
    ``blocks[i]`` is rows ``ranges[i]`` on entry i's device."""

    blocks: tuple
    ranges: tuple

    def gather(self, device=None) -> torch.Tensor:
        """The whole array on ``device`` (default the first block's)."""
        dev = self.blocks[0].device if device is None else torch.device(device)
        return torch.cat([b.to(dev) for b in self.blocks])


class RowSharding(NamedTuple):
    """Rows over the mesh's (local) entries, columns whole: the layout
    every op here assumes (the twin's ``NamedSharding(mesh, P(axis,
    None))``)."""

    mesh: object
    axis: str

    def ranges(self, n_rows: int, unit: int = 1) -> List[tuple]:
        """Contiguous (lo, hi) row ranges, one per local entry, in units of
        ``unit`` rows, the leading entries taking the remainder."""
        n_ent = len(self.mesh.local_entries())
        units = -(-n_rows // unit)
        base, rem = divmod(units, n_ent)
        out, lo = [], 0
        for i in range(n_ent):
            hi = min(n_rows, lo + (base + (1 if i < rem else 0)) * unit)
            out.append((lo, hi))
            lo = hi
        return out

    def place(self, t: torch.Tensor, unit: int = 1) -> RowBlocks:
        """``t``'s rows dealt to the entries (on their devices)."""
        ents = self.mesh.local_entries()
        rng = self.ranges(t.shape[0], unit)
        return RowBlocks(tuple(t[lo:hi].to(e.device) for e, (lo, hi) in zip(ents, rng)),
                         tuple(rng))


def row_sharding(mesh, axis: Optional[str] = None) -> RowSharding:
    """Rows over the mesh axis, columns replicated."""
    if mesh.multi_process:
        raise ValueError("row sharding spans one process's entries; the mesh spans several")
    return RowSharding(mesh, axis or mesh.axis_names[0])


def sharded_cholesky(mat, mesh, *, jitter: float = 0.0, block_size: int = 512,
                     axis: Optional[str] = None) -> RowBlocks:
    """Lower Cholesky factor of ``mat + jitter * I`` (``mat``: (m, m), a
    tensor or RowBlocks of one) with its row blocks on the mesh's
    entries, returned as :class:`RowBlocks` of the factor's rows. The
    padded tail is an identity, as in ``blocked_cholesky``; a diagonal
    block that is not positive definite factors to NaN, and the GEMMs
    carry it on."""
    lay = row_sharding(mesh, axis)
    full = mat.gather() if isinstance(mat, RowBlocks) else mat
    m = full.shape[-1]
    b = int(block_size)
    nb = -(-m // b)
    mp = nb * b
    ents = mesh.local_entries()
    rng = lay.ranges(mp, unit=b)
    blocks = []
    for e, (lo, hi) in zip(ents, rng):
        blk = torch.zeros((hi - lo, mp), dtype=full.dtype, device=e.device)
        real = max(0, min(hi, m) - lo)
        if real:
            blk[:real, :m] = full[lo:lo + real].to(e.device)
        for r in range(lo, hi):  # the identity tail, and the jitter
            if r >= m:
                blk[r - lo, r] = 1.0
        if jitter and real:
            blk[:real].diagonal(offset=lo)[:real].add_(jitter)
        blocks.append(blk)
    owner = [next(i for i, (lo, hi) in enumerate(rng) if lo <= r * b < hi) for r in range(nb)]
    eye_b = {}
    for k in range(nb):
        lo, hi = k * b, (k + 1) * b
        o = owner[k]
        olo = rng[o][0]
        own = blocks[o]
        # the diagonal block's Schur complement, factored once
        s_kk = own[lo - olo:hi - olo, lo:hi]
        if k > 0:
            s_kk = s_kk - own[lo - olo:hi - olo, :lo] @ own[lo - olo:hi - olo, :lo].mT
        l_kk = cholesky(s_kk)
        dev_o = own.device
        if str(dev_o) not in eye_b:
            eye_b[str(dev_o)] = torch.eye(b, dtype=own.dtype, device=dev_o)
        inv_kk = torch.linalg.solve_triangular(l_kk, eye_b[str(dev_o)], upper=False)
        panel = own[lo - olo:hi - olo, :lo]
        own[lo - olo:hi - olo, lo:hi] = l_kk
        # every entry's rows below the diagonal block: update and scale
        for i, (e, (elo, ehi)) in enumerate(zip(ents, rng)):
            r0 = max(elo, hi)
            if r0 >= ehi:
                continue
            blk = blocks[i]
            rows = blk[r0 - elo:ehi - elo]
            p_i, inv_i = panel.to(blk.device), inv_kk.to(blk.device)
            s = rows[:, lo:hi]
            if k > 0:
                s = s - rows[:, :lo] @ p_i.mT
            rows[:, lo:hi] = s @ inv_i.mT
    out = []
    for blk, (lo, hi) in zip(blocks, rng):
        real = max(0, min(hi, m) - lo)
        out.append(torch.tril(blk[:real, :m], diagonal=lo))
    return RowBlocks(tuple(out), tuple((lo, min(hi, m)) for lo, hi in rng))


def sharded_matvec(mat, vec: torch.Tensor, mesh, *, axis: Optional[str] = None) -> RowBlocks:
    """``mat @ vec`` with ``mat`` row-sharded (a tensor is dealt first):
    each entry contracts its rows against its copy of the vector; the
    result comes back as :class:`RowBlocks` of its rows."""
    lay = row_sharding(mesh, axis)
    blocks = mat if isinstance(mat, RowBlocks) else lay.place(mat)
    return RowBlocks(tuple(bl @ vec.to(bl.device) for bl in blocks.blocks), blocks.ranges)
