"""On-device n-polymer scan (XLA/jnp, batched over windows).

Exact reformulation of the reference scanner (src/aln.pyx:179-251, golden
model golden/npinfo.py) as segmented associative scans, derived from the
sequential spec:

* per period n, self-similarity runs partition each residue class (mod n)
  into chains; within a chain every start shares the same coverage end, so
  "start s covers position p" is equivalent to "p is chain-reachable from
  s" -- no per-start interval logic is needed;
* the final writer of p is the LAST chain-predecessor with raw length
  > max_l if any exists (those always overwrite the clamped stored value),
  otherwise the FIRST qualifying chain-predecessor (later starts in a
  chain have strictly smaller raw lengths and never overwrite);
* L_IDX is only consumed as the predicate L_IDX == 0, which reduces to
  ``winner == p``.

Outputs per window: L (clamped) and LZ (= L_IDX==0) planes, (B, max_n, P).
Segmented min/max scans run along the position axis via
jax.lax.associative_scan with a (value, segment-reset) monoid.
"""
from __future__ import annotations

import numpy as np


def _segscan2(vmin, vmax, keep, axis):
    """Fused segmented min+max scan sharing one reset mask.

    One associative_scan carrying (min, max, keep) replaces two
    independent (val, keep) scans: ~25% less carried traffic and half
    the scan-kernel chains (the two scans always share `keep` here).
    """
    import jax
    import jax.numpy as jnp

    def op(a, b):
        af, al, ak = a
        bf, bl, bk = b
        return (jnp.where(bk, jnp.minimum(af, bf), bf),
                jnp.where(bk, jnp.maximum(al, bl), bl),
                ak & bk)
    omin, omax, _ = jax.lax.associative_scan(
        op, (vmin, vmax, keep), axis=axis)
    return omin, omax


def np_info_device(seq, max_n: int = 6, max_l: int = 100):
    """seq: (B, P) int32 (0='N'). Returns (L, LZ): (B, max_n, P) int32.

    Positions past each window's real length must be 0-padded by the
    caller; padding yields L=0 / LZ=1 exactly like the host packers.
    """
    import jax
    import jax.numpy as jnp

    B, P = seq.shape
    pos = jnp.arange(P, dtype=jnp.int32)[None, :]
    BIG = jnp.int32(np.int32(2 ** 30))
    M = jnp.int32(P + 1)          # raw < M encoding multiplier

    # suffix run scans for ALL periods in ONE reverse cummin: each
    # (b, n) row is independent, so stacking turns max_n separate
    # flip+cummin+flip chains into a single scan over a (B, max_n, P)
    # block (fewer kernel chains, no rev passes)
    m_all = jnp.stack(
        [jnp.concatenate(
            [seq[:, :-n] == seq[:, n:], jnp.zeros((B, n), bool)], axis=1)
         for n in range(1, max_n + 1)], axis=1)       # (B, max_n, P)
    nf_all = jax.lax.cummin(
        jnp.where(m_all, jnp.int32(P), pos[:, None, :]),
        axis=2, reverse=True)
    t_all = jnp.maximum(nf_all - pos[:, None, :], 0)  # (B, max_n, P)

    Ls = []
    LZs = []
    stored = []                   # clamped L planes of finished layers
    for n in range(1, max_n + 1):
        t = t_all[:, n - 1]
        units = t // n
        raw = jnp.where(units > 0, units + 1, 0)
        qual = (raw > 2) & (seq != 0)
        for n2 in range(1, n):
            qual = qual & (raw * n > stored[n2 - 1] * n2)

        # chain link: p-n reaches p when its run spans at least n more
        t_prev = jnp.concatenate(
            [jnp.zeros((B, n), t.dtype), t[:, :-n]], axis=1)
        link = (pos >= n) & (t_prev >= n)

        # the scans step by n: put residue classes on their own (major)
        # axis and scan along the large minor axis
        pad = (-P) % n
        def classes(x, fill):
            xp = jnp.concatenate(
                [x, jnp.full((B, pad), fill, x.dtype)], axis=1) if pad else x
            return jnp.swapaxes(xp.reshape(B, (P + pad) // n, n), 1, 2)

        def declass(x):
            return jnp.swapaxes(x, 1, 2).reshape(B, -1)[:, :P]

        enc_first = jnp.where(qual, pos * M + raw, BIG)
        big_run = qual & (raw > max_l)
        enc_last = jnp.where(big_run, pos * M + raw, -1)
        first, last = _segscan2(
            classes(enc_first, BIG), classes(enc_last, jnp.int32(-1)),
            classes(link, False), axis=2)
        first = declass(first)
        last = declass(last)

        has_first = first < BIG
        has_big = last >= 0
        win = jnp.where(has_big, last // M, first // M)
        raw_w = jnp.where(has_big, last % M, first % M)
        covered = has_first | has_big
        L = jnp.where(covered, jnp.minimum(raw_w, max_l), 0)
        LZ = jnp.where(covered, (win == pos).astype(jnp.int32), 1)
        Ls.append(L.astype(jnp.int32))
        LZs.append(LZ)
        stored.append(Ls[-1])

    return jnp.stack(Ls, axis=1), jnp.stack(LZs, axis=1)
