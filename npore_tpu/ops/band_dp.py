"""Batched banded 5-state DP as an XLA scan over anti-diagonals.

This is the device engine for the reference align() kernel
(reference: src/aln.pyx:379-667), reformulated for lockstep SIMD execution:

* One *window* = one max_b_rows chunk of one read's banded alignment
  (chunks are independent DPs re-anchored on the original path, so any
  chunk of any read is a parallel work item; reference: src/aln.pyx:445-456).
* The band (2r+1 <= 64 columns) lives on the minor axis; a batch of windows
  is vmapped; rows (anti-diagonals) advance under lax.scan.
* The reference's scatter-style LEN/SHR updates ("lengthen/shorten an
  n-polymer by jumping n rows/cols", src/aln.pyx:601-667) are reformulated
  as gathers at the target cell: for period n the unique source lies n rows
  up at a lane shift of n - dI (LEN) or -dI (SHR), where dI counts original
  'I' steps over those n rows — a per-row scalar, not a per-lane value.
* The reference's run-continuation lookback to the MAT score at the run
  start (src/aln.pyx:622-633) is eliminated by carrying the anchor value
  (plus its band column and row/col coordinate for the validity guards) as
  data alongside each LEN/SHR run — inductively identical to re-reading the
  MAT plane at (a_row - run) / (a_col - run).
* Dynamic np_score lookups np_scores[n-1, l, l +/- k] use precomputed
  (side, n, l, k) tables; k is clamped to 127, exact because the score
  saturates there (call lengths clamp at max_l-1; src/aln.pyx:267-272).

The scan emits the MAT plane's (TYP, RUN) per row; ``tb_slots`` walks it
back into compact per-row (op, count) slots on device. All value math is
float32, bit-matching the golden spec. Together with engine/prepass.py this
is the plain-JAX device step: the engine on the CPU, and the reference the
CUDA kernel (ops/cuda/dp_tb.cu) is compared with and timed against.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import AlignConfig

MAT, INS, LEN, DEL, SHR = 0, 1, 2, 3, 4

LW = 64          # lane width: band padded to 64 (needs 2r+1 <= 64)
WIN = 72         # per-row sequence window length
PADL = 80        # left zero-padding of per-window arrays
KDIM = 128       # k-dimension of the continuation tables
F32 = jnp.float32
I32 = jnp.int32


# ---------------------------------------------------------------------------
# score-table precompute (host, once per score set)
# ---------------------------------------------------------------------------

def build_cont_tables(np_scores: np.ndarray, max_n: int = 6,
                      max_l: int = 100) -> np.ndarray:
    """T[side, n-1, l, k] = np_score(n, l, +k) (side 0) / np_score(n, l, -k)
    (side 1), k in [0, 128); exact np_score semantics incl. clamping
    (reference: src/aln.pyx:255-274 with max_l passed as max_n)."""
    ls = np.arange(101)
    ks = np.arange(KDIM)
    lg, kg = np.meshgrid(ls, ks, indexing="ij")
    out = np.full((2, max_n, 101, KDIM), 100.0, dtype=np.float32)
    for n in range(1, max_n + 1):
        tab = np_scores[n - 1]
        # insertions: call = l + k
        ref_c = np.minimum(lg, max_l - 1)
        call_c = np.minimum(lg + kg, max_l - 1)
        ins = tab[ref_c, call_c].astype(np.float32)
        ins = np.where(lg <= 0, np.float32(100), ins)
        # deletions: call = l - k; negative call is invalid
        call_d = lg - kg
        ok = (lg > 0) & (call_d >= 0)
        dele = tab[ref_c, np.clip(call_d, 0, max_l - 1)].astype(np.float32)
        dele = np.where(ok, dele, np.float32(100))
        out[0, n - 1] = ins
        out[1, n - 1] = dele
    return out


def build_start_tables(l_ref: np.ndarray, cont: np.ndarray, max_n: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-ref-position start penalties: len_start[p, n-1] = np_score(n,
    l_ref[p,n-1], +1), shr_start likewise with -1 (src/aln.pyx:615, 650)."""
    P = l_ref.shape[0]
    ns = np.arange(max_n)
    len_start = cont[0, ns[None, :], l_ref.astype(np.int64), 1]
    shr_start = cont[1, ns[None, :], l_ref.astype(np.int64), 1]
    return len_start.astype(np.float32), shr_start.astype(np.float32)


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

class Tables(NamedTuple):
    sub_flat: Any      # (25,) f32: sub_scores flattened
    cont: Any          # (2, max_n, 101, 128) f32


def _shift(vec, off):
    """out[j] = vec[j + off] with zero fill; off is a traced scalar."""
    pad = np.zeros((8,), vec.dtype)
    ext = jnp.concatenate([pad, vec, pad])
    return jax.lax.dynamic_slice(ext, (8 + off,), (LW,))


def _rev_slice(win, d):
    """lane vector v[j] = win[C - j + d] for the reversed-window convention
    (C = 69 for seq windows); static d."""
    return win[6 + d:70 + d][::-1]


def make_window_dp(R_max: int, cfg: AlignConfig, max_n: int = 6,
                   jit: bool = True):
    """Build the jitted batched DP for windows of up to R_max rows.

    Input arrays per window (see engine/windows.py for construction):
      seqbuf   (PADL + R_max + 40,) int32   int-encoded seq slice, padded
      refbuf   same shape                   int-encoded ref slice
      l_seq, lidx_seq, l_ref, lidx_ref  (PADL + R_max + 40, max_n) int32
      len_start, shr_start              (PADL + R_max + 40, max_n) f32
      inss     (R_max + 8,) int32  local prefix-I counts, 8 zeros in front
      scalars: b_rows, n_ins, n_del (int32)
    Output: (typ (R_max, LW) int8, run (R_max, LW) int32) MAT planes.
    """
    r = cfg.r
    INF = np.float32(cfg.inf)
    istart = np.float32(cfg.indel_start)
    iext = np.float32(cfg.indel_extend)
    lanes = np.arange(LW, dtype=np.int32)  # numpy: avoid eager device constants

    def row_step(carry, t, win, tables: Tables):
        (h_matv, h_matt, h_matr,
         h_lenr, h_lenav, h_lenac, h_lenaa,
         h_shrr, h_shrav, h_shrac, h_shraa,
         p_insv, p_insr, p_delv, p_delr) = carry

        b_rows = win["b_rows"]
        n_ins = win["n_ins"]
        n_del = win["n_del"]
        inss = win["inss"]

        ii = inss[8 + t]
        ii1 = inss[8 + t - 1]
        ii2 = inss[8 + t - 2]

        arow = ii + r - lanes                      # local a_row
        acol = (t - ii) - r + lanes                # local a_col
        in_range = ((arow >= 0) & (acol >= 0) & (arow <= n_ins)
                    & (acol <= n_del) & (t <= b_rows - 1))
        wall = (lanes == 0) | (lanes == 2 * r)
        live = in_range & ~wall & (lanes < 2 * r + 1)
        first_row = arow == 0
        first_col = acol == 0

        # --- per-row data loads ---
        sstart = PADL + ii + r - 70
        seq_win = jax.lax.dynamic_slice(win["seqbuf"], (sstart,), (WIN,))
        rstart = PADL + (t - ii) - r - 1
        ref_win = jax.lax.dynamic_slice(win["refbuf"], (rstart,), (WIN,))

        def SEQ(d):   # seq[arow - 1 + d]
            return _rev_slice(seq_win, d)

        def REF(d):   # ref[acol - 1 + d]; window starts at acol(j=0)-1
            return ref_win[d:64 + d]

        lrstart = PADL + (t - ii) - r - 6
        l_ref_w = jax.lax.dynamic_slice(win["l_ref"], (lrstart, 0), (WIN, max_n))
        lidx_ref_w = jax.lax.dynamic_slice(win["lidx_ref"], (lrstart, 0), (WIN, max_n))
        lstart_w = jax.lax.dynamic_slice(win["len_start"], (lrstart, 0), (WIN, max_n))
        sstart_w = jax.lax.dynamic_slice(win["shr_start"], (lrstart, 0), (WIN, max_n))
        lsstart = PADL + ii + r - 70
        l_seq_w = jax.lax.dynamic_slice(win["l_seq"], (lsstart, 0), (WIN, max_n))
        lidx_seq_w = jax.lax.dynamic_slice(win["lidx_seq"], (lsstart, 0), (WIN, max_n))

        def LREF(dd, ni):    # l_ref[acol + dd, ni]
            return l_ref_w[6 + dd:70 + dd, ni]

        def LIDXREF(dd, ni):
            return lidx_ref_w[6 + dd:70 + dd, ni]

        def LSTART(dd, ni):
            return lstart_w[6 + dd:70 + dd, ni]

        def SSTART(dd, ni):
            return sstart_w[6 + dd:70 + dd, ni]

        def LSEQ(dd, ni):    # l_seq[arow + dd, ni]
            return l_seq_w[7 + dd:71 + dd, ni][::-1]

        def LIDXSEQ(dd, ni):
            return lidx_seq_w[7 + dd:71 + dd, ni][::-1]

        # n-polymer info zero-guards at the global sequence ends
        # (src/aln.pyx:510-521): a_col >= a_cols-1 / a_row >= a_rows-1
        ref_zero = acol >= win["ref_guard"]
        seq_zero = arow >= win["seq_guard"]

        step1 = ii - ii1

        # --- INS (src/aln.pyx:524-543) ---
        matv_top = _shift(h_matv[0], 1 - step1)
        insv_top = _shift(p_insv, 1 - step1)
        insr_top = _shift(p_insr, 1 - step1)
        v1 = matv_top + istart
        v2 = insv_top + iext
        use2 = v2 < v1
        run2 = jnp.where(arow == 1, 1, insr_top + 1)
        ins_v = jnp.where(use2, v2, v1)
        ins_r = jnp.where(use2, run2, 1)
        ins_t = np.full((LW,), INS, dtype=np.int8)
        ins_v = jnp.where(first_row, (acol + 1).astype(F32) * INF, ins_v)
        ins_t = jnp.where(first_row, np.int8(DEL), ins_t)
        ins_r = jnp.where(first_row, acol, ins_r)

        # --- DEL (src/aln.pyx:546-565) ---
        matv_left = _shift(h_matv[0], -step1)
        delv_left = _shift(p_delv, -step1)
        delr_left = _shift(p_delr, -step1)
        v1 = matv_left + istart
        v2 = delv_left + iext
        use2 = v2 < v1
        run2 = jnp.where(acol == 1, 1, delr_left + 1)
        del_v = jnp.where(use2, v2, v1)
        del_r = jnp.where(use2, run2, 1)
        del_t = np.full((LW,), DEL, dtype=np.int8)
        del_v = jnp.where(first_col, (arow + 1).astype(F32) * INF, del_v)
        del_t = jnp.where(first_col, np.int8(INS), del_t)
        del_r = jnp.where(first_col, arow, del_r)

        # --- LEN pre (gather form of src/aln.pyx:601-633) ---
        len_v = (arow + acol).astype(F32) * INF
        len_t = np.full((LW,), MAT, dtype=np.int8)
        len_r = np.zeros((LW,), np.int32)
        len_av = np.zeros((LW,), np.float32)
        len_ac = np.zeros((LW,), np.int32)
        len_aa = np.zeros((LW,), np.int32)

        shr_v = (arow + acol).astype(F32) * INF
        shr_t = np.full((LW,), MAT, dtype=np.int8)
        shr_r = np.zeros((LW,), np.int32)
        shr_av = np.zeros((LW,), np.float32)
        shr_ac = np.zeros((LW,), np.int32)
        shr_aa = np.zeros((LW,), np.int32)

        for n in range(max_n, 0, -1):
            ni = n - 1
            iin = inss[8 + t - n]
            dI = ii - iin

            # ---- LEN source: (arow - n, acol), row t-n, lane + (n - dI) ----
            s_n = n - dI
            matv_src = _shift(h_matv[n - 1], s_n)
            lenr_src = _shift(h_lenr[n - 1], s_n).astype(I32)
            lenav_src = _shift(h_lenav[n - 1], s_n)
            lenac_src = _shift(h_lenac[n - 1], s_n).astype(I32)
            lenaa_src = _shift(h_lenaa[n - 1], s_n).astype(I32)

            src_lane = lanes + s_n
            src_ok = ((arow - n >= 0) & (src_lane >= 1) & (src_lane <= 2 * r - 1)
                      & (t >= n))

            l_n = jnp.where(ref_zero, 0, LREF(0, ni))
            lidx_n = jnp.where(ref_zero, 0, LIDXREF(0, ni))
            lseq_src = jnp.where(arow - n >= win["seq_guard"], 0, LSEQ(-n, ni))
            lidxseq_src = jnp.where(arow - n >= win["seq_guard"], 0,
                                    LIDXSEQ(-n, ni))

            # match(seq[siS+1 : +n], ref[riT+1 : +n]) with reference slice
            # truncation semantics (src/aln.pyx:362-372, 604-607)
            lenA = jnp.clip(n_ins + 1 - (arow - n), 0, n)
            lenB = jnp.clip(n_del + 1 - acol, 0, n)
            mok = lenA == lenB
            for k in range(n):
                mok = mok & ((k >= lenA) | (SEQ(1 - n + k) == REF(1 + k)))

            valid = (src_ok & (l_n > 0) & (lseq_src > 0) & (lidx_n == 0)
                     & mok & (lanes > 0))

            # start vs continue (by the source's seq-side l_idx)
            start_case = lidxseq_src == 0
            cand_s = matv_src + LSTART(0, ni)
            k_c = lenr_src // n + 1
            flat = ((jnp.int32(0 * max_n + ni) * 101 + l_n) * KDIM
                    + jnp.minimum(k_c, KDIM - 1))
            cont_val = jnp.take(tables.cont, flat, mode="clip")
            cand_c = lenav_src + cont_val
            cont_ok = (lenr_src > 0) & (lenaa_src >= 0) & (lenac_src < 2 * r)
            cand = jnp.where(start_case, cand_s,
                             jnp.where(cont_ok, cand_c, np.float32(np.inf)))
            new_r = jnp.where(start_case, n, lenr_src + n)
            new_av = jnp.where(start_case, matv_src, lenav_src)
            new_ac = jnp.where(start_case, src_lane, lenac_src)
            new_aa = jnp.where(start_case, arow - n, lenaa_src)

            upd = valid & (cand < len_v)
            len_v = jnp.where(upd, cand, len_v)
            len_t = jnp.where(upd, np.int8(LEN), len_t)
            len_r = jnp.where(upd, new_r, len_r)
            len_av = jnp.where(upd, new_av, len_av)
            len_ac = jnp.where(upd, new_ac, len_ac)
            len_aa = jnp.where(upd, new_aa, len_aa)

            # ---- SHR source: (arow, acol - n), row t-n, lane - dI ----
            s_n2 = -dI
            matv_src2 = _shift(h_matv[n - 1], s_n2)
            shrr_src = _shift(h_shrr[n - 1], s_n2).astype(I32)
            shrav_src = _shift(h_shrav[n - 1], s_n2)
            shrac_src = _shift(h_shrac[n - 1], s_n2).astype(I32)
            shraa_src = _shift(h_shraa[n - 1], s_n2).astype(I32)

            src_lane2 = lanes + s_n2
            src_ok2 = ((acol - n >= 0) & (src_lane2 >= 1)
                       & (src_lane2 <= 2 * r - 1) & (t >= n))

            ref_zero_src = (acol - n) >= win["ref_guard"]
            l_n2 = jnp.where(ref_zero_src, 0, LREF(-n, ni))
            lidx_n2 = jnp.where(ref_zero_src, 0, LIDXREF(-n, ni))

            valid2 = src_ok2 & (l_n2 > 0) & (lanes < 2 * r)

            start2 = lidx_n2 == 0
            cand_s2 = matv_src2 + SSTART(-n, ni)
            k_c2 = shrr_src // n + 1
            flat2 = ((jnp.int32(1 * max_n + ni) * 101 + l_n2) * KDIM
                     + jnp.minimum(k_c2, KDIM - 1))
            cont_val2 = jnp.take(tables.cont, flat2, mode="clip")
            cand_c2 = shrav_src + cont_val2
            cont_ok2 = (shrr_src > 0) & (shraa_src >= 0) & (shrac_src > 0)
            cand2 = jnp.where(start2, cand_s2,
                              jnp.where(cont_ok2, cand_c2, np.float32(np.inf)))
            new_r2 = jnp.where(start2, n, shrr_src + n)
            new_av2 = jnp.where(start2, matv_src2, shrav_src)
            new_ac2 = jnp.where(start2, src_lane2, shrac_src)
            new_aa2 = jnp.where(start2, acol - n, shraa_src)

            upd2 = valid2 & (cand2 < shr_v)
            shr_v = jnp.where(upd2, cand2, shr_v)
            shr_t = jnp.where(upd2, np.int8(SHR), shr_t)
            shr_r = jnp.where(upd2, new_r2, shr_r)
            shr_av = jnp.where(upd2, new_av2, shr_av)
            shr_ac = jnp.where(upd2, new_ac2, shr_ac)
            shr_aa = jnp.where(upd2, new_aa2, shr_aa)

        # --- MAT (src/aln.pyx:568-592) ---
        dI2 = ii - ii2
        matv_diag = _shift(h_matv[1], 1 - dI2)
        matt_diag = _shift(h_matt[1], 1 - dI2)
        matr_diag = _shift(h_matr[1], 1 - dI2).astype(I32)
        sub = jnp.take(tables.sub_flat, SEQ(0) * 5 + REF(0), mode="clip")
        can_diag = (arow > 0) & (acol > 0)
        run_diag = jnp.where(matt_diag == MAT, matr_diag + 1, 1)
        v1 = jnp.where(can_diag, matv_diag + sub, del_v + INF)
        mat_v = jnp.where(can_diag, matv_diag + sub, np.float32(0))
        mat_t = jnp.where(can_diag, np.int8(MAT), np.int8(MAT))
        mat_r = jnp.where(can_diag, run_diag, 0)
        for ti, tv, tr in ((INS, ins_v, ins_r), (LEN, len_v, len_r),
                           (DEL, del_v, del_r), (SHR, shr_v, shr_r)):
            upd = tv < v1
            v1 = jnp.where(upd, tv, v1)
            mat_v = jnp.where(upd, tv, mat_v)
            mat_t = jnp.where(upd, np.int8(ti), mat_t)
            mat_r = jnp.where(upd, tr, mat_r)

        # --- post overwrites: first-row LEN / first-col SHR
        # (src/aln.pyx:596-599, 637-640; applied after the MAT reduce) ---
        len_v = jnp.where(first_row, acol.astype(F32) * INF, len_v)
        len_t = jnp.where(first_row, np.int8(DEL), len_t)
        len_r = jnp.where(first_row, acol, len_r)
        shr_v = jnp.where(first_col, arow.astype(F32) * INF, shr_v)
        shr_t = jnp.where(first_col, np.int8(INS), shr_t)
        shr_r = jnp.where(first_col, arow, shr_r)

        # --- walls and out-of-range cells (src/aln.pyx:497-507) ---
        wall_v = (t + 1).astype(F32) * INF

        def finalize(v, tt, rr):
            v = jnp.where(wall & in_range, wall_v, v)
            tt = jnp.where(wall & in_range, np.int8(MAT), tt)
            rr = jnp.where(wall & in_range, 0, rr)
            v = jnp.where(in_range, v, 0.0)
            tt = jnp.where(in_range, tt, np.int8(MAT))
            rr = jnp.where(in_range, rr, 0)
            return v, tt, rr

        mat_v, mat_t, mat_r = finalize(mat_v, mat_t, mat_r)
        ins_v, ins_t, ins_r = finalize(ins_v, ins_t, ins_r)
        del_v, del_t, del_r = finalize(del_v, del_t, del_r)
        len_v, len_t, len_r = finalize(len_v, len_t, len_r)
        shr_v, shr_t, shr_r = finalize(shr_v, shr_t, shr_r)
        zero_lane = ~live
        len_av = jnp.where(zero_lane, 0.0, len_av)
        len_ac = jnp.where(zero_lane, 0, len_ac)
        len_aa = jnp.where(zero_lane, 0, len_aa)
        shr_av = jnp.where(zero_lane, 0.0, shr_av)
        shr_ac = jnp.where(zero_lane, 0, shr_ac)
        shr_aa = jnp.where(zero_lane, 0, shr_aa)

        def push(hist, row):
            return jnp.concatenate([row[None], hist[:-1]], axis=0)

        new_carry = (push(h_matv, mat_v), push(h_matt, mat_t),
                     push(h_matr, mat_r),
                     push(h_lenr, len_r), push(h_lenav, len_av),
                     push(h_lenac, len_ac), push(h_lenaa, len_aa),
                     push(h_shrr, shr_r), push(h_shrav, shr_av),
                     push(h_shrac, shr_ac), push(h_shraa, shr_aa),
                     ins_v, ins_r, del_v, del_r)
        return new_carry, (mat_t, mat_r)

    H = max(max_n, 2)

    def one_window(win, tables):
        z32 = lambda *sh: np.zeros(sh, np.float32)
        zi = lambda *sh: np.zeros(sh, np.int32)
        carry = (z32(H, LW), np.zeros((H, LW), np.int8), zi(H, LW),
                 zi(H, LW), z32(H, LW), zi(H, LW), zi(H, LW),
                 zi(H, LW), z32(H, LW), zi(H, LW), zi(H, LW),
                 z32(LW), zi(LW), z32(LW), zi(LW))
        _, (typs, runs) = jax.lax.scan(
            lambda c, t: row_step(c, t, win, tables), carry,
            np.arange(R_max, dtype=np.int32))
        return typs, runs

    batched = jax.vmap(one_window, in_axes=(0, None))
    return jax.jit(batched) if jit else batched


# ---------------------------------------------------------------------------
# traceback to compact slots
# ---------------------------------------------------------------------------

OP_EQ, OP_X, OP_I, OP_D = 0, 1, 2, 3
SLOT_MAX = 63     # largest count one slot byte holds


def tb_slots(typ, run, inss, seq, ref, n_ins, n_del, r: int):
    """Backward traceback over the MAT planes (src/aln.pyx:670-742) as a
    lockstep scan over rows.

    typ/run: (B, R, LW) MAT planes; inss: (B, R) prefix-I counts; seq/ref:
    (B, R) int bases; n_ins/n_del: (B,). Returns ``slots`` (B, R) uint8 and
    ``bail`` (B,) int32.

    Row t's slot byte is ``op | count << 2`` (op: OP_EQ/OP_X/OP_I/OP_D), 0
    for no emission; read in ascending row order the slots spell the
    forward CIGAR. A MAT step emits one '='/'X' at its row; an I/D run of
    length L emits at its row, and runs longer than SLOT_MAX spill further
    chunks onto the rows t-1, t-2, ... that the run skips. ``bail`` flags a
    traceback error (run < 1, a path cell outside the band, or a step past
    the origin); the engine then redoes the alignment with the golden
    engine. ops/cuda/dp_tb.cu emits the identical bytes.
    """
    B, R, _ = typ.shape
    cell = typ.astype(I32) | (run << 3)
    xs = (jnp.moveaxis(cell, 1, 0)[::-1], jnp.swapaxes(inss, 0, 1)[::-1],
          jnp.arange(R - 1, -1, -1, dtype=I32))
    seqp = jnp.concatenate([jnp.zeros((B, 1), I32), seq.astype(I32)], 1)
    refp = jnp.concatenate([jnp.zeros((B, 1), I32), ref.astype(I32)], 1)

    def base_at(buf, pos):             # buf[pos], 0 outside [0, R)
        v = jnp.take_along_axis(buf, jnp.clip(pos + 1, 0, R)[:, None],
                                axis=1)[:, 0]
        return jnp.where(pos < R, v, 0)

    def step(carry, x):
        arow, acol, pend, done, bail, erem, eop = carry
        crow, ii, t = x
        active = (done == 0) & (arow + acol == t)
        lane = ii - arow + r
        lok = (lane >= 0) & (lane < LW)
        cv = jnp.take_along_axis(crow, jnp.clip(lane, 0, LW - 1)[:, None],
                                 axis=1)[:, 0]
        ty = cv & 7
        rn = cv >> 3
        fresh = active & (pend == 0)
        bad = fresh & ((rn < 1) | ~lok)
        is_i = fresh & ((ty == INS) | (ty == LEN)) & ~bad
        is_d = fresh & ((ty == DEL) | (ty == SHR)) & ~bad
        is_m = fresh & (ty == MAT) & ~bad
        pend = jnp.where(is_m, rn, pend)
        in_m = active & (pend > 0)
        cmp_op = jnp.where(base_at(seqp, arow - 1) == base_at(refp, acol - 1),
                           OP_EQ, OP_X)
        is_run = is_i | is_d
        cur_op = jnp.where(is_run, jnp.where(is_i, OP_I, OP_D), eop)
        cur_rem = jnp.where(is_run, rn, erem)
        emit_n = jnp.minimum(cur_rem, SLOT_MAX)
        has = is_run | (erem > 0)
        slot = jnp.where(in_m, cmp_op + (1 << 2), 0)
        slot = jnp.where(has, cur_op + (emit_n << 2), slot)
        erem = jnp.where(has, cur_rem - emit_n, erem)
        arow = jnp.where(in_m, arow - 1, jnp.where(is_i, arow - rn, arow))
        acol = jnp.where(in_m, acol - 1, jnp.where(is_d, acol - rn, acol))
        pend = jnp.where(in_m, pend - 1, pend)
        bail = jnp.where(bad | (active & ((arow < 0) | (acol < 0))), 1, bail)
        done = jnp.where(((arow <= 0) & (acol <= 0)) | (bail > 0), 1, done)
        return (arow, acol, pend, done, bail, erem, cur_op), slot

    z = jnp.zeros((B,), I32)
    n_ins = n_ins.astype(I32)
    n_del = n_del.astype(I32)
    done0 = ((n_ins <= 0) & (n_del <= 0)).astype(I32)
    (_, _, _, done, bail, _, _), slots = jax.lax.scan(
        step, (n_ins, n_del, z, done0, z, z, z), xs)
    slots = jnp.swapaxes(slots[::-1], 0, 1).astype(jnp.uint8)
    return slots, bail | (1 - done)
