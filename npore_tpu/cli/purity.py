"""Pileup Gini-purity CLI (reference: src/purity.py).

Measures per-column pileup concordance for up to 4 BAMs: the base score is
sum((count/depth)^2) over 'ACGT*' and the insertion score is the analogous
sum over distinct insertion strings plus the no-insertion mass
(reference: src/purity.py:62-72). The reference shells out to
``samtools mpileup | cut -f5`` and fans columns over mp.Pool
(src/purity.py:182-191); here columns come from the in-process pileup
engine (io/pileup.py) and scores are computed in one pass. Scores are
cached per BAM as .npy and re-plotted with --plot_only like the reference.

Usage: python -m npore_tpu.cli.purity --bams a.bam,b.bam --ref ref.fasta \
           --out_prefix out [--contig ctg] [...]
"""
from __future__ import annotations

import argparse
import os
import sys
from collections import defaultdict
from time import perf_counter
from typing import List, Optional, Tuple

import numpy as np

from ..io.bam import open_alignment_file
from ..io.pileup import pileup_columns


def argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--bams", required=True,
                   help="Comma-separated BAM/SAM files (up to 4).")
    p.add_argument("--names", type=str, default=None,
                   help="Comma-separated display names for the BAMs.")
    p.add_argument("--ref", type=str, default=None,
                   help="Reference FASTA (optional; columns use read bases).")
    p.add_argument("--contig", type=str)
    p.add_argument("--contig_beg", type=int)
    p.add_argument("--contig_end", type=int)
    p.add_argument("--min_bq", type=int, default=13,
                   help="Minimum base quality (samtools mpileup default).")
    p.add_argument("--out_prefix", required=True)
    p.add_argument("--plot", action="store_true",
                   help="Also write purity histogram plots.")
    p.add_argument("--plot_only", action="store_true",
                   help="Re-plot from cached .npy scores without reading "
                        "the BAMs (reference: src/purity.py:196-207).")
    p.add_argument("--device_gini", action="store_true",
                   help="Compute the per-column Gini on the accelerator "
                        "(batched integer moments; new, no reference "
                        "equivalent — replaces the per-column mp.Pool of "
                        "src/purity.py:190-191).")
    return p


def _parse_column(column: str) -> Tuple[dict, dict]:
    """Tokenize one mpileup column into base and insertion counts
    (reference: src/purity.py:11-84)."""
    bases = defaultdict(int)
    inss = defaultdict(int)
    i = 0
    n_chars = len(column)
    while i < n_chars:
        c = column[i]
        if c == "^":
            i += 2
        elif c == "$":
            i += 1
        elif c in "ACGT*":
            bases[c] += 1
            i += 1
        elif c in "+-":
            j = i + 1
            skip = 0
            while j < n_chars and column[j].isdigit():
                skip = skip * 10 + int(column[j])
                j += 1
            if c == "+":
                inss[column[j:j + skip]] += 1
            i = j + skip
        else:
            i += 1      # N / mismatch-case chars: ignore
    return bases, inss


def compute_purity(column: str) -> Optional[Tuple[float, float]]:
    """Gini purity of one mpileup column string
    (reference: src/purity.py:11-84)."""
    bases, inss = _parse_column(column)
    n = sum(bases.values())
    if not n:
        return None
    base_score = sum((bases[b] / n) ** 2 for b in "ACGT*")
    not_inss = n - sum(inss.values())
    ins_score = (not_inss / n) ** 2 + sum((v / n) ** 2
                                          for v in inss.values())
    return base_score, ins_score


INS_SLOTS = 8        # distinct insertion sequences per column on the device
                     # path; deeper columns fall back to the host formula


_I32_SAFE_N = 46_000   # sum of squares stays < 2^31 while n <= 46340


def column_counts(column: str):
    """Integer count vectors for the device Gini: (base_counts[5] over
    'ACGT*', ins_counts[INS_SLOTS]) or None when the column is empty, has
    more than INS_SLOTS distinct insertion sequences, or is deep enough
    that int32 square sums could overflow (those fall back to the exact
    host formula)."""
    bases, inss = _parse_column(column)
    n = sum(bases.values())
    if not n or n > _I32_SAFE_N or len(inss) > INS_SLOTS:
        return None
    b = np.array([bases[c] for c in "ACGT*"], np.int32)
    iv = np.zeros(INS_SLOTS, np.int32)
    for k, v in enumerate(inss.values()):
        iv[k] = v
    return b, iv


def gini_moments_device(base_counts: np.ndarray, ins_counts: np.ndarray,
                        mesh=None) -> Tuple[np.ndarray, ...]:
    """Vectorized per-column Gini moments on device (the device analog
    of the reference's per-column mp.Pool, src/purity.py:190-191).

    Integer moments keep the device math exact: returns
    (n, sumsq_base, not_ins, sumsq_ins) int32 vectors; the final f64
    divisions happen on host (one division per score instead of the host
    path's per-term divisions, so values agree with compute_purity to
    within 1 ulp). Shardable over a 1-D data mesh (columns are
    independent)."""
    import jax
    import jax.numpy as jnp

    def moments(b, iv):
        n = jnp.sum(b, axis=1)
        ssb = jnp.sum(b * b, axis=1)
        not_ins = n - jnp.sum(iv, axis=1)
        ssi = jnp.sum(iv * iv, axis=1)
        return n, ssb, not_ins, ssi

    if mesh is not None:
        from jax.sharding import PartitionSpec as P
        moments = jax.shard_map(moments, mesh=mesh,
                                in_specs=(P("data"), P("data")),
                                out_specs=(P("data"),) * 4)
    fn = jax.jit(moments)
    n, ssb, ni, ssi = fn(jnp.asarray(base_counts), jnp.asarray(ins_counts))
    return (np.asarray(n), np.asarray(ssb), np.asarray(ni),
            np.asarray(ssi))


def purity_from_moments(n, ssb, not_ins, ssi) -> np.ndarray:
    nf = n.astype(np.float64)
    base = ssb.astype(np.float64) / (nf * nf)
    ins = (not_ins.astype(np.float64) ** 2 + ssi.astype(np.float64)) \
        / (nf * nf)
    return np.stack([base, ins], axis=1)


CHUNK = 100_000          # pileup chunk width: bounds per-worker memory

_purity_bams = {}


def _chunk_bam(bam_path: str):
    """Per-process BAM handle cache, keyed by PID: forked children must
    never reuse a parent's handle (the underlying fd offset is shared
    across fork)."""
    key = (os.getpid(), bam_path)
    bam = _purity_bams.get(key)
    if bam is None:
        _purity_bams.clear()
        bam = open_alignment_file(bam_path, prep=False)
        _purity_bams[key] = bam
    return bam


def _purity_chunk(job):
    """Pool worker: purity scores of one (bam, contig, beg, end) chunk.
    Bounded memory: only one chunk's columns are ever materialized
    (reference fans chunks over mp.Pool the same way, src/purity.py:182-191)."""
    bam_path, ctg, b, e, min_bq = job
    bam = _chunk_bam(bam_path)
    out = []
    for pos, col in pileup_columns(bam, ctg, b, e, min_bq=min_bq):
        s = compute_purity(col)
        if s is not None:
            out.append(s)
    return out


def _counts_chunk(job):
    """Pool worker for the device path: per-column integer counts, with
    host scores inline for columns the fixed-width layout can't hold."""
    bam_path, ctg, b, e, min_bq = job
    bam = _chunk_bam(bam_path)
    out = []
    for pos, col in pileup_columns(bam, ctg, b, e, min_bq=min_bq):
        c = column_counts(col)
        if c is not None:
            out.append(c)
        else:
            s = compute_purity(col)
            if s is not None:
                out.append(s)           # (float, float) host fallback
    return out


def bam_purity(bam_path: str, contig: Optional[str], beg: Optional[int],
               end: Optional[int], min_bq: int,
               processes: int = 0, device: bool = False,
               mesh=None) -> np.ndarray:
    bam = open_alignment_file(bam_path, prep=False)
    contigs = [contig] if contig else bam.references
    lengths = dict(zip(bam.references, bam.lengths))
    jobs = []
    for ctg in contigs:
        b = beg if beg is not None else 0
        e = end if end is not None else lengths.get(ctg, 1 << 40)
        e = min(e, lengths.get(ctg, e))
        for lo in range(b, e, CHUNK):
            jobs.append((bam_path, ctg, lo, min(lo + CHUNK, e), min_bq))
    if processes == 0:
        processes = min(os.cpu_count() or 1, len(jobs) or 1)
    worker = _counts_chunk if device else _purity_chunk
    entries: List = []
    if processes > 1 and len(jobs) > 1:
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        with ctx.Pool(processes) as pool:
            for part in pool.imap(worker, jobs):
                entries.extend(part)
    else:
        for job in jobs:
            entries.extend(worker(job))
    if not device:
        return np.asarray(entries, dtype=np.float64).reshape(-1, 2)

    # device path: batch all parsed columns through one jitted Gini op,
    # splicing host-fallback scores back at their column positions
    idx = [i for i, e in enumerate(entries) if isinstance(e[0], np.ndarray)]
    scores = np.empty((len(entries), 2), np.float64)
    for i, e in enumerate(entries):
        if not isinstance(e[0], np.ndarray):
            scores[i] = e
    if idx:
        nb = len(idx)
        # pad the batch so compiled-shape count stays small (and so a
        # mesh shard divides evenly); pad columns have n=1 and are cut
        npad = -nb % (mesh.size if mesh is not None else 256)
        bmat = np.ones((nb + npad, 5), np.int32)
        imat = np.zeros((nb + npad, INS_SLOTS), np.int32)
        for k, i in enumerate(idx):
            bmat[k] = entries[i][0]
            imat[k] = entries[i][1]
        n, ssb, ni, ssi = gini_moments_device(bmat, imat, mesh=mesh)
        dev = purity_from_moments(n[:nb], ssb[:nb], ni[:nb], ssi[:nb])
        scores[idx] = dev
    return scores


def _bin_counts(scores_list) -> np.ndarray:
    """Pooled per-percent histogram (reference binning quirk: index
    int(x*100 - 1e-5) so purity 1.0 lands in the top bin,
    src/purity.py:101-111)."""
    counts = np.zeros(100, dtype=np.int64)
    for xs in scores_list:
        idx = (np.asarray(xs) * 100 - 0.00001).astype(int)
        np.add.at(counts, np.clip(idx, 0, 99), 1)
    return counts


def plot_purity(all_scores, names, out_prefix) -> None:
    """Histogram + hap-pair ratio plots (reference: src/purity.py:88-152).

    Top row: per-BAM step histograms of base / insertion purity (log y).
    Bottom row (when >=4 BAMs, i.e. two hap pairs as the reference
    hardcodes): per-bin count ratio of the second pair (realigned) over
    the first (original) — the reference's
    clair3-npore-hap / clair3-hap ratio bars."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ratios = len(all_scores) >= 4
    fig, axs = plt.subplots(2 if ratios else 1, 2,
                            figsize=(20, 8) if ratios else (14, 5),
                            squeeze=False)
    bins = np.linspace(0, 1, 100)
    colors = ["r", "y", "g", "b"] + [None] * max(0, len(all_scores) - 4)
    for scores, name, color in zip(all_scores, names, colors):
        if not len(scores):
            continue
        for col in (0, 1):
            axs[0][col].hist(scores[:, col], bins=bins, linewidth=3,
                             histtype="step", color=color, alpha=0.8,
                             label=name)
    axs[0][0].set_title("Pileup Gini Purity Histogram")
    axs[0][1].set_title("Insertion Gini Purity Histogram")
    axs[0][0].set_ylabel("Counts")
    for ax in axs[0]:
        ax.set_xticks(np.linspace(0, 1, 11))
        ax.set_xlim(0, 1)
        ax.set_yscale("log")
    axs[0][1].legend()

    if ratios:
        for col in (0, 1):
            old = _bin_counts([s[:, col] for s in all_scores[0:2]])
            new = _bin_counts([s[:, col] for s in all_scores[2:4]])
            ratio = np.where((old > 0) & (new > 0),
                             new / np.maximum(old, 1), 0.0)
            ax = axs[1][col]
            ax.bar(np.linspace(-0.005, 1 - 0.005, 100), ratio, width=0.01)
            ax.axhline(1, color="k", linestyle=":")
            ax.set_xlim(0, 1)
            ax.set_title(f"Ratio: {names[2]}+{names[3]} / "
                         f"{names[0]}+{names[1]}")
        axs[1][0].set_ylabel("Ratio")

    fig.tight_layout()
    fig.savefig(f"{out_prefix}_purity.png", dpi=120)
    plt.close(fig)


def main(argv=None) -> int:
    from ..config import apply_platform_env
    apply_platform_env()
    args = argparser().parse_args(argv)
    bams = args.bams.split(",")
    names = (args.names.split(",") if args.names
             else [os.path.basename(b) for b in bams])

    all_scores = []
    for bam_path, name in zip(bams, names):
        cache = f"{args.out_prefix}_{name}.npy"
        if args.plot_only and os.path.exists(cache):
            scores = np.load(cache)
        else:
            t0 = perf_counter()
            scores = bam_purity(bam_path, args.contig, args.contig_beg,
                                args.contig_end, args.min_bq,
                                device=args.device_gini)
            np.save(cache, scores)
            print(f"    {name}: {len(scores)} columns, mean base purity "
                  f"{scores[:, 0].mean():.4f}, mean ins purity "
                  f"{scores[:, 1].mean():.4f}; "
                  f"runtime {perf_counter()-t0:.2f}s")
        all_scores.append(scores)

    if args.plot or args.plot_only:
        plot_purity(all_scores, names, args.out_prefix)
        print(f"    wrote {args.out_prefix}_purity.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
