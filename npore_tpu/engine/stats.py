"""Confusion-matrix training: measure the basecaller SUB/INDEL/n-polymer-CNV
error profile from a BAM (reference: src/bam.pyx:351-510).

The reference shells out to `samtools mpileup` and token-parses column
strings; here the pileup comes from io/pileup.py and the classification
logic is identical: at each pileup column that starts an n-polymer, a
deletion of d = k*n <= l*n units records nps[n, l, l-k]; an insertion whose
bases equal k copies of the upcoming n-mer records nps[n, l, min(max_l,
l+k)]; confirmations record the diagonal; non-CNV indels feed the plain
ins/del length histograms.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from ..config import RealignConfig
from ..constants import NBASES, BASE_TO_INT, bases_to_int
from ..io.pileup import pileup_columns
from ..ops.npinfo_host import get_np_info_vec
from .regions import Region, get_ranges

L, L_IDX = 0, 1


def calc_confusion_matrices_range(bam, ref_str: str, contig: str, start: int,
                                  end: int, max_n: int = 6, max_l: int = 100,
                                  min_bq: int = 13
                                  ) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray, np.ndarray]:
    """Accumulate counts over [start, end) of one contig.

    ref_str is the whole contig string (reference keeps cfg.args.refs[ctg];
    src/bam.pyx:381-386).
    """
    subs = np.zeros((NBASES, NBASES), dtype=np.int64)
    nps = np.zeros((max_n, max_l + 1, max_l + 1), dtype=np.int64)
    inss = np.zeros(max_l + 1, dtype=np.int64)
    dels = np.zeros(max_l + 1, dtype=np.int64)

    # +1 lookahead column; pad a zero row at the contig end so the
    # pos+1 probes below stay in bounds (the reference compiles with
    # boundscheck(False) and silently reads past the slice there;
    # src/bam.pyx:381-386)
    np_info = get_np_info_vec(
        bases_to_int(ref_str[start:end + 1]), max_n, max_l)
    if len(np_info) < end - start + 1:
        np_info = np.concatenate(
            [np_info, np.zeros((1, 2, max_n), np_info.dtype)])
    ref_ints = bases_to_int(ref_str[start:end])

    for abs_pos, reads in pileup_columns(bam, contig, start, end, min_bq):
        pos = abs_pos - start
        reads = reads.upper()
        ref_base = ref_ints[pos]
        was_del = was_ins = True

        i = 0
        nread = len(reads)
        while i < nread:
            c = reads[i]
            if c == "^":        # read start marker + mapq char
                i += 2
            elif c == "$" or c == "*":   # read end / deletion placeholder
                i += 1
            elif c in "NACGT":  # base call (substitution or match)
                subs[ref_base, BASE_TO_INT[c]] += 1
                i += 1
                # record absence of indels after the previous base
                # (src/bam.pyx:405-417)
                if not was_ins:
                    inss[0] += 1
                if not was_del:
                    dels[0] += 1
                if not was_ins and not was_del:
                    for n in range(1, max_n + 1):
                        l = np_info[pos + 1, L, n - 1]
                        lidx = np_info[pos + 1, L_IDX, n - 1]
                        if l != 0 and lidx == 0:
                            nps[n - 1, l, l] += 1
                was_ins = was_del = False
            elif c == "-":      # deletion follows (src/bam.pyx:419-449)
                was_del = True
                indel = 0
                i += 1
                while reads[i].isdigit():
                    indel = indel * 10 + int(reads[i])
                    i += 1
                cnv = False
                for n in range(1, max_n + 1):
                    l = np_info[pos + 1, L, n - 1]
                    lidx = np_info[pos + 1, L_IDX, n - 1]
                    if l != 0 and lidx == 0 and indel % n == 0 \
                            and indel <= l * n:
                        cnv = True
                        nps[n - 1, l, l - indel // n] += 1
                    elif l != 0 and lidx == 0:
                        nps[n - 1, l, l] += 1
                if not cnv:
                    dels[min(max_l, indel)] += 1
                i += indel
            elif c == "+":      # insertion follows (src/bam.pyx:451-483)
                was_ins = True
                indel = 0
                i += 1
                while reads[i].isdigit():
                    indel = indel * 10 + int(reads[i])
                    i += 1
                cnv = False
                for n in range(1, max_n + 1):
                    l = np_info[pos + 1, L, n - 1]
                    lidx = np_info[pos + 1, L_IDX, n - 1]
                    if l != 0 and lidx == 0 and indel % n == 0 \
                            and (ref_str[start + pos + 1:start + pos + n + 1]
                                 * (indel // n) == reads[i:i + indel]):
                        cnv = True
                        nps[n - 1, l, min(max_l, l + indel // n)] += 1
                    elif l != 0 and lidx == 0:
                        nps[n - 1, l, l] += 1
                if not cnv:
                    inss[min(max_l, indel)] += 1
                i += indel
            else:
                raise ValueError(f"unexpected pileup character {c!r} at "
                                 f"{contig}:{abs_pos}")

        # last read at this column (src/bam.pyx:490-501)
        if not was_ins:
            inss[0] += 1
        if not was_del:
            dels[0] += 1
        if not was_ins and not was_del:
            for n in range(1, max_n + 1):
                l = np_info[pos + 1, L, n - 1]
                lidx = np_info[pos + 1, L_IDX, n - 1]
                if l != 0 and lidx == 0:
                    nps[n - 1, l, l] += 1

    return subs, nps, inss, dels


def _zero_counts(max_n: int, max_l: int):
    return (np.zeros((NBASES, NBASES), np.int64),
            np.zeros((max_n, max_l + 1, max_l + 1), np.int64),
            np.zeros(max_l + 1, np.int64), np.zeros(max_l + 1, np.int64))


_worker_state = {}


def _range_worker(job):
    """Process-pool worker: counts for one chunk range. Opens its own BAM
    handle / FASTA per process (the reference forks a pool the same way,
    src/bam.pyx:166-203 via src/realign.py pools)."""
    (bam_path, ref_path, contig, start, end, max_n, max_l, min_bq) = job
    # keyed by PID: forked children must never reuse a parent's handle
    # (the underlying fd offset is shared across fork)
    key = (os.getpid(), bam_path, ref_path)
    st = _worker_state.get(key)
    if st is None:
        _worker_state.clear()
        from ..io.bam import open_alignment_file
        from ..io.fasta import FastaFile
        st = (open_alignment_file(bam_path, prep=False), FastaFile(ref_path),
              {})
        _worker_state[key] = st
    bam, fa, refs = st
    if contig not in refs:
        refs.clear()                      # one contig string at a time
        refs[contig] = fa.fetch(contig)
    return calc_confusion_matrices_range(
        bam, refs[contig], contig, start, end, max_n, max_l, min_bq)


def calc_confusion_matrices_bam(bam_path: str, ref_fa, regions: List[Region],
                                cfg: RealignConfig, processes: int = 0
                                ) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray, np.ndarray]:
    """Sum counts over chunk_width ranges (reference: src/bam.pyx:166-203).

    Chunks are independent: they fan out over a process pool on one host
    (``processes=0`` -> cpu count; 1 -> serial), and under multi-host
    meshes each host sums its region shard and the partial counts are
    psum-reduced over the mesh (parallel/mesh.reduce_confusion_matrices),
    the device-mesh form of the reference's np.sum over pool results
    (src/bam.pyx:183-192)."""
    max_n, max_l = cfg.align.max_n, cfg.align.max_l
    ranges = list(get_ranges(regions, cfg.chunk_width))
    if not ranges:
        return _zero_counts(max_n, max_l)
    ref_path = getattr(ref_fa, "path", None)
    if processes == 0:
        processes = min(os.cpu_count() or 1, len(ranges))
    jobs = [(bam_path, ref_path, c, s, e, max_n, max_l, cfg.min_bq)
            for c, s, e in ranges]
    acc = list(_zero_counts(max_n, max_l))
    if processes > 1 and ref_path:
        import multiprocessing as mp
        # spawn, not fork: callers (CLIs, harnesses) usually have JAX
        # initialized, and forking a multithreaded JAX process can deadlock
        ctx = mp.get_context("spawn")
        with ctx.Pool(processes) as pool:
            for parts in pool.imap_unordered(_range_worker, jobs):
                for a, p in zip(acc, parts):
                    a += p
    else:
        for job in jobs:
            for a, p in zip(acc, _range_worker(job)):
                a += p
    return tuple(acc)
