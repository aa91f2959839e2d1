"""Read realignment CLI (reference: src/realign.py).

Usage: python -m npore_tpu.cli.realign --bam in.bam --ref ref.fasta \
           --out_prefix out [--stats_dir ./stats] [...]
"""
from __future__ import annotations

import argparse
import os
import sys
from time import perf_counter

import numpy as np

from ..config import AlignConfig, RealignConfig
from ..engine.realigner import ENGINES, Realigner
from ..engine.regions import get_bam_regions
from ..io.bam import open_alignment_file
from ..io.fasta import FastaFile
from ..io.sam import make_header
from ..model.scores import (calc_score_matrices, load_confusion_matrices,
                            save_confusion_matrices)
from .. import __version__


def argparser() -> argparse.ArgumentParser:
    """Flags mirror the reference (src/realign.py:15-71)."""
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--bam", required=True, help="Input BAM to be realigned.")
    p.add_argument("--ref", required=True, help="Input reference FASTA.")
    p.add_argument("--out_prefix", required=True, help="Output SAM file prefix.")
    p.add_argument("--contig", type=str)
    p.add_argument("--contig_beg", type=int)
    p.add_argument("--contig_end", type=int)
    p.add_argument("--contigs", type=str)
    p.add_argument("--max_reads", type=int, default=0)
    p.add_argument("--bed", type=str)
    p.add_argument("--max_n", type=int, default=6)
    p.add_argument("--max_l", type=int, default=100)
    p.add_argument("--chunk_width", type=int, default=100000)
    p.add_argument("--stats_dir", default="./stats")
    p.add_argument("--plot", action="store_true")
    p.add_argument("--recalc_cms", action="store_true")
    p.add_argument("--recalc_exit", action="store_true")
    p.add_argument("--engine", default="auto", choices=list(ENGINES),
                   help="DP engine (new; no reference equivalent): auto "
                        "picks cuda on a GPU and xla on the CPU; golden is "
                        "the numpy spec.")
    p.add_argument("--batch_reads", type=int, default=512)
    p.add_argument("--profile_dir", type=str, default=None,
                   help="Write a jax.profiler trace of the realignment "
                        "stage to this directory (new; view with "
                        "TensorBoard or Perfetto).")
    p.add_argument("--num_hosts", type=int, default=1,
                   help="Multi-host SPMD: total participating hosts "
                        "(new; every host runs this CLI with the same "
                        "args plus its --host_id).")
    p.add_argument("--host_id", type=int, default=None,
                   help="This host's index in [0, num_hosts).")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of the jax.distributed coordinator "
                        "(host 0).")
    return p


def config_from_args(args) -> RealignConfig:
    return RealignConfig(
        bam=args.bam, ref=args.ref, out_prefix=args.out_prefix,
        stats_dir=args.stats_dir, contig=args.contig,
        contig_beg=args.contig_beg, contig_end=args.contig_end,
        contigs=args.contigs, bed=args.bed, max_reads=args.max_reads,
        chunk_width=args.chunk_width, recalc_cms=args.recalc_cms,
        recalc_exit=args.recalc_exit, plot=args.plot,
        align=AlignConfig(max_n=args.max_n, max_l=args.max_l),
        batch_reads=args.batch_reads, engine=args.engine)


def get_read_data(bam, regions, max_reads: int = 0):
    """Stream primary mapped reads in the selected regions
    (reference: src/bam.pyx:18-47)."""
    kept = 0
    for ctg, start, stop in regions:
        for read in bam.fetch(ctg, start, stop):
            if max_reads and kept >= max_reads:
                return
            if (not read.is_secondary and not read.is_supplementary
                    and not read.is_unmapped):
                kept += 1
                yield read


def main(argv=None) -> int:
    from ..config import apply_platform_env
    apply_platform_env()
    args = argparser().parse_args(argv)
    cfg = config_from_args(args)

    from ..parallel.distributed import (barrier, host_out_path,
                                        init_distributed, merge_host_sams,
                                        shard_regions)
    host_id, num_hosts = init_distributed(args.coordinator, args.num_hosts,
                                          args.host_id)

    print("> selecting BAM regions")
    ref_fa = FastaFile(cfg.ref)
    bam = open_alignment_file(cfg.bam)
    regions = get_bam_regions(cfg, ref_fa, bam)
    stripe = False
    if num_hosts > 1:
        if len(regions) >= num_hosts:
            regions = shard_regions(regions, num_hosts, host_id)
            print(f"    host {host_id}/{num_hosts}: {len(regions)} region "
                  f"shards")
        else:
            # fewer regions than hosts: fall back to read-level striping
            # (all hosts stream all regions, keep every num_hosts-th read)
            stripe = True
            print(f"    host {host_id}/{num_hosts}: read-stripe mode "
                  f"({len(regions)} regions < {num_hosts} hosts)")

    # auto-recalculate stats when any matrix is missing (src/realign.py:124-128)
    have_all = all(os.path.isfile(os.path.join(cfg.stats_dir, f"{n}_cm.npy"))
                   for n in ("subs", "nps", "inss", "dels"))
    recalc = cfg.recalc_cms or not have_all

    if recalc:
        print("> calculating confusion matrices")
        from ..engine.stats import calc_confusion_matrices_bam
        # stats must shard by REGION even in read-stripe mode: each count
        # contributes once globally or the allreduce multiplies every
        # count by num_hosts, which shifts the eps-smoothed score
        # matrices (model/scores.py) vs a single-host run
        stat_regions = (shard_regions(regions, num_hosts, host_id)
                        if stripe else regions)
        subs, nps, inss, dels = calc_confusion_matrices_bam(
            bam_path=cfg.bam, ref_fa=ref_fa, regions=stat_regions, cfg=cfg)
        if num_hosts > 1:      # all-reduce each host's region-shard counts
            from ..parallel.distributed import allreduce_counts
            subs, nps, inss, dels = allreduce_counts([subs, nps, inss, dels])
        if host_id == 0:
            save_confusion_matrices(cfg.stats_dir, subs, nps, inss, dels)
        if cfg.recalc_exit:
            return 0
    else:
        print("> loading confusion matrices")
        subs, nps, inss, dels = load_confusion_matrices(cfg.stats_dir)

    print("> calculating score matrices")
    sub_scores, np_scores, _, _ = calc_score_matrices(
        subs, nps, inss, dels, cfg.align.max_n, cfg.align.max_l)

    if cfg.plot:
        from ..model.plots import plot_confusion_matrices, plot_np_score_matrices
        print("> plotting confusion and score matrices")
        plot_confusion_matrices(subs, nps, inss, dels, cfg.stats_dir,
                                cfg.align.max_n)
        plot_np_score_matrices(np_scores, cfg.stats_dir, cfg.align.max_n)
        return 0

    print("> creating output SAM")
    header = make_header(bam.references, bam.lengths, __version__)
    out_path = host_out_path(cfg.out_prefix, host_id, num_hosts)
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)

    print("> computing batched read realignments")
    start = perf_counter()
    prof = None
    if args.profile_dir:
        import jax
        jax.profiler.start_trace(args.profile_dir)
        prof = args.profile_dir
    realigner = Realigner(sub_scores, np_scores, cfg.align, engine=cfg.engine)
    reads = get_read_data(bam, regions, cfg.max_reads)
    if stripe:
        from ..parallel.distributed import stripe_reads
        reads = stripe_reads(reads, num_hosts, host_id)
    n = 0
    with open(out_path, "w") as fh:
        for line in header:
            fh.write(line + "\n")
        for rec in realigner.realign_records(reads, cfg.batch_reads):
            fh.write(rec.to_line() + "\n")
            n += 1
            if n % 1000 == 0:
                print(f"\r    {n} reads realigned "
                      f"({n/(perf_counter()-start):.0f} reads/s)",
                      end="", flush=True)
    if prof:
        import jax
        jax.profiler.stop_trace()
        print(f"    profiler trace written to {prof}")
    for e in realigner.errors:
        print(f"WARNING: {e}")
    for s in realigner.skipped:
        print(f"WARNING: {s}")
    if realigner.skipped:
        print(f"    {len(realigner.skipped)} reads skipped (malformed)")
    if realigner.engine != "golden":
        print(f"    {realigner.bail_count} alignments used the golden "
              f"fallback")
    print(f"\r    {n} reads realigned; runtime: {perf_counter()-start:.2f}s")
    if num_hosts > 1:
        barrier("realign-sam")
        if host_id == 0:
            merged = merge_host_sams(cfg.out_prefix, num_hosts)
            print(f"    merged {num_hosts} host shards into {merged}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
