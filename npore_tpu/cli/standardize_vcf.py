"""VCF standardization CLI (reference: src/standardize_vcf.py).

Normalizes a (phased, diploid) truth VCF by splitting it into haploid
variant sets, synthesizing each haplotype's whole-contig sequence,
re-aligning those sequences with the same batched device engine the
read realigner uses (the reference fans out over mp.Pool(10);
src/standardize_vcf.py:30-31), and converting the realigned CIGARs back
into a merged diploid VCF.

Usage: python -m npore_tpu.cli.standardize_vcf --vcf in.vcf --ref ref.fasta \
           --out_prefix out [--stats_dir ./stats] [...]
"""
from __future__ import annotations

import argparse
import os
import sys
from time import perf_counter

import numpy as np

from ..config import AlignConfig
from ..constants import bases_to_int
from ..engine.realigner import ENGINES, AlignItem, Realigner
from ..io.cigar import normalize_cigar
from ..io.fasta import FastaFile
from ..io.vcf import VcfReader, apply_vcf, gen_vcf, merge_vcfs, split_vcf
from ..model.scores import calc_score_matrices, load_confusion_matrices


def argparser() -> argparse.ArgumentParser:
    """Flags mirror the reference (src/standardize_vcf.py:46-84)."""
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--vcf", required=True, help="Input VCF to standardize.")
    p.add_argument("--ref", required=True,
                   help="Input reference FASTA corresponding to VCF.")
    p.add_argument("--out_prefix", required=True, help="Output VCF prefix.")
    p.add_argument("--contig", type=str)
    p.add_argument("--contig_beg", type=int)
    p.add_argument("--contig_end", type=int)
    p.add_argument("--contigs", type=str)
    p.add_argument("--stats_dir", default="./stats")
    p.add_argument("--max_n", type=int, default=6)
    p.add_argument("--max_l", type=int, default=100)
    p.add_argument("--chunk_width", type=int, default=100000)
    p.add_argument("--min_qual", type=int, default=0)
    p.add_argument("--engine", default="auto",
                   choices=list(ENGINES))
    return p


def get_vcf_regions(args, ref: FastaFile, vcf: VcfReader):
    """Region resolution (reference: src/util.py:97-154)."""
    if args.contig:
        if args.contigs:
            sys.exit("ERROR: can't set 'contig' and 'contigs'.")
        beg = args.contig_beg or 0
        end = args.contig_end or ref.get_reference_length(args.contig) - 1
        return [(args.contig, beg, end)]
    if args.contigs:
        if args.contig_beg or args.contig_end:
            sys.exit("ERROR: can't set start/endpoints with multiple contigs.")
        return [(c, 0, ref.get_reference_length(c) - 1)
                for c in args.contigs.split(",")]
    if args.contig_beg or args.contig_end:
        sys.exit("ERROR: 'contig' not supplied, but start/endpoints set.")
    regions = []
    contigs = vcf.contigs or sorted({r.contig for r in vcf})
    for ctg in contigs:
        if ctg not in ref:
            print(f"WARNING: contig '{ctg}' present in '{args.vcf}', but "
                  f"not '{args.ref}', skipping...")
            continue
        l = ref.get_reference_length(ctg)
        if any(True for _ in vcf.fetch(ctg, 0, l - 1)):
            regions.append((ctg, 0, l - 1))
    return regions


def realign_haps(hap_data, realigner: Realigner, timing: bool = False):
    """Batched replacement of the reference's per-hap worker
    (reference: src/bam.pyx:93-123): align -> left-normalize to fixpoint
    -> 'ID' -> 'M'. With ``timing`` (NPORE_TIMING=1), prints the
    window-build/submit vs device-wait vs normalize split."""
    items = []
    for contig, hap, seq, ref, cigar in hap_data:
        items.append(AlignItem(bases_to_int(ref), bases_to_int(seq), cigar))
    t0 = perf_counter()
    eng = realigner._device
    if eng is not None:
        collect = eng.align_batch_async(items)   # window build + submit
        t1 = perf_counter()
        new_cigars = collect()                   # device wait + decode
    else:
        t1 = perf_counter()
        new_cigars = realigner.align_batch(items)
    t2 = perf_counter()
    out = []
    for (contig, hap, seq, ref, _), it, cig in zip(hap_data, items,
                                                   new_cigars):
        norm = normalize_cigar(cig, it.ref, it.seq)
        out.append((contig, hap, seq, ref, norm))
    if timing:
        print(f"    [timing] window-build+submit {t1 - t0:.2f}s  "
              f"device-wait+decode {t2 - t1:.2f}s  "
              f"normalize {perf_counter() - t2:.2f}s", flush=True)
    return out


def main(argv=None) -> int:
    from ..config import apply_platform_env
    apply_platform_env()
    args = argparser().parse_args(argv)
    cfg = AlignConfig(max_n=args.max_n, max_l=args.max_l)

    print("> selecting vcf regions")
    ref_fa = FastaFile(args.ref)
    vcf = VcfReader(args.vcf)
    regions = get_vcf_regions(args, ref_fa, vcf)

    print("> calculating score matrices")
    subs, nps, inss, dels = load_confusion_matrices(args.stats_dir)
    sub_scores, np_scores, _, _ = calc_score_matrices(
        subs, nps, inss, dels, cfg.max_n, cfg.max_l)

    # NPORE_TIMING=1 prints the per-stage wall-clock split (VERDICT r4
    # #4: the genome-scale standardize run was slow and unattributed)
    timing = os.environ.get("NPORE_TIMING") == "1"
    marks = [("start", perf_counter())]

    print("> splitting vcf")
    vcf1, vcf2 = split_vcf(args.vcf, regions, args.out_prefix + "pre")
    marks.append(("split_vcf", perf_counter()))

    print("> converting vcfs and ref to sequences")
    get_ref = lambda ctg: ref_fa.fetch(ctg).upper()
    hap1_data = apply_vcf(vcf1, 1, regions, get_ref, args.min_qual)
    hap2_data = apply_vcf(vcf2, 2, regions, get_ref, args.min_qual)
    marks.append(("apply_vcf", perf_counter()))

    print("> realigning hap sequences")
    start = perf_counter()
    realigner = Realigner(sub_scores, np_scores, cfg, engine=args.engine)
    marks.append(("engine_init", perf_counter()))
    data = realign_haps(hap1_data + hap2_data, realigner, timing=timing)
    hap1_data = [x for x in data if x[1] == 1]
    hap2_data = [x for x in data if x[1] == 2]
    print(f"    {len(data)} sequences realigned; "
          f"runtime: {perf_counter()-start:.2f}s")
    marks.append(("realign", perf_counter()))

    print("> generating standardized vcfs")
    vcf1 = gen_vcf(hap1_data, 1, args.out_prefix)
    vcf2 = gen_vcf(hap2_data, 2, args.out_prefix)
    marks.append(("gen_vcf", perf_counter()))

    print("> merging vcfs")
    out_fn = f"{args.out_prefix}.vcf.gz"
    merge_vcfs(vcf1, vcf2, out_fn, regions)
    print(f"    wrote {out_fn} (+ .tbi)")
    marks.append(("merge", perf_counter()))
    if timing:
        split = "  ".join(f"{name} {t1 - t0:.2f}s" for (_, t0), (name, t1)
                          in zip(marks, marks[1:]))
        print(f"    [timing] {split}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
