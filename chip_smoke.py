#!/usr/bin/env python3
"""Smoke test of the realignment engine on an NVIDIA GPU.

    python chip_smoke.py           # phases 1-7 on one GPU
    python chip_smoke.py --four    # phase 8 only: four GPUs against one

Phases (one process, one compile cache):
  1 device      JAX must find a GPU; prints the card's name and power limit.
  2 compile     the CUDA engine's device step at every r_pad bucket at its
                production group size: compile seconds, memory_analysis().
  3 parity      the CUDA kernel and the plain-JAX twin on identical packed
                groups at every bucket: slots and bail flags bit-identical;
                then seeded repeat-rich fuzz cases against the C++ golden.
  4 fixture     the realign CLI on tests/data: 10/10 records equal to
                tests/data/npore_realigned.sam (QNAME/FLAG/POS/CIGAR/SEQ).
  5 long reads  a seeded ONT-like set (4 Mbp contig, 128 reads of 5-30 kb)
                through the realign CLI with the kernel and with the twin:
                every CIGAR equal; 16 reads equal to the C++ golden; no
                golden fallback.
  6 standardize the standardize_vcf CLI on tests/data, records equal to
                --engine golden.
  7 timing      kernel and twin step times per bucket (min/median of 5
                after warm-up, compile apart), then end to end through
                Realigner.align_batch.
  8 four GPUs   (--four) phase 5's set over four GPUs, round-robin and as a
                shard_mapped mesh, each equal to the one-GPU run.

Any failed check raises, so the script exits non-zero. Each line is tagged
with the card; the last line is the device JSON. Long outputs go to
chiprun_out/smoke/.
"""
from __future__ import annotations

import argparse
import contextlib
import gzip
import io
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CARD = "?"


def log(msg: str) -> None:
    print(f"[{CARD}] {msg}", flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_name() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def stats(ts):
    import numpy as np
    return float(np.min(ts)), float(np.median(ts))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def repeat_ref(rng, n: int) -> str:
    """Random sequence with injected n-polymer runs (scripts/fuzz_parity)."""
    parts, size = [], 0
    while size < n:
        if rng.random() < 0.5:
            k = int(rng.integers(5, 40))
            p = "".join("ACGT"[i] for i in rng.integers(0, 4, k))
        else:
            period = int(rng.integers(1, 7))
            unit = "".join("ACGT"[i] for i in rng.integers(0, 4, period))
            p = unit * int(rng.integers(3, 30))
        parts.append(p)
        size += len(p)
    return "".join(parts)[:n]


def bucket_windows(rng, r_pad: int, n: int, cfg):
    """``n`` distinct windows of the r_pad bucket, from ONT-like reads of a
    repeat-rich reference."""
    from generate_data import make_read
    from npore_tpu.constants import bases_to_int
    from npore_tpu.engine.device_engine import _r_pad_for
    from npore_tpu.engine.windows import build_windows

    lo, hi = (int(r_pad / 4.6), int(r_pad / 2.4)) if r_pad < 20000 \
        else (11000, 14000)
    ref = repeat_ref(rng, 4 * hi + 1000)
    wins = []
    while len(wins) < n:
        pos, seq, cig = make_read(rng, ref, min_len=lo, max_len=hi)
        span = sum(c in "=XD" for c in cig)
        ws = build_windows(bases_to_int(ref[pos:pos + span]),
                           bases_to_int(seq), cig, cfg, aln_idx=len(wins))
        wins += [w for w in ws
                 if _r_pad_for(w.b_rows + 1, cfg.max_b_rows) == r_pad]
    return wins[:n]


def long_read_set(out_dir: str, seed: int):
    """Seeded ONT-like set: 4 Mbp contig, 128 reads of 5-30 kb, written as
    ref.fasta + reads.bam. Returns (paths, truth) with truth[qname] =
    (ref slice, seq, generating extended CIGAR)."""
    import numpy as np
    from generate_data import make_read, make_ref, md_tag
    from npore_tpu.io.bam_writer import write_bam
    from npore_tpu.io.cigar import collapse_cigar
    from npore_tpu.io.sam import SamRecord

    rng = np.random.default_rng(seed)
    ref = make_ref(rng, 4_000_000)
    os.makedirs(out_dir, exist_ok=True)
    fa = os.path.join(out_dir, "ref.fasta")
    with open(fa, "w") as fh:
        fh.write(">ctg\n")
        for i in range(0, len(ref), 80):
            fh.write(ref[i:i + 80] + "\n")
    recs, truth = [], {}
    for i in range(128):
        pos, seq, cig = make_read(rng, ref, min_len=5000, max_len=30000)
        span = sum(c in "=XD" for c in cig)
        name = f"ont{i}"
        truth[name] = (ref[pos:pos + span], seq, cig)
        recs.append(SamRecord(
            qname=name, flag=0, rname="ctg", pos=pos, mapq=60,
            cigar=collapse_cigar(cig), seq=seq, qual="I" * len(seq),
            tags={"HP": ("i", int(rng.integers(0, 3))),
                  "MD": ("Z", md_tag(ref, pos, cig))}))
    recs.sort(key=lambda r: r.pos)
    bam = os.path.join(out_dir, "reads.bam")
    write_bam(bam, ["ctg"], [len(ref)], recs)
    return fa, bam, truth


def sam_records(path: str):
    """qname -> (QNAME, FLAG, POS, CIGAR, SEQ)."""
    out = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("@"):
                continue
            f = line.rstrip("\n").split("\t")
            out[f[0]] = (f[0], f[1], f[3], f[5], f[9])
    return out


def run_cli(mod, argv):
    """Run a CLI main() in this process; returns (rc, stdout text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue()


def fallbacks(text: str) -> int:
    for line in text.splitlines():
        if "alignments used the golden fallback" in line:
            return int(line.split()[0])
    raise AssertionError("the CLI printed no golden-fallback count")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def timed_compile(eng, r_pad, B):
    """AOT-compile the engine's step, placed as the engine places it (so
    the persistent cache entry is the one its jit calls find)."""
    import jax
    import numpy as np
    from npore_tpu.engine.prepass import group_words
    sh = jax.sharding.SingleDeviceSharding(eng.devices[0])
    t0 = time.perf_counter()
    c = eng.step(r_pad, B).lower(
        jax.ShapeDtypeStruct((B, group_words(r_pad)), np.int32, sharding=sh),
        jax.ShapeDtypeStruct(eng._cont.shape, eng._cont.dtype, sharding=sh),
        jax.ShapeDtypeStruct(eng._sub.shape, eng._sub.dtype, sharding=sh),
    ).compile()
    return c, time.perf_counter() - t0


def mem_line(c) -> str:
    m = c.memory_analysis()
    if m is None:
        return "memory_analysis: none"
    gib = 1 << 30
    return (f"args {m.argument_size_in_bytes / gib:.3f} GiB, out "
            f"{m.output_size_in_bytes / gib:.3f} GiB, temp "
            f"{m.temp_size_in_bytes / gib:.3f} GiB, code "
            f"{m.generated_code_size_in_bytes / 1e6:.2f} MB")


def phase_compile(ctx):
    eng = ctx["cuda"]
    for r_pad in ctx["buckets"]:
        B = eng.group_for(r_pad)
        c, dt = timed_compile(eng, r_pad, B)
        ctx["compiled"][("cuda", r_pad, B)] = c
        log(f"phase 2: cuda step r_pad={r_pad} B={B}: compile {dt:.2f}s; "
            f"{mem_line(c)}")


def phase_parity(ctx):
    import jax
    import numpy as np
    from fuzz_parity import run as fuzz_run
    from npore_tpu.engine.device_engine import pack_group

    cfg = ctx["cfg"]
    rng = np.random.default_rng(ctx["seed"])
    for r_pad in ctx["buckets"]:
        B = ctx["cuda"].group_for(r_pad)
        check(B == ctx["xla"].group_for(r_pad), "group sizes differ")
        n = min(B, 16 if r_pad > 10000 else 32)
        wins = bucket_windows(rng, r_pad, n, cfg)
        group = (wins * (B // n + 1))[:B]
        buf = pack_group(group, r_pad, B)
        ctx["groups"][r_pad] = buf
        outs = {}
        for impl in ("cuda", "xla"):
            eng = ctx[impl]
            if (impl, r_pad, B) in ctx["compiled"]:
                c, dt = ctx["compiled"][(impl, r_pad, B)], 0.0
            else:
                c, dt = timed_compile(eng, r_pad, B)
                ctx["compiled"][(impl, r_pad, B)] = c
            ctx["compile_s"][(impl, r_pad)] = dt
            t0 = time.perf_counter()
            out = jax.block_until_ready(c(buf, eng._cont, eng._sub))
            outs[impl] = [np.asarray(a) for a in out]
            log(f"phase 3: {impl} r_pad={r_pad} B={B}: compile {dt:.2f}s, "
                f"first run {time.perf_counter() - t0:.3f}s")
        (sk, bk), (st, bt) = outs["cuda"], outs["xla"]
        same = [w for w in range(B)
                if np.array_equal(sk[w], st[w]) and bk[w] == bt[w]]
        check(len(same) == B, f"r_pad={r_pad}: kernel and twin differ on "
              f"{B - len(same)} of {B} windows")
        check(not bk.any(), f"r_pad={r_pad}: {int(bk.sum())} bails")
        log(f"phase 3: r_pad={r_pad}: {B}/{B} windows bit-identical "
            f"({n} distinct), 0 bails")
    bad = fuzz_run(ctx["cuda"], ctx["fuzz"], ctx["seed"],
                   log=lambda m: log(f"phase 3: fuzz {m}"))
    check(bad == 0, f"fuzz: {bad} mismatches against the C++ golden")


def phase_fixture(ctx):
    from npore_tpu.cli import realign
    data = os.path.join(REPO, "tests", "data")
    pre = os.path.join(ctx["out"], "fixture")
    rc, text = run_cli(realign, [
        "--bam", os.path.join(data, "reads.bam"),
        "--ref", os.path.join(data, "ref.fasta"), "--out_prefix", pre,
        "--stats_dir", os.path.join(REPO, "guppy5_stats")])
    check(rc == 0, f"realign CLI exit {rc}")
    got = sam_records(pre + ".sam")
    want = sam_records(os.path.join(data, "npore_realigned.sam"))
    same = sum(got.get(k) == v for k, v in want.items())
    check(len(want) == 10 and same == 10 and len(got) == 10,
          f"fixture: {same}/{len(want)} records equal")
    log(f"phase 4: fixture SAM {same}/10 equal to npore_realigned.sam, "
        f"golden fallbacks {fallbacks(text)}")


def phase_long(ctx):
    import numpy as np
    from npore_tpu.cli import realign
    from npore_tpu.constants import bases_to_int
    from npore_tpu.engine.device_engine import _r_pad_for
    from npore_tpu.engine.realigner import AlignItem
    from npore_tpu.engine.windows import build_windows
    from npore_tpu.io.cigar import finalize_cigar
    from npore_tpu.native import golden_align_native

    cfg = ctx["cfg"]
    t0 = time.perf_counter()
    fa, bam, truth = long_read_set(os.path.join(ctx["out"], "long"),
                                   ctx["seed"])
    items = {k: AlignItem(bases_to_int(r), bases_to_int(s), c)
             for k, (r, s, c) in truth.items()}
    ctx["long"] = (fa, bam, truth, items)
    wins = [w for it in items.values()
            for w in build_windows(it.ref, it.seq, it.cigar, cfg)]
    by = {}
    for w in wins:
        rp = _r_pad_for(w.b_rows + 1, cfg.max_b_rows)
        by[rp] = by.get(rp, 0) + 1
    log(f"phase 5: {len(items)} reads, {len(wins)} windows "
        f"(per bucket {dict(sorted(by.items()))}), data in "
        f"{time.perf_counter() - t0:.1f}s")
    sams = {}
    for engine in ("auto", "xla"):
        pre = os.path.join(ctx["out"], f"long_{engine}")
        t0 = time.perf_counter()
        rc, text = run_cli(realign, [
            "--bam", bam, "--ref", fa, "--out_prefix", pre,
            "--stats_dir", os.path.join(REPO, "guppy5_stats"),
            "--engine", engine])
        dt = time.perf_counter() - t0
        check(rc == 0, f"realign CLI ({engine}) exit {rc}")
        nfb = fallbacks(text)
        check(nfb == 0, f"{engine}: {nfb} golden fallbacks")
        sams[engine] = sam_records(pre + ".sam")
        check(len(sams[engine]) == len(items), f"{engine}: record count")
        log(f"phase 5: CLI --engine {engine}: {dt:.2f}s wall incl. compile "
            f"of new shapes, {len(items) / dt:.2f} reads/s, "
            f"{len(wins) / dt:.2f} windows/s, golden fallbacks {nfb}")
    same = sum(sams["auto"][k] == sams["xla"][k] for k in items)
    check(same == len(items), f"kernel vs twin: {same}/{len(items)} equal")
    names = sorted(items)[:16]
    t0 = time.perf_counter()
    for k in names:
        it = items[k]
        g = golden_align_native(it.ref, it.seq, it.cigar, ctx["ss"],
                                ctx["ns"], cfg)
        check(g is not None, "C++ golden engine unavailable")
        fin = finalize_cigar(g, it.ref, it.seq)
        check(fin == sams["auto"][k][3], f"{k}: kernel CIGAR != golden")
    log(f"phase 5: kernel vs twin {same}/{len(items)} CIGARs equal; "
        f"{len(names)}/16 equal to the C++ golden "
        f"({time.perf_counter() - t0:.1f}s)")


def vcf_records(path: str):
    with gzip.open(path, "rt") as fh:
        return [l for l in fh if not l.startswith("#")]


def phase_standardize(ctx):
    from npore_tpu.cli import standardize_vcf
    data = os.path.join(REPO, "tests", "data")
    recs = {}
    for engine in ("auto", "golden"):
        pre = os.path.join(ctx["out"], f"std_{engine}")
        t0 = time.perf_counter()
        rc, _ = run_cli(standardize_vcf, [
            "--vcf", os.path.join(data, "test_std_vcf.vcf"),
            "--ref", os.path.join(data, "test_std_ref.fasta"),
            "--out_prefix", pre,
            "--stats_dir", os.path.join(REPO, "guppy5_stats"),
            "--engine", engine])
        check(rc == 0, f"standardize_vcf ({engine}) exit {rc}")
        recs[engine] = vcf_records(pre + ".vcf.gz")
        log(f"phase 6: standardize --engine {engine}: "
            f"{len(recs[engine])} records, {time.perf_counter() - t0:.2f}s")
    check(recs["auto"] == recs["golden"] and recs["auto"],
          "standardize: records differ from --engine golden")
    log(f"phase 6: {len(recs['auto'])} standardized records identical to "
        f"--engine golden")


def time_call(fn, runs: int):
    import jax
    jax.block_until_ready(fn())            # warm-up
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return stats(ts)


def phase_timing(ctx):
    import jax
    results = ctx["timing"]
    for r_pad in ctx["timed_buckets"]:
        buf = ctx["groups"][r_pad]
        B = buf.shape[0]
        row = {}
        for impl in ("cuda", "xla"):
            eng = ctx[impl]
            c = ctx["compiled"][(impl, r_pad, B)]
            dev = eng.devices[0]
            args = [jax.device_put(a, dev) for a in (buf, eng._cont,
                                                     eng._sub)]
            mn, md = time_call(lambda: c(*args), 5)
            row[impl] = {"min_s": mn, "median_s": md,
                         "us_per_window_min": mn / B * 1e6,
                         "compile_s": ctx["compile_s"][(impl, r_pad)]}
            log(f"phase 7: {impl} step r_pad={r_pad} B={B}: min {mn:.6f}s "
                f"median {md:.6f}s ({mn / B * 1e6:.2f} us/window), compile "
                f"{ctx['compile_s'][(impl, r_pad)]:.2f}s apart")
        log(f"phase 7: r_pad={r_pad}: twin/kernel step time "
            f"{row['xla']['min_s'] / row['cuda']['min_s']:.1f}x")
        results[str(r_pad)] = row

    if "long" not in ctx:
        return
    items = list(ctx["long"][3].values())
    for impl, runs in (("cuda", 5), ("xla", 3)):
        eng = ctx[impl]
        eng.align_batch(items)               # warm-up (new shapes compile)
        ts = []
        for _ in range(runs):
            t0 = time.perf_counter()
            eng.align_batch(items)
            ts.append(time.perf_counter() - t0)
        mn, md = stats(ts)
        results[f"e2e_{impl}"] = {"reads": len(items), "runs": runs,
                                  "min_s": mn, "median_s": md}
        log(f"phase 7: end to end Realigner path ({impl}), {len(items)} "
            f"long reads: min {mn:.4f}s median {md:.4f}s over {runs} runs "
            f"({len(items) / mn:.2f} reads/s at min)")
    log(f"phase 7: end to end twin/kernel "
        f"{results['e2e_xla']['min_s'] / results['e2e_cuda']['min_s']:.1f}x")


def phase_four(ctx):
    import jax
    from npore_tpu.engine.device_engine import DeviceEngine
    from npore_tpu.engine.realigner import Realigner
    from npore_tpu.io.bam import open_alignment_file
    from npore_tpu.parallel.mesh import make_data_mesh

    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 GPUs, JAX found {len(devs)}")
    fa, bam, truth, items = ctx["long"]
    cfg, ss, ns = ctx["cfg"], ctx["ss"], ctx["ns"]

    def realign(rl):
        rl._device._rr = 0          # same group -> device order every run
        reads = list(open_alignment_file(bam))
        t0 = time.perf_counter()
        out = {r.qname: (r.qname, r.flag, r.pos, r.cigar, r.seq)
               for r in rl.realign_records(iter(reads), 512)}
        return out, time.perf_counter() - t0

    one = Realigner(ss, ns, cfg, devices=devs[:1])
    realign(one)                                   # compile
    ref, t1 = realign(one)
    log(f"phase 8: one GPU: {len(ref)} reads in {t1:.3f}s")
    four = Realigner(ss, ns, cfg, devices=devs)
    realign(four)
    got, t4 = realign(four)
    check(got == ref, "round-robin over 4 GPUs differs from one GPU")
    check(four._device._rr >= 4, "groups did not spread over the GPUs")
    log(f"phase 8: round-robin over 4 GPUs: {len(got)}/{len(ref)} records "
        f"equal to one GPU, {t4:.3f}s; resident tables on "
        f"{len(four._device._tables_on)} devices")
    mesh_rl = Realigner(ss, ns, cfg, devices=devs)
    mesh_rl._device = DeviceEngine(ss, ns, cfg, mesh=make_data_mesh(devs))
    realign(mesh_rl)
    gotm, tm = realign(mesh_rl)
    check(gotm == ref, "mesh over 4 GPUs differs from one GPU")
    log(f"phase 8: shard_mapped mesh over 4 GPUs: {len(gotm)}/{len(ref)} "
        f"records equal to one GPU, {tm:.3f}s")
    ctx["timing"]["four"] = {"one_gpu_s": t1, "round_robin_s": t4,
                             "mesh_s": tm, "reads": len(ref)}


def main() -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run phase 8 (four GPUs against one) only")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="1,2,3,4,5,6,7",
                    help="comma list of phases to run (1 always runs); a "
                         "new kernel's first call can be --phases 1,2,3")
    ap.add_argument("--buckets", default="",
                    help="comma list of r_pad buckets (default: all)")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "smoke"))
    args = ap.parse_args()

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from npore_tpu.config import AlignConfig
    from npore_tpu.engine.device_engine import RQ, DeviceEngine, _r_pad_for
    from npore_tpu.model.scores import (calc_score_matrices,
                                        load_confusion_matrices)
    from npore_tpu.native import get_lib
    from npore_tpu.paths import enable_compilation_cache

    CARD = card_name()
    t_start = time.perf_counter()
    phases = {int(p) for p in args.phases.split(",") if p}
    if args.four:
        phases = {5, 8}
    cache = enable_compilation_cache()
    log(f"phase 1: JAX {jax.__version__} platform {dev.platform}, "
        f"{dev.device_kind} x{len(jax.devices())}; compile cache {cache}; "
        f"native host library "
        f"{'loaded' if get_lib() is not None else 'NOT loaded (numpy)'}")
    os.makedirs(args.out, exist_ok=True)

    cfg = AlignConfig()
    subs, nps, inss, dels = load_confusion_matrices(
        os.path.join(REPO, "guppy5_stats"))
    ss, ns, _, _ = calc_score_matrices(subs, nps, inss, dels)
    buckets = []
    r = RQ
    while r < _r_pad_for(cfg.max_b_rows + 1, cfg.max_b_rows):
        buckets.append(r)
        r *= 2
    buckets.append(_r_pad_for(cfg.max_b_rows + 1, cfg.max_b_rows))
    if args.buckets:
        buckets = [int(b) for b in args.buckets.split(",")]
    ctx = {"cfg": cfg, "ss": ss, "ns": ns, "seed": args.seed,
           "out": args.out, "buckets": buckets, "fuzz": 64,
           "timed_buckets": [b for b in (384, 1536, 3072, 20352)
                             if b in buckets],
           "compiled": {}, "compile_s": {}, "groups": {}, "timing": {}}
    if not args.four:
        from npore_tpu.ops import cuda_dp
        t0 = time.perf_counter()
        lib = cuda_dp.build()
        log(f"phase 1: CUDA library {os.path.basename(lib)} built from "
            f"source in {time.perf_counter() - t0:.1f}s (nvcc, set-up)")
        for line in cuda_dp.BUILD_LOG.splitlines():
            if "registers" in line or "spill" in line:
                log(f"phase 1: ptxas: {line.strip()}")
        ctx["cuda"] = DeviceEngine(ss, ns, cfg, impl="cuda",
                                   devices=jax.devices()[:1])
        ctx["xla"] = DeviceEngine(ss, ns, cfg, impl="xla",
                                  devices=jax.devices()[:1])

    for num, fn in ((2, phase_compile), (3, phase_parity),
                    (4, phase_fixture), (5, phase_long),
                    (6, phase_standardize), (7, phase_timing),
                    (8, phase_four)):
        if num in phases:
            if num == 5 and args.four:
                fa, bam, truth = long_read_set(
                    os.path.join(args.out, "long"), args.seed)
                ctx["long"] = (fa, bam, truth, None)
                continue
            t0 = time.perf_counter()
            fn(ctx)
            log(f"phase {num} done in {time.perf_counter() - t0:.1f}s")

    with open(os.path.join(args.out, "timing.json"), "w") as fh:
        json.dump({"card": CARD, "device_kind": dev.device_kind,
                   "timing": ctx["timing"]}, fh, indent=1)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
