"""Differential fuzz: the device engine vs the golden engine.

Generates mutated read/ref pairs with tunable repeat density (n-polymer
contexts are where the interesting transitions live) and asserts identical
extended CIGARs. The device engine is the platform's (the CUDA kernel on a
GPU, the plain-JAX twin on the CPU); the reference is the C++ port of the
golden spec (golden/align.py where no compiler is available). Run any time
kernels change:

    python scripts/fuzz_parity.py [n_cases] [seed]
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from npore_tpu.config import AlignConfig
from npore_tpu.constants import bases_to_int
from npore_tpu.engine.realigner import AlignItem
from npore_tpu.model.scores import calc_score_matrices, load_confusion_matrices

STATS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "guppy5_stats")


def make_case(rng):
    """Random ref with injected repeats + mutated read with exact CIGAR."""
    n = int(rng.integers(60, 900))
    parts = []
    while sum(len(p) for p in parts) < n:
        u = rng.random()
        if u < 0.5:      # random sequence
            k = int(rng.integers(5, 40))
            parts.append("".join("ACGT"[i] for i in rng.integers(0, 4, k)))
        else:            # n-polymer run
            period = int(rng.integers(1, 7))
            unit = "".join("ACGT"[i] for i in rng.integers(0, 4, period))
            reps = int(rng.integers(3, 30))
            parts.append(unit * reps)
    ref = "".join(parts)[:n]
    seq, cig = [], []
    p_del, p_ins, p_sub = 0.03, 0.05, 0.03
    for ch in ref:
        u = rng.random()
        if u < p_del:
            cig.append("D")
            continue
        if u < p_del + p_ins:
            ins_len = 1 + int(rng.random() < 0.3) * int(rng.integers(1, 6))
            for _ in range(ins_len):
                seq.append("ACGT"[rng.integers(0, 4)])
                cig.append("I")
        if u < p_del + p_ins + p_sub:
            alt = "ACGT"[rng.integers(0, 4)]
            seq.append(alt)
            cig.append("=" if alt == ch else "X")
        else:
            seq.append(ch)
            cig.append("=")
    return ref, "".join(seq), "".join(cig)


def golden(it, sub_scores, np_scores, cfg):
    from npore_tpu.native import golden_align_native
    got = golden_align_native(it.ref, it.seq, it.cigar, sub_scores,
                              np_scores, cfg)
    if got is None:
        from npore_tpu.golden.align import align
        got = align(it.ref, it.seq, it.cigar, sub_scores, np_scores, cfg)
    return got


def run(eng, n_cases: int, seed: int, log=print) -> int:
    """Align ``n_cases`` seeded cases with ``eng`` (anything with
    align_batch); returns the number of mismatches against golden."""
    rng = np.random.default_rng(seed)
    items = [AlignItem(bases_to_int(r), bases_to_int(s), c)
             for r, s, c in (make_case(rng) for _ in range(n_cases))]
    t0 = time.perf_counter()
    got = eng.align_batch(items)
    log(f"device: {n_cases} cases in {time.perf_counter() - t0:.1f}s, "
        f"golden fallbacks={eng.bail_count}")
    bad = 0
    for i, (it, g) in enumerate(zip(items, got)):
        want = golden(it, eng.sub_scores, eng.np_scores, eng.cfg)
        if g != want:
            bad += 1
            log(f"MISMATCH case {i} (seed={seed}): ref len {len(it.ref)}")
            log(f"  got : {g[:80]}...")
            log(f"  want: {want[:80]}...")
    log(f"parity: {n_cases - bad}/{n_cases}")
    return bad


def main() -> int:
    from npore_tpu.engine.device_engine import DeviceEngine
    n_cases = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    subs, nps, inss, dels = load_confusion_matrices(STATS)
    sub_scores, np_scores, _, _ = calc_score_matrices(subs, nps, inss, dels)
    eng = DeviceEngine(sub_scores, np_scores, AlignConfig())
    return 1 if run(eng, n_cases, seed) else 0


if __name__ == "__main__":
    sys.exit(main())
