"""Device engine parity vs the golden model, on the CPU.

On the CPU the engine runs the plain-JAX twin of the CUDA kernel (prepass +
ops/band_dp.py scan + tb_slots), behind the same packing, bucketing, slot
decoding, round-robin and golden-fallback code the GPU path uses. It must
reproduce the golden align() bit-for-bit; bailed alignments fall back to
golden and so are exact by construction -- these tests also assert bails
stay rare. The kernel itself is checked against the twin on the GPU by
chip_smoke.py, and its source on the CPU by tests/test_cuda_emulated.py.
"""
import numpy as np
import pytest

from npore_tpu.config import AlignConfig
from npore_tpu.constants import bases_to_int
from npore_tpu.engine.device_engine import DeviceEngine
from npore_tpu.engine.realigner import AlignItem
from npore_tpu.golden.align import align as golden_align
from npore_tpu.io.cigar import expand_cigar

TOYS = [
    ("CAAAGAAAGAAAG", "CAAAGAAAGAAG", "9=1D3="),
    ("CAAAGAAAGAAAG", "CAAAGAAAAGAAAG", "5=1I8="),
    ("CAAAGAAAGAAAG", "CAAAGAAAAG", "5=4D1I4="),
    ("CAAAGAAAGAAAG", "CAAGAAAG", "1=5D7="),
    ("CGAAAGAAAGAAAG", "CGAAGAAAG", "2=5D7="),
    ("CGAAAGAAAGAAAC", "CGAAGAAAC", "2=5D7="),
    ("CAAAAAAAAAG", "CAAAAAG", "1=4D6="),
    ("CAAAAAG", "CAAAAAAAAAAG", "1=5I6="),
    ("TATATATATATACG", "TATATATACG", "4D10="),
    ("TATATACG", "TATATATATATACG", "6I8="),
    ("ACGACGACGACGT", "ACGACGACGACGACGACGT", "6I13="),
]


@pytest.fixture(scope="module")
def engine(score_matrices):
    sub_scores, np_scores, _, _ = score_matrices
    return DeviceEngine(sub_scores, np_scores, AlignConfig())


def _check(engine, score_matrices, cases):
    sub_scores, np_scores, _, _ = score_matrices
    items = [AlignItem(bases_to_int(r), bases_to_int(s), expand_cigar(c))
             for r, s, c in cases]
    got = engine.align_batch(items)
    for it, g in zip(items, got):
        want = golden_align(it.ref, it.seq, it.cigar, sub_scores, np_scores,
                            engine.cfg)
        assert g == want


def test_engine_toys(engine, score_matrices):
    _check(engine, score_matrices, TOYS)


def test_engine_long_indel_runs(engine, score_matrices):
    """I/D runs beyond SLOT_MAX = 63 pin the slot run-chunking (the
    traceback spills long runs across the rows the run skips;
    ops/band_dp.tb_slots)."""
    rng = np.random.default_rng(5)
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, 300))
    cases = []
    for ln in (7, 40, 97, 150):
        # long deletion: ref has an extra unique block
        ins = "".join("ACGT"[i] for i in rng.integers(0, 4, ln))
        cases.append((base[:120] + ins + base[120:], base,
                      f"120={ln}D180="))
        # long insertion: seq has the extra block
        cases.append((base, base[:120] + ins + base[120:],
                      f"120={ln}I180="))
    _check(engine, score_matrices, cases)


def test_engine_random(engine, score_matrices):
    rng = np.random.default_rng(7)
    cases = []
    for _ in range(6):
        n = int(rng.integers(100, 350))
        ref = "".join("ACGT"[i] for i in rng.integers(0, 4, n))
        seq, cig = [], []
        for ch in ref:
            u = rng.random()
            if u < 0.04:
                cig.append("D")
                continue
            if u < 0.09:
                seq.append("ACGT"[rng.integers(0, 4)])
                cig.append("I")
            if u < 0.12:
                seq.append("ACGT"[rng.integers(0, 4)])
                cig.append("=")
            else:
                seq.append(ch)
                cig.append("=")
        cases.append((ref, "".join(seq), "".join(cig)))
    sub_scores, np_scores, _, _ = score_matrices
    items = [AlignItem(bases_to_int(r), bases_to_int(s), c)
             for r, s, c in cases]
    got = engine.align_batch(items)
    for it, g in zip(items, got):
        want = golden_align(it.ref, it.seq, it.cigar, sub_scores, np_scores,
                            engine.cfg)
        assert g == want
    assert engine.bail_count <= 1


def test_engine_repeat_rich(engine, score_matrices):
    cases = [
        ("CAAAAAAAAAG", "CAAAAAG", "1=4D6="),
        ("ACGTACGTACGTACGTAAA", "ACGTACGTACGTAAA", "4D15="),
        ("AAGGAAGGAAGGAAGGTT", "AAGGAAGGTT", "8D10="),
    ]
    _check(engine, score_matrices, cases)


def test_engine_multidevice_roundrobin(score_matrices):
    """Groups round-robin across all local devices (4 virtual CPU devices
    via conftest's 8-device flag); output stays exact."""
    import jax

    sub_scores, np_scores, _, _ = score_matrices
    eng = DeviceEngine(sub_scores, np_scores, AlignConfig(),
                       devices=jax.local_devices()[:4])
    cases = [TOYS[0], TOYS[8]] * 70          # 140 alignments -> >1 group
    items = [AlignItem(bases_to_int(r), bases_to_int(s), expand_cigar(c))
             for r, s, c in cases]
    got = eng.align_batch(items)
    for (r, s, c), g in zip(cases, got):
        want = golden_align(bases_to_int(r), bases_to_int(s),
                            expand_cigar(c), sub_scores, np_scores, eng.cfg)
        assert g == want
    assert eng._rr >= 2


def test_engine_short_group_tail(score_matrices):
    """A batch split into a full group and a short tail group (padding
    windows fill the tail's step) decodes every window exactly."""
    sub_scores, np_scores, _, _ = score_matrices
    eng = DeviceEngine(sub_scores, np_scores, AlignConfig())
    rng = np.random.default_rng(3)
    n = 480                       # b_rows ~ 965 -> bucket 1536, maxb 1151
    ref = "".join("ACGT"[i] for i in rng.integers(0, 4, n))
    seq, cig = [], []
    for ch in ref:
        u = rng.random()
        if u < 0.03:
            cig.append("D")
            continue
        if u < 0.06:
            seq.append("ACGT"[rng.integers(0, 4)])
            cig.append("I")
        seq.append(ch)
        cig.append("=")
    cases = [(ref, "".join(seq), "".join(cig))] * 17   # groups of 8, 8, 1
    items = [AlignItem(bases_to_int(r), bases_to_int(s), c)
             for r, s, c in cases]
    got = eng.align_batch(items)
    want = golden_align(items[0].ref, items[0].seq, items[0].cigar,
                        sub_scores, np_scores, eng.cfg)
    assert all(g == want for g in got)
    assert sorted(eng._steps) == [(1536, 8)]


def test_engine_chunked_alignment(score_matrices):
    """Multi-chunk windows (b_rows > max_b_rows): the standardize-vcf
    whole-contig path splits alignments at anti-diagonal breaks
    (reference: src/aln.pyx:344-358); chunk CIGARs must concatenate to the
    golden result for the same config."""
    sub_scores, np_scores, _, _ = score_matrices
    cfg = AlignConfig(max_b_rows=500)
    eng = DeviceEngine(sub_scores, np_scores, cfg)
    rng = np.random.default_rng(13)
    n = 600                        # b_rows ~ 1200 -> 3 chunks of <= 501 rows
    ref = "".join("ACGT"[i] for i in rng.integers(0, 4, n))
    seq, cig = [], []
    for ch in ref:
        u = rng.random()
        if u < 0.04:
            cig.append("D")
            continue
        if u < 0.08:
            seq.append("ACGT"[rng.integers(0, 4)])
            cig.append("I")
        seq.append(ch)
        cig.append("=")
    item = AlignItem(bases_to_int(ref), bases_to_int("".join(seq)),
                     "".join(cig))
    from npore_tpu.engine.windows import build_windows
    assert len(build_windows(item.ref, item.seq, item.cigar, cfg)) >= 2
    got = eng.align_batch([item])
    want = golden_align(item.ref, item.seq, item.cigar, sub_scores,
                        np_scores, cfg)
    assert got[0] == want

    # a homopolymer run STRADDLING the chunk break (rows ~500 at ref pos
    # ~250 in an all-match prefix): each chunk recomputes np_info on its
    # local slice exactly like the reference (src/aln.pyx:453-456), so
    # the concatenated CIGAR must still equal golden
    ref2 = list("".join("ACGT"[i] for i in rng.integers(0, 4, n)))
    ref2[235:265] = "A" * 30
    ref2 = "".join(ref2)
    seq2 = ref2[:240] + ref2[244:]              # 4-base deletion in the run
    cig2 = "=" * 240 + "D" * 4 + "=" * (n - 244)
    item2 = AlignItem(bases_to_int(ref2), bases_to_int(seq2), cig2)
    ws = build_windows(item2.ref, item2.seq, item2.cigar, cfg)
    assert len(ws) >= 2
    got2 = eng.align_batch([item2])
    want2 = golden_align(item2.ref, item2.seq, item2.cigar, sub_scores,
                         np_scores, cfg)
    assert got2[0] == want2


def test_engine_synthetic_reads(score_matrices):
    """Fresh synthetic reads (generator mirrors test/generate_bam.py):
    engine == golden on data never seen by the fixtures."""
    from generate_data import make_read, make_ref

    sub_scores, np_scores, _, _ = score_matrices
    cfg = AlignConfig()
    eng = DeviceEngine(sub_scores, np_scores, cfg)
    rng = np.random.default_rng(99)
    ref = make_ref(rng, 600)
    items = []
    for _ in range(6):
        pos, seq, cig = make_read(rng, ref, min_len=150, max_len=250)
        items.append(AlignItem(bases_to_int(ref[pos:pos + 250 + 50]
                                            [:sum(c in "=XD" for c in cig)]),
                               bases_to_int(seq), cig))
    got = eng.align_batch(items)
    for it, g in zip(items, got):
        want = golden_align(it.ref, it.seq, it.cigar, sub_scores, np_scores,
                            cfg)
        assert g == want


def test_engine_mixed_period_chain(score_matrices):
    """Regression (fuzz seed 7, case 113): mixed-period continuation chains
    (a run started by one n extended by another) can present k_c == 1; the
    k-select must cover it via the start plane or the candidate silently
    vanishes (reference reads np_score(n, l, 1) there)."""
    sub_scores, np_scores, _, _ = score_matrices
    ref = ("CACCGTATGATGCTCCTGACCGACCCGGCAGCGCACACTATTCTAATACCCGTTCCCGTT"
           "CCCGTTCCCGTTCCCGTTCCCGTTCCCGTTCCCGTTACAAGCCAGAACCCTATCCTGGC"
           "TATAGATATATCGATACG")
    seq = ("AAACCGTATGATGCACCTGACCGCGCCCGACAGCGCACACTATTCTAATACACGTTCCCGA"
           "TCCCGTTTCCCGTTTCCCGTTCCCGTTCCCGTTCGTCGTTGCAAGCCCGAACCCATCCTGG"
           "CATGTCTTTATCGATACG")
    # exact generating cigar is immaterial for the regression; use a plain
    # banded diagonal anchor
    n = min(len(ref), len(seq))
    cig = "=" * n + ("D" * (len(ref) - n) if len(ref) > n
                     else "I" * (len(seq) - n))
    # the assertion must catch a silent k_c==1 miss, not be masked by the
    # exact fallback
    eng = DeviceEngine(sub_scores, np_scores, AlignConfig())
    items = [AlignItem(bases_to_int(ref), bases_to_int(seq), cig)]
    got = eng.align_batch(items)
    want = golden_align(items[0].ref, items[0].seq, items[0].cigar,
                        sub_scores, np_scores, eng.cfg)
    assert eng.bail_count == 0
    assert got[0] == want


def test_tiny_bucket_merges_upward(score_matrices):
    """A bucket of fewer than MIN_GROUP windows whose step is not compiled
    rides a larger bucket that is needed anyway instead of paying a compile
    of its own. Exactness: r_pad only sizes the zero-padded tables."""
    sub_scores, np_scores, _, _ = score_matrices
    eng = DeviceEngine(sub_scores, np_scores, AlignConfig())
    rng = np.random.default_rng(21)
    items = []
    # one short alignment (384 bucket) + enough long ones for a 768 group
    ref = "".join("ACGT"[i] for i in rng.integers(0, 4, 120))
    items.append(AlignItem(bases_to_int(ref), bases_to_int(ref),
                           "=" * len(ref)))
    for _ in range(3):
        ref = "".join("ACGT"[i] for i in rng.integers(0, 4, 330))
        seq = ref[:100] + ref[103:]
        items.append(AlignItem(bases_to_int(ref), bases_to_int(seq),
                               "=" * 100 + "DDD" + "=" * (len(ref) - 103)))
    got = eng.align_batch(items)
    assert sorted(eng._steps) == [(768, 8)], (
        "tiny 384 bucket should merge into the needed 768 bucket")
    for it, g in zip(items, got):
        want = golden_align(it.ref, it.seq, it.cigar, sub_scores,
                            np_scores, eng.cfg)
        assert g == want
