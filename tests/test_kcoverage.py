"""Deep-repeat exactness: n-polymer continuation depths k = run//n + 1 far
beyond the common case, for both LEN and SHR sides and every period n,
through the device engine (the plain-JAX twin on the CPU), plus an in-suite
differential mini-fuzz using the chip fuzzer's generator (reference
semantics: src/aln.pyx:601-667). The engine reads the full continuation
table (k clamped at 127, where the score saturates), so none of these
cases may fall back to the golden engine.
"""
import os
import sys

import numpy as np
import pytest

from npore_tpu.config import AlignConfig
from npore_tpu.constants import bases_to_int
from npore_tpu.engine.device_engine import DeviceEngine
from npore_tpu.engine.realigner import AlignItem
from npore_tpu.golden.align import align as golden_align

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
from fuzz_parity import make_case  # noqa: E402


@pytest.fixture(scope="module")
def engine(score_matrices):
    sub_scores, np_scores, _, _ = score_matrices
    return DeviceEngine(sub_scores, np_scores, AlignConfig())


def _parity(engine, score_matrices, cases):
    sub_scores, np_scores, _, _ = score_matrices
    items = [AlignItem(bases_to_int(r), bases_to_int(s), c)
             for r, s, c in cases]
    got = engine.align_batch(items)
    for it, g in zip(items, got):
        want = golden_align(it.ref, it.seq, it.cigar, sub_scores, np_scores,
                            engine.cfg)
        assert g == want, (it.cigar[:40],)
    return got


def test_deep_k_continuations(engine, score_matrices):
    """Homopolymer runs long enough that k_c walks well past 8 (run up to
    ~19 units) -- both LEN and SHR sides."""
    cases = []
    for reps, d in [(12, 2), (16, 4), (19, 6)]:
        ref = "CG" + "A" * reps + "TTGCA"
        seq = "CG" + "A" * (reps - d) + "TTGCA"
        cig = "==" + "=" * (reps - d) + "D" * d + "====="
        cases.append((ref, seq, cig))
    # dinucleotide period-2 deep continuation
    ref = "C" + "AT" * 22 + "GGACG"
    seq = "C" + "AT" * 19 + "GGACG"
    cases.append((ref, seq, "=" + "=" * 38 + "D" * 6 + "====="))
    _parity(engine, score_matrices, cases)


def test_saturated_runs_exact(engine, score_matrices):
    """Runs deep enough that the continuation score saturates (k_c ~ 40-60):
    golden-exact with no fallback."""
    cases = []
    for reps, d in [(30, 3), (40, 8), (60, 20)]:
        ref = "CG" + "A" * reps + "TTGCA"
        seq = "CG" + "A" * (reps - d) + "TTGCA"
        cig = "==" + "=" * (reps - d) + "D" * d + "====="
        cases.append((ref, seq, cig))
    before = engine.bail_count
    _parity(engine, score_matrices, cases)
    assert engine.bail_count == before


def test_mini_fuzz_parity(engine, score_matrices):
    """In-suite slice of scripts/fuzz_parity.py: repeat-dense random
    mutated reads, bit-exact vs golden."""
    rng = np.random.default_rng(5)
    cases = [make_case(rng) for _ in range(6)]
    _parity(engine, score_matrices, cases)


def _deep_k_cases():
    """Per-n repeat events whose continuation depth k_c = run//n + 1 lands
    well above 8 for every period n=1..6 (reference: src/aln.pyx:601-667)."""
    cases = []
    tail = "GTCGA"
    # n=1 SHR: delete 38 of 45 A's -> k_c up to 39
    cases.append(("CC" + "A" * 45 + tail, "CC" + "A" * 7 + tail,
                  "==" + "=" * 7 + "D" * 38 + "====="))
    # n=1 LEN: insert 25 A's into a 20-A run -> k_c up to 26
    cases.append(("CC" + "A" * 20 + tail, "CC" + "A" * 45 + tail,
                  "==" + "=" * 20 + "I" * 25 + "====="))
    # n=2..6 SHR at deep continuation depths
    for n, units, dels in [(2, 24, 20), (3, 15, 12), (4, 13, 10),
                           (5, 12, 9), (6, 11, 8)]:
        unit = "ACGGTC"[:n]
        ref = "T" + unit * units + tail
        seq = "T" + unit * (units - dels) + tail
        cig = "=" + "=" * n * (units - dels) + "D" * (n * dels) + "====="
        cases.append((ref, seq, cig))
    return cases


def test_deep_k_every_period(engine, score_matrices):
    """Deep continuations for every period resolve golden-exact without
    the golden fallback."""
    before = engine.bail_count
    _parity(engine, score_matrices, _deep_k_cases())
    assert engine.bail_count == before
