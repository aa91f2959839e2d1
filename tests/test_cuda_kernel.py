"""The CUDA kernel on the GPU against the plain-JAX twin: identical slots
and bail flags for identical packed groups, and golden-exact CIGARs through
the engine. Marked ``gpu``: skipped where JAX finds no GPU (chip_smoke.py
phase 3 runs the same comparisons at every bucket on the card)."""
import numpy as np
import pytest

from npore_tpu.config import AlignConfig
from npore_tpu.constants import bases_to_int
from npore_tpu.engine.device_engine import (DeviceEngine, _r_pad_for,
                                            make_step, pack_group)
from npore_tpu.engine.realigner import AlignItem
from npore_tpu.engine.windows import build_windows
from npore_tpu.ops.band_dp import build_cont_tables


def _cases(seed, n):
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    from fuzz_parity import make_case
    rng = np.random.default_rng(seed)
    return [make_case(rng) for _ in range(n)]


@pytest.mark.gpu
def test_kernel_matches_twin_on_gpu(gpu, score_matrices):
    sub_scores, np_scores, _, _ = score_matrices
    cfg = AlignConfig()
    wins = []
    for i, (r, s, c) in enumerate(_cases(3, 16)):
        wins += build_windows(bases_to_int(r), bases_to_int(s), c, cfg,
                              aln_idx=i)
    r_pad = max(_r_pad_for(w.b_rows + 1, cfg.max_b_rows) for w in wins)
    B = 64
    buf = pack_group(wins, r_pad, B)
    cont = build_cont_tables(np_scores, cfg.max_n, cfg.max_l).reshape(-1)
    sub = np.asarray(sub_scores, np.float32).reshape(-1)
    got = [np.asarray(a) for a in make_step("cuda", r_pad, B, cfg)(
        buf, cont, sub)]
    want = [np.asarray(a) for a in make_step("xla", r_pad, B, cfg)(
        buf, cont, sub)]
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                              want[1])


@pytest.mark.gpu
def test_kernel_engine_golden_exact_on_gpu(gpu, score_matrices):
    from npore_tpu.native import golden_align_native
    sub_scores, np_scores, _, _ = score_matrices
    eng = DeviceEngine(sub_scores, np_scores, AlignConfig(), impl="cuda")
    items = [AlignItem(bases_to_int(r), bases_to_int(s), c)
             for r, s, c in _cases(9, 24)]
    for it, g in zip(items, eng.align_batch(items)):
        assert g == golden_align_native(it.ref, it.seq, it.cigar,
                                        sub_scores, np_scores, eng.cfg)
    assert eng.bail_count == 0
