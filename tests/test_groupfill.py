"""native.fill_group (C++ one-call group packer) vs the numpy fallback:
bit-identical packed buffers (engine/prepass.py layout) on randomized
windows, for a full group and a short one (padding rows stay zero).

The packed buffer feeds the device step whose outputs are pinned
golden-exact elsewhere; this test pins only that the C++ fill is a
faithful drop-in for the Python loop it replaces
(engine/device_engine.fill_group_py)."""
import numpy as np
import pytest

from npore_tpu.config import AlignConfig
from npore_tpu.engine.device_engine import fill_group_py
from npore_tpu.engine.prepass import group_words
from npore_tpu.engine.windows import build_windows
from npore_tpu.native import fill_group_native, get_lib


def _random_windows(rng, n_alns, cfg):
    wins = []
    for i in range(n_alns):
        n_ref = int(rng.integers(40, 400))
        ref = rng.integers(1, 5, n_ref).astype(np.int8)
        # mutate ref into seq with indels so inss is non-trivial
        seq = []
        cig = []
        for b in ref:
            u = rng.random()
            if u < 0.08:
                cig.append("D")
                continue
            seq.append(int(b) if u > 0.16 else int(rng.integers(1, 5)))
            cig.append("M")
            if u > 0.9:
                seq.append(int(rng.integers(1, 5)))
                cig.append("I")
        seq = np.asarray(seq, np.int8)
        wins.extend(build_windows(ref, seq, "".join(cig), cfg, aln_idx=i))
    return wins


@pytest.mark.skipif(get_lib() is None, reason="no C++ toolchain")
def test_fill_group_native_matches_python():
    cfg = AlignConfig()
    rng = np.random.default_rng(11)
    wins = _random_windows(rng, 40, cfg)

    r_pad = 768
    wins = [w for w in wins if w.b_rows + 1 <= r_pad]
    assert len(wins) >= 30
    for n_take in (len(wins), 17):          # full group and short tail
        group = wins[:n_take]
        B = 8 * ((n_take + 7) // 8) + 8
        buf_c = np.zeros((B, group_words(r_pad)), np.int32)
        mr_c = fill_group_native(group, r_pad, buf_c)
        assert mr_c is not None

        buf_p = np.zeros_like(buf_c)
        mr_p = fill_group_py(group, buf_p, r_pad)

        assert mr_c == mr_p
        assert np.array_equal(buf_c, buf_p)
        assert not buf_c[n_take:].any()
        # the step bit and base fields are all exercised
        pk = buf_c[:, :r_pad // 4].view(np.uint8)
        assert (pk >> 6).max() == 1
        assert (pk & 7).max() >= 4
        assert (buf_c[:n_take, r_pad // 4] == [w.b_rows for w in group]).all()
