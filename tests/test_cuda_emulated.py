"""The CUDA kernel's source (npore_tpu/ops/cuda/dp_tb.cu), run on the CPU by
a warp emulator (tests/cuda_emu/warp_emu.cpp), against the plain-JAX twin
it is compared with on the GPU: identical slot bytes and bail flags for the
same packed groups, from the same prepass tables.

This checks the kernel's logic where there is no GPU; what only the GPU
can show (that nvcc accepts it, and its speed) is checked by chip_smoke.py.
"""
import ctypes
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest

from npore_tpu.config import AlignConfig
from npore_tpu.constants import bases_to_int
from npore_tpu.engine import prepass as pp
from npore_tpu.engine.device_engine import _r_pad_for, make_step, pack_group
from npore_tpu.engine.windows import build_windows
from npore_tpu.ops.band_dp import build_cont_tables

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    out = str(tmp_path_factory.mktemp("emu") / "libwarp_emu.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o", out,
                    os.path.join(HERE, "cuda_emu", "warp_emu.cpp")],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(out)


def _emulate(lib, buf, r_pad, cfg, cont, sub):
    ref, seq, inss, scal = pp.unpack(jnp.asarray(buf), r_pad)
    Lr, LZr, Ls, LZs = pp.np_tables(ref, seq, cfg.max_n, cfg.max_l)
    rw, sw = pp.kernel_tables(ref, seq, scal, Lr, LZr, Ls, LZs, cfg.max_n)
    arrs = [np.ascontiguousarray(np.asarray(a), np.int32)
            for a in (rw, sw, inss, scal)]
    B = buf.shape[0]
    slots = np.zeros((B, r_pad), np.uint8)
    bail = np.zeros(B, np.int32)
    plane = np.zeros((B, r_pad, 64), np.int32)
    i32 = ctypes.POINTER(ctypes.c_int32)
    f32 = ctypes.POINTER(ctypes.c_float)
    lib.emulate_dp_tb(*[a.ctypes.data_as(i32) for a in arrs],
                      cont.ctypes.data_as(f32), sub.ctypes.data_as(f32),
                      slots.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                      bail.ctypes.data_as(i32), plane.ctypes.data_as(i32),
                      B, r_pad, cfg.r, cfg.max_n,
                      ctypes.c_float(cfg.indel_start),
                      ctypes.c_float(cfg.indel_extend),
                      ctypes.c_float(cfg.inf))
    return slots, bail


def _fuzz(rng, n):
    from fuzz_parity import make_case
    return [make_case(rng) for _ in range(n)]


def _long_indels(rng, n=1):
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, 150))
    out = []
    for ln in (70, 130)[:n + 1]:
        blk = "".join("ACGT"[i] for i in rng.integers(0, 4, ln))
        out.append((base[:60] + blk + base[60:], base,
                    "=" * 60 + "D" * ln + "=" * 90))
        out.append((base, base[:60] + blk + base[60:],
                    "=" * 60 + "I" * ln + "=" * 90))
    return out


@pytest.mark.parametrize("cfg,cases", [
    (AlignConfig(), lambda rng: _fuzz(rng, 3)),
    (AlignConfig(), _long_indels),
    (AlignConfig(r=10, max_b_rows=90, max_n=4), lambda rng: _fuzz(rng, 2)),
], ids=["fuzz", "long_indels", "small_band_chunked"])
def test_kernel_source_matches_twin(emulator, score_matrices, cfg, cases):
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "scripts"))
    sub_scores, np_scores, _, _ = score_matrices
    rng = np.random.default_rng(23)
    wins = []
    for i, (r, s, c) in enumerate(cases(rng)):
        wins += build_windows(bases_to_int(r), bases_to_int(s), c, cfg,
                              aln_idx=i)
    r_pad = max(_r_pad_for(w.b_rows + 1, cfg.max_b_rows) for w in wins)
    B = 8 * ((len(wins) + 8) // 8)              # at least one padding row
    buf = pack_group(wins, r_pad, B)
    cont = build_cont_tables(np_scores, cfg.max_n, cfg.max_l).reshape(-1)
    sub = np.asarray(sub_scores, np.float32).reshape(-1)
    want_slots, want_bail = (np.asarray(a) for a in make_step(
        "xla", r_pad, B, cfg)(buf, cont, sub))
    slots, bail = _emulate(emulator, buf, r_pad, cfg, cont, sub)
    assert np.array_equal(bail, want_bail)
    for w in range(B):
        assert np.array_equal(slots[w], want_slots[w]), w
    assert want_slots[:len(wins)].any(axis=1).all()
