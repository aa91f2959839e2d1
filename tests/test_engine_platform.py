"""The device engine's platform rules and the CUDA kernel's wrapper, on the
CPU: which implementation the platform picks, that the GPU kernel is never
silently replaced, the FFI call's operands and results (abstractly, against
the plain twin), where the compile cache lands, slot decoding, and the twin
across a max_b_rows chunk boundary."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from npore_tpu.config import AlignConfig
from npore_tpu.engine import prepass as pp
from npore_tpu.engine.device_engine import (DeviceEngine, decode_slots,
                                            make_step, platform_impl)
from npore_tpu.engine.realigner import AlignItem, Realigner
from npore_tpu.paths import JAX_CACHE_DIR, REPO_DIR


def test_platform_picks_the_implementation(score_matrices):
    sub_scores, np_scores, _, _ = score_matrices
    assert jax.default_backend() == "cpu"
    assert platform_impl() == "xla"
    assert DeviceEngine(sub_scores, np_scores).impl == "xla"
    rl = Realigner(sub_scores, np_scores, engine="auto")
    assert rl.engine == "xla" and rl._device.impl == "xla"
    assert Realigner(sub_scores, np_scores, engine="golden")._device is None


@pytest.mark.parametrize("make", [
    lambda s, n: DeviceEngine(s, n, impl="cuda"),
    lambda s, n: Realigner(s, n, engine="cuda"),
], ids=["engine", "realigner"])
def test_cuda_without_gpu_raises(score_matrices, make):
    """Asking for the GPU kernel without a GPU raises; nothing falls back
    to the twin or the CPU."""
    sub_scores, np_scores, _, _ = score_matrices
    with pytest.raises(RuntimeError, match="needs a GPU"):
        make(sub_scores, np_scores)


def _ffi_eqns(jaxpr):
    out = []
    for eqn in jaxpr.eqns:
        if "ffi" in eqn.primitive.name:
            out.append(eqn)
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out.extend(_ffi_eqns(sub))
    return out


@pytest.mark.parametrize("r_pad,B", [(384, 8), (1536, 16)])
def test_cuda_step_shapes_match_twin(score_matrices, r_pad, B):
    """The kernel's step traces to one FFI call with the operand layout
    ops/cuda/dp_tb.cu reads, and returns what the twin returns."""
    cfg = AlignConfig()
    buf = jax.ShapeDtypeStruct((B, pp.group_words(r_pad)), np.int32)
    cont = jax.ShapeDtypeStruct((2 * cfg.max_n * 101 * 128,), np.float32)
    sub = jax.ShapeDtypeStruct((25,), np.float32)
    got = jax.eval_shape(make_step("cuda", r_pad, B, cfg), buf, cont, sub)
    want = jax.eval_shape(make_step("xla", r_pad, B, cfg), buf, cont, sub)
    assert [(a.shape, a.dtype) for a in got] == \
        [(a.shape, a.dtype) for a in want] == \
        [((B, r_pad), np.uint8), ((B,), np.int32)]

    jaxpr = jax.make_jaxpr(make_step("cuda", r_pad, B, cfg))(
        np.zeros(buf.shape, np.int32), np.zeros(cont.shape, np.float32),
        np.zeros(sub.shape, np.float32))
    (eqn,) = _ffi_eqns(jaxpr.jaxpr)
    P = r_pad + 2 * pp.OFF
    assert [(v.aval.shape, v.aval.dtype) for v in eqn.invars] == [
        ((B, P, 4), np.int32), ((B, P, 2), np.int32), ((B, r_pad), np.int32),
        ((B, pp.SCAL), np.int32), (cont.shape, np.float32),
        ((25,), np.float32)]
    assert [(v.aval.shape, v.aval.dtype) for v in eqn.outvars] == [
        ((B, r_pad), np.uint8), ((B,), np.int32), ((B, r_pad, 64), np.int32)]
    assert eqn.params["target_name"] == "npore_dp_tb"
    attrs = dict(eqn.params["attributes"])
    assert attrs == {"r": cfg.r, "max_n": cfg.max_n, "inf": cfg.inf,
                     "istart": cfg.indel_start, "iext": cfg.indel_extend}


_CACHE_PROBE = """
import jax, os
jax.config.update("jax_platforms", "cpu")
from npore_tpu.paths import enable_compilation_cache
d = enable_compilation_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: x * 3 + 1)(jax.numpy.arange(7)).block_until_ready()
print(d)
"""


@pytest.mark.parametrize("env_dir", [True, False], ids=["env", "default"])
def test_compile_cache_placement(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR, where set, is the cache and the code sets
    no other; unset, the cache is the fixed in-checkout directory."""
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE], cwd=REPO_DIR,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = out.stdout.strip().splitlines()[-1]
    if env_dir:
        assert got == str(tmp_path)
        assert os.listdir(tmp_path), "no cache entry written"
    else:
        assert got == JAX_CACHE_DIR == os.path.join(REPO_DIR, ".jax_cache")


def test_decode_slots_spills_and_padding():
    """Slot bytes (op | count << 2) read in ascending row order; a long run
    spills over rows, padding windows decode to nothing."""
    slots = np.zeros((3, 16), np.uint8)
    slots[0, [2, 4]] = [0 | 1 << 2, 1 | 1 << 2]            # '=' then 'X'
    slots[0, 9:11] = [3 | 63 << 2, 3 | 7 << 2]             # 70 D's
    slots[1, 1] = 2 | 3 << 2                               # 'III'
    assert decode_slots(slots, 3) == ["=X" + "D" * 70, "III", ""]
    assert decode_slots(slots, 2) == ["=X" + "D" * 70, "III"]


def test_twin_across_chunk_boundary(score_matrices):
    """A read whose path spans more than max_b_rows = 20000 anti-diagonals
    splits into independent windows (src/aln.pyx:344-358, 445-456); the
    concatenated CIGAR equals the golden engine's, in the 20352 bucket."""
    from generate_data import make_read, make_ref
    from npore_tpu.constants import bases_to_int
    from npore_tpu.engine.windows import build_windows
    from npore_tpu.native import golden_align_native

    sub_scores, np_scores, _, _ = score_matrices
    cfg = AlignConfig()
    rng = np.random.default_rng(17)
    ref = make_ref(rng, 14000)
    pos, seq, cig = make_read(rng, ref, min_len=11000, max_len=11500)
    span = sum(c in "=XD" for c in cig)
    it = AlignItem(bases_to_int(ref[pos:pos + span]), bases_to_int(seq), cig)
    wins = build_windows(it.ref, it.seq, it.cigar, cfg)
    assert len(wins) == 2 and wins[0].b_rows >= cfg.max_b_rows - 1
    eng = DeviceEngine(sub_scores, np_scores, cfg)
    got = eng.align_batch([it])[0]
    want = golden_align_native(it.ref, it.seq, it.cigar, sub_scores,
                               np_scores, cfg)
    if want is None:
        pytest.skip("no C++ toolchain for the golden engine")
    assert got == want and eng.bail_count == 0
    assert (20352, 8) in eng._steps
