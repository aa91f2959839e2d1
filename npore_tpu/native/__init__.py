"""Native (C++) host kernels, built on demand with g++ and bound via ctypes.

The image has no pybind11, so bindings go through the C ABI. Falls back to
the numpy implementations transparently when no compiler is available.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    from ..paths import BUILD_DIR
    cache = os.path.join(BUILD_DIR, "native")
    try:
        os.makedirs(cache, exist_ok=True)
    except OSError:
        return None
    srcs = [os.path.join(_HERE, "npinfo.cpp"),
            os.path.join(_HERE, "golden_align.cpp"),
            os.path.join(_HERE, "bamio.cpp"),
            os.path.join(_HERE, "groupfill.cpp")]
    out = os.path.join(cache, "libnpore_native.so")
    if (os.path.exists(out)
            and all(os.path.getmtime(out) >= os.path.getmtime(s_)
                    for s_ in srcs)):
        return out
    # build under a private name, then rename: concurrent processes (test
    # workers) never load a half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp] + srcs + ["-lz"],
            check=True, capture_output=True, timeout=180)
        os.replace(tmp, out)
        return out
    except Exception:
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is None and not _tried:
        _tried = True
        path = _build()
        if path:
            try:
                lib = ctypes.CDLL(path)
                lib.np_info.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                    ctypes.c_int32, ctypes.c_int32,
                    ctypes.POINTER(ctypes.c_int32)]
                lib.np_info.restype = None
                lib.normalize_cigar.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int8),
                    ctypes.POINTER(ctypes.c_int8)]
                lib.normalize_cigar.restype = ctypes.c_int32
                lib.finalize_cigar.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int8),
                    ctypes.POINTER(ctypes.c_int8),
                    ctypes.POINTER(ctypes.c_uint8)]
                lib.finalize_cigar.restype = ctypes.c_int64
                lib.finalize_cigar_batch.argtypes = [
                    ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_uint64),
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_uint64),
                    ctypes.POINTER(ctypes.c_uint64),
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64)]
                lib.finalize_cigar_batch.restype = ctypes.c_int64
                lib.path_inss.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64)]
                lib.path_inss.restype = ctypes.c_int64
                lib.golden_align.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                    ctypes.c_int64, ctypes.c_float, ctypes.c_float,
                    ctypes.c_char_p]
                lib.golden_align.restype = ctypes.c_int64
                u64p = ctypes.POINTER(ctypes.c_uint64)
                i64p = ctypes.POINTER(ctypes.c_int64)
                i32p = ctypes.POINTER(ctypes.c_int32)
                lib.fill_group.argtypes = [
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                    u64p, i64p, u64p, i64p, u64p, i32p, i32p]
                lib.fill_group.restype = ctypes.c_int32
                _lib = lib
            except Exception:
                _lib = None
    return _lib


def np_info(seq: np.ndarray, max_n: int = 6, max_l: int = 100) -> np.ndarray:
    """Native get_np_info; exact reference semantics (src/aln.pyx:179-251).
    Falls back to the vectorized numpy version without a compiler."""
    lib = get_lib()
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    if lib is None:
        from ..ops.npinfo_host import get_np_info_vec
        return get_np_info_vec(seq, max_n, max_l)
    out = np.empty((len(seq), 2, max_n), dtype=np.int32)
    lib.np_info(seq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                len(seq), max_n, max_l,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def normalize_cigar_ints(cig: np.ndarray, int_ref: np.ndarray,
                         int_seq: np.ndarray) -> Optional[np.ndarray]:
    """Native in-place left-normalization fixpoint over int-coded ops
    (reference: src/bam.pyx:70-77). Returns None without a compiler."""
    lib = get_lib()
    if lib is None:
        return None
    cig = np.ascontiguousarray(cig, dtype=np.uint8)
    ref8 = np.ascontiguousarray(int_ref, dtype=np.int8)
    seq8 = np.ascontiguousarray(int_seq, dtype=np.int8)
    lib.normalize_cigar(
        cig.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(cig),
        ref8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        seq8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    return cig


def finalize_cigar_native(extended: str, int_ref: np.ndarray,
                          int_seq: np.ndarray) -> Optional[str]:
    """One-call CIGAR finalization (normalize fixpoint + 'ID'->'M' fusion
    + run-length encode; reference: src/bam.pyx:64-83). Returns None
    without a compiler; raises ValueError on an invalid op char."""
    lib = get_lib()
    if lib is None:
        return None
    ext = np.frombuffer(extended.encode("ascii"), dtype=np.uint8)
    ref8 = np.ascontiguousarray(int_ref, dtype=np.int8)
    seq8 = np.ascontiguousarray(int_seq, dtype=np.int8)
    out = np.empty(12 * max(len(ext), 1) + 16, dtype=np.uint8)
    n = lib.finalize_cigar(
        ext.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(ext),
        ref8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        seq8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if n < 0:
        raise ValueError(f"invalid CIGAR op in {extended[:40]!r}...")
    return out[:n].tobytes().decode("ascii")


def path_inss_native(cigar: str) -> Optional[np.ndarray]:
    """One-pass prefix-I counts for the expanded cigar (the stage-A
    window-building hot path); None without a compiler, ValueError on an
    invalid op. Bit-identical to engine.windows.path_inss's numpy form
    (pinned by tests/test_io.py)."""
    lib = get_lib()
    if lib is None:
        return None
    raw = np.frombuffer(cigar.encode("ascii"), dtype=np.uint8)
    out = np.empty(2 * len(raw) + 2, np.int64)
    n = lib.path_inss(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(raw),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if n < 0:
        raise ValueError(f"invalid CIGAR op in {cigar[:40]!r}...")
    return out[:n]


def finalize_cigar_batch(cigars, refs, seqs):
    """Batched CIGAR finalization: ONE FFI call for a whole batch.

    cigars: sequence of extended-cigar str; refs/seqs: matching int8
    numpy arrays. Returns the list of compact cigar strings, or None
    without a compiler / on non-int8 inputs (caller falls back to the
    per-read path). Per-read invalid-op errors also fall back so the
    exact ValueError surfaces from the per-read path.
    """
    lib = get_lib()
    if lib is None:
        return None
    m = len(cigars)
    if m == 0:
        return []
    # uint8 is accepted as-is: base codes are 0..7, so the int8
    # reinterpretation the C side does is value-preserving (the native
    # BAM decoder emits uint8)
    for a in refs:
        if a.dtype.itemsize != 1 or not a.flags.c_contiguous:
            return None
    for a in seqs:
        if a.dtype.itemsize != 1 or not a.flags.c_contiguous:
            return None
    enc = [c.encode("ascii") for c in cigars]     # keep refs alive
    ext_ptrs = np.fromiter(
        (ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p).value or 0
         for b in enc), np.uint64, m)
    ext_lens = np.fromiter((len(b) for b in enc), np.int64, m)
    ref_ptrs = np.fromiter((a.ctypes.data for a in refs), np.uint64, m)
    seq_ptrs = np.fromiter((a.ctypes.data for a in seqs), np.uint64, m)
    cap = int(12 * ext_lens.sum() + 16 * m + 16)
    out = np.empty(cap, np.uint8)
    offs = np.empty(m + 1, np.int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    n = lib.finalize_cigar_batch(
        m, ext_ptrs.ctypes.data_as(u64p), ext_lens.ctypes.data_as(i64p),
        ref_ptrs.ctypes.data_as(u64p), seq_ptrs.ctypes.data_as(u64p),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
        offs.ctypes.data_as(i64p))
    if n < 0:
        return None
    blob = out[:n].tobytes()
    return [blob[offs[i]:offs[i + 1]].decode("ascii") for i in range(m)]


def fill_group_native(group, r_pad: int, buf: np.ndarray) -> Optional[int]:
    """One-call C++ group fill of ``buf`` (B, r_pad // 4 + SCAL) int32, the
    device step's packed input (engine/prepass.py); returns the group's
    max b_rows, or None without a compiler. Bit-identical to
    engine/device_engine.fill_group_py (pinned by tests/test_groupfill.py)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(group)
    ref_ptrs = np.fromiter((w.ref.ctypes.data for w in group),
                           np.uint64, n)
    seq_ptrs = np.fromiter((w.seq.ctypes.data for w in group),
                           np.uint64, n)
    inss_ptrs = np.fromiter((w.inss_local.ctypes.data for w in group),
                            np.uint64, n)
    ref_lens = np.fromiter((len(w.ref) for w in group), np.int64, n)
    seq_lens = np.fromiter((len(w.seq) for w in group), np.int64, n)
    scal5 = np.fromiter(
        ((w.b_rows, w.n_ins, w.n_del, w.ref_guard, w.seq_guard)
         for w in group), np.dtype((np.int32, 5)), n)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    return int(lib.fill_group(
        n, r_pad, buf.shape[1],
        ref_ptrs.ctypes.data_as(u64p), ref_lens.ctypes.data_as(i64p),
        seq_ptrs.ctypes.data_as(u64p), seq_lens.ctypes.data_as(i64p),
        inss_ptrs.ctypes.data_as(u64p), scal5.ctypes.data_as(i32p),
        buf.ctypes.data_as(i32p)))


def golden_align_native(full_ref: np.ndarray, full_seq: np.ndarray,
                        cigar: str, sub_scores: np.ndarray,
                        np_scores: np.ndarray, cfg) -> Optional[str]:
    """Native banded n-polymer DP, bit-exact vs golden/align.py
    (reference: src/aln.pyx:379-787). Returns None without a compiler."""
    lib = get_lib()
    if lib is None:
        return None
    cig = cigar.replace("X", "DI").replace("=", "DI").replace("M", "DI")
    ref8 = np.ascontiguousarray(full_ref, dtype=np.uint8)
    seq8 = np.ascontiguousarray(full_seq, dtype=np.uint8)
    cig8 = np.frombuffer(cig.encode("ascii"), dtype=np.uint8)
    subs = np.ascontiguousarray(sub_scores, dtype=np.float32)
    nps = np.ascontiguousarray(np_scores, dtype=np.float32)
    out = ctypes.create_string_buffer(len(cig) + 16)
    n = lib.golden_align(
        ref8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(ref8),
        seq8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(seq8),
        cig8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        subs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nps.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cfg.max_n, cfg.max_l, cfg.r, cfg.max_b_rows,
        ctypes.c_float(cfg.indel_start), ctypes.c_float(cfg.indel_extend),
        out)
    if n < 0:                 # traceback error: truncated like the reference
        n = -n - 1
    return out.raw[:n].decode("ascii")
