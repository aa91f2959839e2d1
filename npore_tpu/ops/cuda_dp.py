"""The CUDA DP + traceback kernel (ops/cuda/dp_tb.cu) as a JAX operation.

The kernel is compiled with nvcc for Hopper (sm_90a) from the committed
source into BUILD_DIR/cuda at first use (a set-up cost of seconds), loaded
with ctypes and registered as the XLA FFI target ``npore_dp_tb`` on the
CUDA platform. There is no fallback: without nvcc or a GPU, building or
registering raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from .band_dp import LW

TARGET = "npore_dp_tb"
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda",
                   "dp_tb.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler",
              "-fPIC")
_lock = threading.Lock()
_lib = None
BUILD_LOG = ""      # nvcc's report (ptxas registers/spills) of this build


def find_nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA realignment kernel is "
                           "built from source at first use")
    return path


def build() -> str:
    """Compile the kernel library unless this source's build exists;
    returns its path (named by a hash of source and flags)."""
    global BUILD_LOG
    import jax.ffi
    from ..paths import BUILD_DIR

    with open(SRC, "rb") as fh:
        src = fh.read()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out_dir = os.path.join(BUILD_DIR, "cuda")
    out = os.path.join(out_dir, f"libnpore_dp_tb-{tag[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-I", jax.ffi.include_dir(),
           "-o", tmp, SRC]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    BUILD_LOG = res.stderr + res.stdout
    os.replace(tmp, out)
    return out


def register() -> None:
    """Build, load and register the FFI target once per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return
        import jax
        lib = ctypes.cdll.LoadLibrary(build())
        jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.NporeDpTb),
                                    platform="CUDA")
        _lib = lib


def dp_tb(rw, sw, inss, scal, cont, sub, cfg):
    """The kernel call: rw (B, P, 4), sw (B, P, 2), inss (B, R), scal
    (B, 8) int32; cont, sub f32 (flat). Returns slots (B, R) uint8 and
    bail (B,) int32, as ops/band_dp.tb_slots does."""
    import jax

    B, R = inss.shape
    out_types = (jax.ShapeDtypeStruct((B, R), np.uint8),
                 jax.ShapeDtypeStruct((B,), np.int32),
                 jax.ShapeDtypeStruct((B, R, LW), np.int32))   # MAT plane
    slots, bail, _ = jax.ffi.ffi_call(TARGET, out_types)(
        rw, sw, inss, scal, cont, sub, r=np.int32(cfg.r),
        max_n=np.int32(cfg.max_n), istart=np.float32(cfg.indel_start),
        iext=np.float32(cfg.indel_extend), inf=np.float32(cfg.inf))
    return slots, bail
