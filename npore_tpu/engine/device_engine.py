"""Host orchestration of the device realignment step.

Packs windows into one int32 buffer per group (engine/prepass.py layout),
runs the device step (prepass + banded DP + traceback) and decodes the
per-row slot bytes into extended CIGARs. Alignments whose traceback fails
are redone with the exact C++ golden engine.

The platform chooses the step's implementation:

* ``cuda`` on a GPU: the hand-written kernel of ops/cuda/dp_tb.cu, called
  through ``jax.ffi`` (ops/cuda_dp.py);
* ``xla`` on the CPU: the plain-JAX twin (ops/band_dp.py scan +
  ``tb_slots``), which is also the reference the kernel is compared with.

Both take the same packed group and return the same (slots, bail) arrays.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import AlignConfig
from ..native import fill_group_native
from ..ops.band_dp import LW, Tables, build_cont_tables
from .prepass import group_words
from .windows import Window, build_windows

RQ = 384                # r_pad quantum: buckets are RQ * 2^k, capped
IMPLS = ("cuda", "xla")
MIN_GROUP = 8           # smallest group; also the tiny-bucket merge bound
MAX_GROUP = 4096
CPU_GROUP = 8           # windows per group on the CPU (tests)
_OPCH = np.frombuffer(b"=XID", dtype=np.uint8)


def platform_impl() -> str:
    """The implementation the current JAX platform runs."""
    import jax
    plat = jax.default_backend()
    if plat == "gpu":
        return "cuda"
    if plat == "cpu":
        return "xla"
    raise RuntimeError(f"no realignment engine for JAX platform {plat!r}")


def check_impl(impl: Optional[str]) -> str:
    """Resolve ``impl`` (None = by platform); raise if it cannot run here."""
    import jax
    if impl is None:
        return platform_impl()
    if impl not in IMPLS:
        raise ValueError(f"unknown device implementation {impl!r}")
    if impl == "cuda" and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the CUDA realignment kernel needs a GPU; JAX found platform "
            f"{jax.default_backend()!r}")
    return impl


def _r_pad_for(b_rows: int, max_b_rows: int) -> int:
    """Geometric bucket ladder (x RQ) bounds compile count to ~7 shapes."""
    cap = ((max_b_rows + 2 + RQ - 1) // RQ) * RQ
    r = RQ
    while r < min(max(b_rows, 1), cap):
        r *= 2
    return min(r, cap)


def window_bytes(r_pad: int) -> int:
    """Device bytes one window of the bucket takes in a step, 13 per band
    lane and row: the twin's typ (1) and run (4) planes and the two packed
    copies its traceback scan reads (8); the kernel needs less (its 4-byte
    MAT plane and 24 bytes of tables per row). Both implementations size
    groups by it, so they compile the same shapes."""
    return r_pad * 13 * LW


def make_step(impl: str, r_pad: int, B: int, cfg: AlignConfig, mesh=None):
    """The jitted device step ``(buf, cont, sub) -> (slots, bail)``.

    buf: (B, group_words(r_pad)) int32 packed group; cont: flat
    (2 * max_n * 101 * 128,) f32 continuation table; sub: (25,) f32.
    slots: (B, r_pad) uint8; bail: (B,) int32. With ``mesh`` (1-D
    ``data``), the step is shard_mapped and ``B`` is the global size."""
    import jax

    from ..ops.band_dp import make_window_dp, tb_slots
    from . import prepass as pp

    dp = make_window_dp(r_pad, cfg, cfg.max_n, jit=False) \
        if impl == "xla" else None

    def step(buf, cont, sub):
        ref, seq, inss, scal = pp.unpack(buf, r_pad)
        Lr, LZr, Ls, LZs = pp.np_tables(ref, seq, cfg.max_n, cfg.max_l)
        if impl == "cuda":
            from ..ops.cuda_dp import dp_tb
            rw, sw = pp.kernel_tables(ref, seq, scal, Lr, LZr, Ls, LZs,
                                      cfg.max_n)
            return dp_tb(rw, sw, inss, scal, cont, sub, cfg)
        batch = pp.band_batch(ref, seq, inss, scal, Lr, LZr, Ls, LZs,
                              cont.reshape(2, cfg.max_n, 101, -1))
        typ, run = dp(batch, Tables(sub_flat=sub, cont=cont))
        return tb_slots(typ, run, inss, seq, ref, scal[:, 1], scal[:, 2],
                        cfg.r)

    if mesh is not None:
        from jax.sharding import PartitionSpec as P
        step = jax.shard_map(step, mesh=mesh,
                             in_specs=(P("data", None), P(None), P(None)),
                             out_specs=(P("data", None), P("data")),
                             check_vma=False)
    return jax.jit(step)


def fill_group_py(group: Sequence[Window], buf: np.ndarray,
                  r_pad: int) -> int:
    """numpy form of native.fill_group (its fallback and equality oracle,
    tests/test_groupfill.py). Returns the group's max b_rows."""
    pk = buf[:, :r_pad // 4].view(np.uint8)
    scal = buf[:, r_pad // 4:]
    max_rows = 1
    for j, w in enumerate(group):
        max_rows = max(max_rows, w.b_rows)
        pk[j, :len(w.ref)] = np.asarray(w.ref).astype(np.uint8) & 7
        pk[j, :len(w.seq)] |= (np.asarray(w.seq).astype(np.uint8) & 7) << 3
        dels = np.arange(w.b_rows) - w.inss_local.astype(np.int64)
        pk[j, 1:w.b_rows] |= np.diff(dels).astype(np.uint8) << 6
        scal[j, :5] = (w.b_rows, w.n_ins, w.n_del, w.ref_guard, w.seq_guard)
    return max_rows


def pack_group(group: Sequence[Window], r_pad: int, B: int) -> np.ndarray:
    buf = np.zeros((B, group_words(r_pad)), np.int32)
    if fill_group_native(group, r_pad, buf) is None:
        fill_group_py(group, buf, r_pad)
    return buf


def decode_slots(slots: np.ndarray, n: int) -> List[str]:
    """Extended CIGARs of the first ``n`` windows from (B, R) slot bytes:
    expand every nonzero byte (op | count << 2) in ascending row order."""
    slots = slots[:n]
    mask = slots != 0
    flat = slots[mask]
    counts = (flat >> 2).astype(np.int64)
    chars = np.repeat(_OPCH[flat & 3], counts).tobytes()
    wid = np.repeat(np.arange(n), mask.sum(axis=1))
    bounds = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(wid, weights=counts, minlength=n).astype(np.int64),
              out=bounds[1:])
    return [chars[bounds[k]:bounds[k + 1]].decode("ascii") for k in range(n)]


class DeviceEngine:
    """Batched device realignment engine.

    Data parallelism across devices is group round-robin: each submitted
    group goes to the next local device, so groups run concurrently on
    different devices (reads are independent; each device holds its own
    copy of the score tables). With ``mesh``, every group is one
    shard_mapped step over all of the mesh's devices instead.
    """

    def __init__(self, sub_scores: np.ndarray, np_scores: np.ndarray,
                 cfg: AlignConfig = AlignConfig(), impl: Optional[str] = None,
                 devices: Optional[list] = None, mesh=None):
        import jax
        self.impl = check_impl(impl)
        self.cfg = cfg
        self.mesh = mesh
        self.n_shards = mesh.size if mesh is not None else 1
        self.devices = devices if devices is not None else jax.local_devices()
        self._rr = 0
        self.sub_scores = np.asarray(sub_scores, np.float32)
        self.np_scores = np_scores
        self._cont = build_cont_tables(np_scores, cfg.max_n,
                                       cfg.max_l).reshape(-1)
        self._sub = self.sub_scores.reshape(-1)
        self._tables_on: Dict[object, tuple] = {}   # device -> (cont, sub)
        self._steps: Dict[Tuple[int, int], object] = {}
        self.bail_count = 0
        if self.impl == "cuda":
            from ..ops.cuda_dp import register
            register()
        # one submitter thread: group i+1's packing overlaps the caller's
        # host work on group i; results are collected in submission order
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="npore-submit")
        self._lock = threading.Lock()       # guards _rr/_tables_on/_steps

    # ------------------------------------------------------------------
    def group_for(self, r_pad: int) -> int:
        """Windows per device per step for the bucket: as many as a third of
        the device's memory limit holds, a power of two up to MAX_GROUP;
        CPU_GROUP on devices that report no memory limit (the CPU). One
        size per bucket keeps the compiled shapes to one per bucket."""
        stats = self.devices[0].memory_stats() or {}
        limit = stats.get("bytes_limit")
        if not limit:
            return CPU_GROUP
        g = limit // 3 // window_bytes(r_pad)
        b = MIN_GROUP
        while b * 2 <= min(g, MAX_GROUP):
            b *= 2
        return b

    def step(self, r_pad: int, B: int):
        key = (r_pad, B)
        with self._lock:
            if key not in self._steps:
                self._steps[key] = make_step(self.impl, r_pad, B, self.cfg,
                                             self.mesh)
            return self._steps[key]

    def _tables(self, dev):
        import jax
        with self._lock:
            t = self._tables_on.get(dev)
            if t is None:
                t = (jax.device_put(self._cont, dev),
                     jax.device_put(self._sub, dev))
                self._tables_on[dev] = t
            return t

    # ------------------------------------------------------------------
    def align_batch(self, items) -> List[str]:
        """items: sequence with .ref/.seq int arrays and .cigar (expanded).
        Returns extended CIGARs over '=XID'."""
        return self.align_batch_async(items)()

    def align_batch_async(self, items):
        """Submit a batch; returns a zero-arg collector.

        Device work is dispatched asynchronously here, so the caller can
        submit batch i+1 before collecting batch i (the realigner overlaps
        per-read host post-processing with the next batch's device work,
        the batched analog of the reference's pipelined pool workers,
        src/realign.py:110-114)."""
        cfg = self.cfg
        items = list(items)
        windows: List[Window] = []
        for i, it in enumerate(items):
            windows.extend(build_windows(it.ref, it.seq, it.cigar, cfg,
                                         aln_idx=i))

        by_r: Dict[int, List[Window]] = {}
        for w in windows:
            by_r.setdefault(_r_pad_for(w.b_rows + 1, cfg.max_b_rows),
                            []).append(w)

        # merge tiny buckets upward: a bucket of fewer than MIN_GROUP
        # windows whose step is not compiled yet rides a larger bucket that
        # is needed anyway, instead of paying a compile of its own. Exact:
        # r_pad only sizes the zero-padded tables.
        compiled = {rp for rp, _ in self._steps}
        for rp in sorted(by_r)[:-1]:
            if len(by_r[rp]) >= MIN_GROUP or rp in compiled:
                continue
            target = min(x for x in by_r if x > rp)
            by_r[target] = by_r.pop(rp) + by_r[target]

        pending = []
        for r_pad, wins in sorted(by_r.items()):
            wins.sort(key=lambda w: w.b_rows)
            bw = self.n_shards * self.group_for(r_pad)
            for lo in range(0, len(wins), bw):
                group = wins[lo:lo + bw]
                pending.append((group, self._pool.submit(
                    self._submit_group, group, r_pad)))
        return lambda: self._finish_batch(items, pending)

    def _submit_group(self, group: Sequence[Window], r_pad: int):
        import jax
        B = self.n_shards * self.group_for(r_pad)
        buf = pack_group(group, r_pad, B)
        if self.mesh is not None:
            args = (buf, self._cont, self._sub)
        else:
            with self._lock:
                dev = self.devices[self._rr % len(self.devices)]
                self._rr += 1
            cont, sub = self._tables(dev)
            args = (jax.device_put(buf, dev), cont, sub)
        out = self.step(r_pad, B)(*args)
        for a in out:       # start the D2H while later groups compute
            a.copy_to_host_async()
        return out

    def _finish_batch(self, items, pending) -> List[str]:
        cfg = self.cfg
        chunk_cigars: Dict[Tuple[int, int], str] = {}
        bailed = set()
        for group, fut in pending:
            slots, bail = (np.asarray(a) for a in fut.result())
            for w, cig, b in zip(group, decode_slots(slots, len(group)),
                                 bail):
                if b:
                    bailed.add(w.key[0])
                chunk_cigars[w.key] = cig

        # traceback errors: redo the whole alignment with the exact golden
        # engine (the native C++ port, else the numpy spec)
        from ..native import golden_align_native
        for i in sorted(bailed):
            self.bail_count += 1
            it = items[i]
            full = golden_align_native(it.ref, it.seq, it.cigar,
                                       self.sub_scores, self.np_scores, cfg)
            if full is None:
                from ..golden.align import align as golden_align
                full = golden_align(it.ref, it.seq, it.cigar,
                                    self.sub_scores, self.np_scores, cfg)
            for w in build_windows(it.ref, it.seq, it.cigar, cfg, aln_idx=i):
                chunk_cigars.pop(w.key, None)
            chunk_cigars[(i, 0)] = full

        out = []
        for i in range(len(items)):
            parts = []
            ci = 0
            while (i, ci) in chunk_cigars:
                parts.append(chunk_cigars[(i, ci)])
                ci += 1
            out.append("".join(parts))
        return out
