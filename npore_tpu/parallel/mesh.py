"""Multi-chip data parallelism for the realignment engine.

The reference parallelises with a single-host ``multiprocessing.Pool`` over
reads (reference: src/realign.py:110-114) and reduces confusion-matrix
counts with ``np.sum`` on the host (reference: src/bam.pyx:183-192). The
device mapping is a 1-D device mesh:

* window batches are sharded over the ``data`` mesh axis with ``shard_map``
  (each device runs the identical banded-DP step on its shard);
* confusion-count accumulation — the framework's "training" reduction — is a
  ``psum`` over the same axis, over NVLink (NCCL) on GPUs instead of host
  memory. The cards of one host are joined all to all, so the mesh
  follows the algorithm alone;
* score tables (≈245 KB) are replicated, the batch is sharded.

TP / PP / EP do not apply: the model has no weight matrices to shard, no
layer pipeline, and no experts (SURVEY.md §2.4). Sequence parallelism
appears as window *chunking* instead (ops/band_dp.py): long alignments are
split into independent anti-diagonal chunks that mix freely into the same
data-parallel batches, so one 60 Mbp contig fans out across all chips.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import AlignConfig
from ..ops.band_dp import Tables, make_window_dp


def make_data_mesh(devices=None) -> Mesh:
    """1-D ``data`` mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), axis_names=("data",))


def shard_batch(batch: Dict[str, np.ndarray], mesh: Mesh) -> Dict[str, jax.Array]:
    """Place a packed window batch with axis 0 sharded over ``data``.

    The batch size must be divisible by the mesh size; ``Realigner`` pads
    batches with trivial windows to guarantee this.
    """
    out = {}
    for k, v in batch.items():
        spec = P("data") if v.ndim >= 1 else P()
        out[k] = jax.device_put(v, NamedSharding(mesh, spec))
    return out


def make_sharded_step(mesh: Mesh, R_max: int, cfg: AlignConfig,
                      max_n: int = 6):
    """Jitted multi-chip step: sharded window DP + psum'd edit-op counts.

    Returns ``fn(batch, tables) -> (typs, runs, op_counts)`` where
    ``typs``/``runs`` stay sharded over ``data`` (consumed shard-wise by the
    host traceback) and ``op_counts`` is the globally-reduced histogram of
    MAT-plane op types — the on-device analog of the reference's host-side
    ``np.sum`` confusion reduction (src/bam.pyx:188-192).
    """
    shard_map = jax.shard_map

    dp = make_window_dp(R_max, cfg, max_n, jit=False)

    def local_step(batch, tables):
        typs, runs = dp(batch, tables)
        # per-shard histogram of op types, reduced globally over ICI
        counts = jnp.zeros((5,), jnp.int32)
        live = runs > 0
        for t in range(5):
            counts = counts.at[t].set(jnp.sum((typs == t) & live,
                                              dtype=jnp.int32))
        counts = jax.lax.psum(counts, "data")
        return typs, runs, counts

    batch_specs = {
        "seqbuf": P("data", None), "refbuf": P("data", None),
        "l_seq": P("data", None, None), "lidx_seq": P("data", None, None),
        "l_ref": P("data", None, None), "lidx_ref": P("data", None, None),
        "len_start": P("data", None, None), "shr_start": P("data", None, None),
        "inss": P("data", None), "b_rows": P("data"), "n_ins": P("data"),
        "n_del": P("data"), "ref_guard": P("data"), "seq_guard": P("data"),
    }
    tab_specs = Tables(sub_flat=P(None), cont=P(None))
    out_specs = (P("data", None, None), P("data", None, None), P(None))

    fn = shard_map(local_step, mesh=mesh,
                   in_specs=(batch_specs, tab_specs),
                   out_specs=out_specs, check_vma=False)
    return jax.jit(fn)


def reduce_confusion_matrices(mesh: Mesh, subs, nps, inss, dels):
    """psum the per-shard confusion counts over the ``data`` axis.

    Inputs are stacked per-shard partials with leading dim == mesh size
    (each host/device contributed the counts of its region shard,
    engine/stats.calc_confusion_matrices_bam). Returns the global totals —
    the ICI-collective form of the reference's host-side
    ``np.sum(results)`` over pool workers (src/bam.pyx:183-192)."""
    shard_map = jax.shard_map

    def local(su, np_, in_, de):
        # each shard holds (1, ...); drop the shard dim and reduce
        out = []
        for x in (su, np_, in_, de):
            out.append(jax.lax.psum(x[0], "data"))
        return tuple(out)

    n = mesh.size
    args = []
    for x in (subs, nps, inss, dels):
        x = np.asarray(x)
        assert x.shape[0] == n, f"need {n} shards, got {x.shape[0]}"
        args.append(x.astype(np.int32))
    in_specs = tuple(P(*(("data",) + (None,) * (a.ndim - 1))) for a in args)
    out_specs = tuple(P(*((None,) * (a.ndim - 1))) for a in args)
    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=in_specs,
                           out_specs=out_specs, check_vma=False))
    su, np_, in_, de = fn(*args)
    return (np.asarray(su, np.int64), np.asarray(np_, np.int64),
            np.asarray(in_, np.int64), np.asarray(de, np.int64))
