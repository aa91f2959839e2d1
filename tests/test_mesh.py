"""Multi-device mesh coverage (8 virtual CPU devices from conftest).

Two layers, matching the production paths:
  * the XLA window-DP sharded step + psum reduction (parallel/mesh.py) —
    what `__graft_entry__.dryrun_multichip` compiles;
  * the device engine's step shard_map'd over the same mesh
    (engine/device_engine.make_step(mesh=...)), asserting bit-equal output
    against the golden spec.
(Reference parallelism being replaced: src/realign.py:110-114 pool.)
"""
import jax
import numpy as np
import pytest

from npore_tpu.config import AlignConfig
from npore_tpu.constants import bases_to_int
from npore_tpu.engine.device_engine import DeviceEngine
from npore_tpu.engine.realigner import AlignItem
from npore_tpu.golden.align import align as golden_align
from npore_tpu.io.cigar import expand_cigar


def _mesh():
    from npore_tpu.parallel.mesh import make_data_mesh
    devs = jax.devices("cpu")
    assert len(devs) >= 8, "conftest must provide 8 virtual devices"
    return make_data_mesh(devs[:8])


def _cases(rng, n_cases=4):
    cases = []
    for _ in range(n_cases):
        n = int(rng.integers(80, 200))
        ref = "".join("ACGT"[i] for i in rng.integers(0, 4, n))
        # inject a repeat to exercise the np-score path
        k = int(rng.integers(0, n - 20))
        ref = ref[:k] + "A" * 7 + ref[k:]
        seq = list(ref)
        for j in range(0, len(seq), 23):
            seq[j] = "ACGT"[int(rng.integers(0, 4))]
        seq = "".join(seq)
        cases.append((ref, seq, "M" * len(ref)))
    return cases


def test_sharded_band_dp_step():
    """parallel/mesh.make_sharded_step on the 8-device mesh (the
    dryrun_multichip path) runs and reduces op counts globally."""
    import __graft_entry__ as g
    from npore_tpu.parallel.mesh import make_sharded_step, shard_batch

    cfg, batch, tables = g._example_batch(16)
    mesh = _mesh()
    step = make_sharded_step(mesh, g.R_MAX, cfg, cfg.max_n)
    sb = shard_batch(batch, mesh)
    import jax.numpy as jnp
    tables = type(tables)(*[jnp.asarray(x) for x in tables])
    typs, runs, counts = step(sb, tables)
    typs.block_until_ready()
    assert typs.shape[0] == 16
    assert int(np.asarray(counts).sum()) > 0


def test_device_engine_under_mesh(score_matrices):
    """The device step shard_map'd over the mesh is bit-equal to the
    golden spec."""
    sub_scores, np_scores, _, _ = score_matrices
    rng = np.random.default_rng(11)
    items = [AlignItem(bases_to_int(r), bases_to_int(s), c)
             for r, s, c in _cases(rng)]

    mesh = _mesh()
    eng_mesh = DeviceEngine(sub_scores, np_scores, AlignConfig(), mesh=mesh)
    got = eng_mesh.align_batch(items)
    assert eng_mesh.bail_count == 0

    for it, g in zip(items, got):
        want = golden_align(it.ref, it.seq, it.cigar, sub_scores, np_scores,
                            eng_mesh.cfg)
        assert g == want
