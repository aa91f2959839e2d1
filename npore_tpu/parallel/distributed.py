"""Multi-host execution scaffolding.

The reference parallelizes within one host via ``mp.Pool`` (reference:
src/realign.py:110-114); scaling past one host is out of its scope. The
device mapping is the standard JAX multi-controller form:

* every host runs the same CLI with ``--num_hosts/--host_id/--coordinator``;
* ``init_distributed`` wires ``jax.distributed.initialize`` so all hosts
  join one runtime (cross-process collectives become available: NCCL
  between GPUs, gloo between CPU processes);
* work is sharded deterministically by region (``shard_regions``) — BAM
  reads partition by coordinate ranges, so hosts never exchange reads;
* confusion-count training reduces with an all-reduce over hosts
  (``allreduce_counts``: psum across the global device mesh, the
  cross-host form of parallel/mesh.reduce_confusion_matrices);
* each host writes ``{out_prefix}.h{i}.sam``; after a global barrier,
  host 0 merges them coordinate-sorted (``merge_host_sams``) — the
  deterministic replacement for the reference's completion-order appends.

Single-host runs take none of these paths (``num_hosts == 1`` is a no-op
wrapper), so the CLI behaves identically to round-1 by default.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple


def init_distributed(coordinator: Optional[str] = None,
                     num_hosts: int = 1,
                     host_id: Optional[int] = None) -> Tuple[int, int]:
    """Join the multi-controller runtime; returns (host_id, num_hosts).

    No-op for ``num_hosts == 1``. Environment fallbacks follow JAX
    conventions (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID) so cluster launchers can omit the flags."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_hosts == 1 and os.environ.get("JAX_NUM_PROCESSES"):
        num_hosts = int(os.environ["JAX_NUM_PROCESSES"])
    if host_id is None:
        host_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if num_hosts <= 1:
        return 0, 1
    if coordinator is None:
        raise ValueError("--coordinator (or JAX_COORDINATOR_ADDRESS) is "
                         "required for multi-host runs")
    import jax
    # CPU backends need an explicit cross-process collectives transport;
    # gloo is the one shipped with jax. The flag only affects the CPU
    # backend (GPU processes use NCCL), so it is set unconditionally and
    # a default-platform CPU host still gets working collectives.
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_hosts,
                               process_id=host_id)
    # Warm the collective context NOW, while every host is still at the
    # same program point: gloo builds its mesh lazily at the FIRST
    # collective with a ~30s key-exchange deadline, and the first
    # collective otherwise happens after minutes of per-host kernel
    # compilation that drifts hosts apart (a 4-host CPU run had hosts 2/3
    # still compiling -> "Gloo context initialization failed:
    # DEADLINE_EXCEEDED" on host 0).
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices("npore_init")
    return jax.process_index(), jax.process_count()


def shard_regions(regions: Sequence[Tuple[str, int, int]], num_hosts: int,
                  host_id: int) -> List[Tuple[str, int, int]]:
    """Deterministic round-robin region shard for one host.

    Regions are already chunked (engine/regions.get_bam_regions), so a
    round-robin over the sorted list load-balances long contigs across
    hosts without communication."""
    ordered = sorted(regions)
    return [r for i, r in enumerate(ordered) if i % num_hosts == host_id]


def stripe_reads(reads, num_hosts: int, host_id: int):
    """Deterministic read-level round-robin shard.

    Fallback for when hosts outnumber regions (e.g. one contig, N hosts):
    every host streams the same region list — reads arrive in the same
    deterministic coordinate order on all hosts — and keeps every
    ``num_hosts``-th read. Duplicate-free by construction; decode cost is
    replicated, so region sharding is preferred whenever regions >= hosts."""
    for i, r in enumerate(reads):
        if i % num_hosts == host_id:
            yield r


def barrier(name: str = "npore") -> None:
    """Global cross-host barrier (no-op single-process)."""
    import jax
    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices(name)


def allreduce_counts(counts):
    """Sum count tensors across hosts (identity single-process).

    Uses a psum over the global ``data`` mesh of all devices, so the
    reduction rides ICI/DCN instead of a host gather."""
    import jax
    if jax.process_count() == 1:
        return counts
    from jax.experimental import multihost_utils
    return [multihost_utils.process_allgather(c).sum(axis=0)
            for c in counts]


def host_out_path(out_prefix: str, host_id: int, num_hosts: int) -> str:
    if num_hosts == 1:
        return f"{out_prefix}.sam"
    return f"{out_prefix}.h{host_id}.sam"


def merge_host_sams(out_prefix: str, num_hosts: int) -> str:
    """Merge per-host SAMs into one coordinate-sorted SAM (host 0 only).

    Headers must be identical across shards (same input BAM); records are
    merged by (rname order of first header's @SQ, pos, qname) so output is
    deterministic regardless of host count."""
    parts = [host_out_path(out_prefix, i, num_hosts)
             for i in range(num_hosts)]
    headers: List[str] = []
    sq_order = {}
    records = []
    for p in parts:
        with open(p) as fh:
            for line in fh:
                line = line.rstrip("\n")
                if line.startswith("@"):
                    if not headers or line not in headers:
                        if p == parts[0]:
                            headers.append(line)
                            if line.startswith("@SQ"):
                                sn = dict(x.split(":", 1)
                                          for x in line.split("\t")[1:])["SN"]
                                sq_order[sn] = len(sq_order)
                else:
                    f = line.split("\t")
                    records.append(
                        (sq_order.get(f[2], 1 << 30), int(f[3]), f[0], line))
    records.sort()
    out = f"{out_prefix}.sam"
    with open(out, "w") as fh:
        for h in headers:
            fh.write(h + "\n")
        for _, _, _, line in records:
            fh.write(line + "\n")
    return out
