#!/usr/bin/env python3
"""Multi-host scaling-efficiency harness.

Launches the realign CLI as N cooperating jax.distributed processes
("hosts") on this machine, verifies the merged multi-host SAM is
record-identical to the single-host run, and reports scaling efficiency
T1 / (N * TN) of the realignment stage.

On a real cluster every host runs `python -m npore_tpu.cli.realign
--num_hosts N --host_id I --coordinator host0:port`; this harness
exercises exactly that code path (jax.distributed.initialize, region/read
sharding, cross-host barrier, deterministic SAM merge) with N processes on
this machine. By default each process runs on the CPU (gloo collectives,
engine=golden), so it runs anywhere; with --gpu each process is pinned to
its own GPU (CUDA_VISIBLE_DEVICES=i), one process per card.
(The reference has no multi-host story at all — its scaling ceiling is one
mp.Pool, src/realign.py:110-114.)

Usage:
    python scripts/multihost_scaling.py [--hosts 2 4] [--bam ...]
Prints one JSON line per host-count plus a final efficiency summary.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(argv) -> int:
    """One simulated host: run the realign CLI (its platform comes from the
    environment the parent set: NPORE_PLATFORM or CUDA_VISIBLE_DEVICES)."""
    sys.path.insert(0, REPO)
    from npore_tpu.cli.realign import main
    return main(argv)


def _run_config(n_hosts: int, args, workdir: str):
    """Run the CLI as n_hosts processes; return (merged_sam, stage_secs)."""
    pre = os.path.join(workdir, f"out_n{n_hosts}")
    port = 19300 + n_hosts
    cli = ["--bam", args.bam, "--ref", args.ref, "--stats_dir",
           args.stats_dir, "--out_prefix", pre, "--engine", args.engine]
    if args.max_reads:
        cli += ["--max_reads", str(args.max_reads)]
    # worker stdout goes to files, not pipes: hosts synchronize at a
    # cross-host barrier before exiting, so a host blocked on a full
    # pipe (>64KB of progress/warning lines) would deadlock the job
    procs = []
    logs = []
    for h in range(n_hosts):
        cmd = [sys.executable, os.path.abspath(__file__), "--worker"] + cli
        if n_hosts > 1:
            cmd += ["--num_hosts", str(n_hosts), "--host_id", str(h),
                    "--coordinator", f"localhost:{port}"]
        if args.pin_cores:
            # emulate N IDENTICAL hosts on one box: each worker gets its
            # own core slice (incl. the 1-host baseline), otherwise a
            # single XLA-threaded worker saturates every core and the
            # sweep measures oversubscription, not scaling
            lo = h * args.pin_cores
            hi = lo + args.pin_cores - 1
            if hi >= (os.cpu_count() or 1):
                raise SystemExit(
                    f"--pin_cores {args.pin_cores} x {n_hosts} hosts "
                    f"exceeds {os.cpu_count()} cores")
            cmd = ["taskset", "-c", f"{lo}-{hi}"] + cmd
        log = os.path.join(workdir, f"host{h}_of{n_hosts}.log")
        logs.append(log)
        env = dict(os.environ)
        if args.gpu:
            env["CUDA_VISIBLE_DEVICES"] = str(h)
        else:
            env["NPORE_PLATFORM"] = "cpu"
        procs.append(subprocess.Popen(
            cmd, cwd=REPO, env=env, stdout=open(log, "w"),
            stderr=subprocess.STDOUT, text=True))
    stage = 0.0
    try:
        for h, p in enumerate(procs):
            rc = p.wait(timeout=900)
            out = open(logs[h]).read()
            if rc != 0:
                sys.stderr.write(out)
                raise RuntimeError(f"host {h}/{n_hosts} exited {rc}")
            m = re.search(r"runtime: ([0-9.]+)s", out)
            if not m:
                sys.stderr.write(out)
                raise RuntimeError(f"host {h}: no runtime line")
            stage = max(stage, float(m.group(1)))  # slowest host gates
    finally:
        for p in procs:        # never leave orphaned workers behind
            if p.poll() is None:
                p.kill()
    return pre + ".sam", stage


def _records(path):
    recs = []
    for line in open(path):
        if not line.startswith("@"):
            recs.append(line.rstrip("\n"))
    f = lambda l: (l.split("\t")[2], int(l.split("\t")[3]), l.split("\t")[0])
    return sorted(recs, key=f)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        return worker(sys.argv[2:])
    ap = argparse.ArgumentParser()
    ap.add_argument("--hosts", type=int, nargs="+", default=[2])
    ap.add_argument("--bam", default=os.path.join(REPO, "tests/data/reads.bam"))
    ap.add_argument("--ref", default=os.path.join(REPO, "tests/data/ref.fasta"))
    ap.add_argument("--stats_dir", default=os.path.join(REPO, "guppy5_stats"))
    ap.add_argument("--engine", default=None, help="single engine (legacy)")
    ap.add_argument("--engines", nargs="+", default=["golden"],
                    help="engines to sweep; 'auto' runs the device engine "
                         "(the CUDA kernel with --gpu, else the CPU twin)")
    ap.add_argument("--max_reads", type=int, default=0)
    ap.add_argument("--pin_cores", type=int, default=0,
                    help="cores per simulated host (taskset); makes the "
                         "per-host hardware equal across configs, incl. "
                         "the 1-host baseline")
    ap.add_argument("--gpu", action="store_true",
                    help="pin each process to its own GPU instead of the "
                         "CPU")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args()
    engines = [args.engine] if args.engine else args.engines

    workdir = args.workdir or tempfile.mkdtemp(prefix="npore_mh_")
    ok = True
    for engine in engines:
        args.engine = engine
        base_sam, t1 = _run_config(1, args, workdir)
        base = _records(base_sam)
        print(json.dumps({"engine": engine, "hosts": 1,
                          "stage_secs": round(t1, 3), "reads": len(base)}))
        for n in args.hosts:
            sam, tn = _run_config(n, args, workdir)
            recs = _records(sam)
            match = recs == base
            ok &= match
            eff = t1 / (n * tn) if tn else 0.0
            print(json.dumps({"engine": engine, "hosts": n,
                              "stage_secs": round(tn, 3),
                              "reads": len(recs),
                              "records_match_1host": match,
                              "scaling_efficiency": round(eff, 3)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
