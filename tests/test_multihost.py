"""True multi-process jax.distributed run: two "hosts" (subprocesses with
CPU devices + gloo collectives) realign disjoint read stripes of the
fixture BAM via cli.realign --num_hosts/--host_id/--coordinator, barrier,
and host 0 merges — merged records must equal the single-host run, which
itself equals the reference golden (tests/test_cli_realign.py).

This exercises the exact code path a multi-host cluster uses
(parallel/distributed: init_distributed, stripe_reads/shard_regions,
barrier, merge_host_sams); only the device platform and collectives
transport differ. (Reference has
no multi-host story — src/realign.py:110-114 is single-host mp.Pool.)
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_host_realign_matches_single_host():
    cmd = [sys.executable, os.path.join(REPO, "scripts/multihost_scaling.py"),
           "--hosts", "2"]
    env = dict(os.environ)
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    rows = [json.loads(l) for l in out.stdout.strip().splitlines()]
    assert rows[0]["hosts"] == 1 and rows[0]["reads"] == 10
    two = rows[1]
    assert two["hosts"] == 2
    assert two["reads"] == 10
    assert two["records_match_1host"] is True
    assert two["scaling_efficiency"] > 0


@pytest.mark.slow   # 75s; the golden-engine 2-host case above is the
# fast representative of the multi-host path
def test_two_host_realign_device_engine():
    """The device engine (the plain-JAX twin on the CPU) under real
    jax.distributed 2-host sharding: merged records must equal its own
    single-host run (which tests/test_cli_realign.py pins to golden)."""
    cmd = [sys.executable, os.path.join(REPO, "scripts/multihost_scaling.py"),
           "--hosts", "2", "--engines", "auto"]
    out = subprocess.run(cmd, cwd=REPO, env=dict(os.environ),
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stdout + out.stderr
    rows = [json.loads(l) for l in out.stdout.strip().splitlines()]
    assert rows[0] == {"engine": "auto", "hosts": 1,
                       "stage_secs": rows[0]["stage_secs"], "reads": 10}
    two = rows[1]
    assert two["engine"] == "auto" and two["hosts"] == 2
    assert two["reads"] == 10
    assert two["records_match_1host"] is True
