"""Reduced-scale in-suite run of the genome-scale harness.

Exercises the multi-Mbp paths hermetically: a 2 Mbp repeat-dense contig
through realign (the device engine's CPU twin), sampled golden parity,
whole-genome chunked stats, bed generation, and a standardize_vcf slice —
asserting bounded RSS and that the bucket ladder sees multi-bucket input.
The full 5 Mbp / 2000-read run happens on the GPU via
scripts/genome_scale.py.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_genome_scale_reduced(tmp_path):
    env = dict(os.environ)
    env["NPORE_PLATFORM"] = "cpu"
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts/genome_scale.py"),
         "--mbp", "2", "--reads", "600", "--max_reads", "12",
         "--parity_sample", "6", "--std_contig", "contig2",
         "--workdir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=1500)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rows = {}
    for line in r.stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            d = json.loads(line)
            rows[d["stage"]] = d
    for stage in ("realign", "parity", "stats", "bed", "std", "summary"):
        assert stage in rows, (stage, r.stdout[-2000:])
    assert rows["parity"]["ok"] and rows["parity"]["sampled"] == 6
    assert rows["stats"]["chunks"] == 21          # 2 Mbp / 100 kb + 1
    assert rows["stats"]["subs_total"] > 0
    assert rows["bed"]["regions"]["all"] > 1000   # repeat-dense genome
    assert rows["std"]["records"] >= 1
    # bounded memory: IO streams + the largest DP transient
    assert rows["summary"]["peak_rss_mb"] < 9000
