"""In-suite CLI end-to-end: cli.realign.main() on tests/data must reproduce
the reference-produced golden SAM (test/data/npore_realigned.sam) across
ALL fields — header @HD/@SQ lines, the 11 mandatory columns, and tags
(reference writer: src/bam.pyx:83, 127-145). Records compare sorted because
the reference's imap_unordered appends in completion order and its golden
was coordinate-sorted downstream (SURVEY.md §2.4 note)."""
import os

import pytest

from npore_tpu.cli.realign import main


def _parse(path):
    headers, records = [], []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            (headers if line.startswith("@") else records).append(line)
    return headers, records


# both engines run the FULL CLI path: "golden" is the C++/numpy spec
# engine; "xla" is the device engine's CPU implementation (the plain-JAX
# twin of the CUDA kernel, which chip_smoke.py runs through this CLI on the
# GPU).
@pytest.mark.parametrize("engine", ["golden", "xla"])
def test_cli_realign_all_field_parity(tmp_path, data_dir, stats_dir,
                                      engine):
    pre = str(tmp_path / "out")
    rc = main(["--bam", os.path.join(data_dir, "reads.bam"),
               "--ref", os.path.join(data_dir, "ref.fasta"),
               "--out_prefix", pre, "--stats_dir", stats_dir,
               "--engine", engine])
    assert rc == 0

    got_h, got_r = _parse(pre + ".sam")
    want_h, want_r = _parse(os.path.join(data_dir, "npore_realigned.sam"))

    # header: @HD + @SQ byte-equal; @PG differs only in CL/VN by design
    assert [h for h in got_h if h.startswith(("@HD", "@SQ"))] == \
        [h for h in want_h if h.startswith(("@HD", "@SQ"))]
    assert any(h.startswith("@PG\tPN:realigner\tID:realigner")
               for h in got_h)

    def key(line):
        f = line.split("\t")
        return (f[2], int(f[3]), f[0])

    got_r.sort(key=key)
    want_r.sort(key=key)
    assert len(got_r) == len(want_r) == 10
    for g, w in zip(got_r, want_r):
        gf, wf = g.split("\t"), w.split("\t")
        # 11 mandatory fields, byte-for-byte
        assert gf[:11] == wf[:11], (gf[0], gf[:11], wf[:11])
        # tags as a set (order is writer-dependent)
        assert set(gf[11:]) == set(wf[11:]), gf[0]
