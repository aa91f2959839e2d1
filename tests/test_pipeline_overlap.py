"""realign_records must overlap device compute with host post-processing
(the round-2 e2e finding: 596us/read was exactly device + serialized host).
A fake engine with a background 'device' thread pins the property: with
B batches of device time D and host emit time H, a pipelined run takes
~B*D + H, a serialized one ~B*(D+H)."""
import time

from npore_tpu.engine.realigner import Realigner
from npore_tpu.io.sam import SamRecord


DEVICE_S = 0.12
HOST_S = 0.06
BATCHES = 4
READS_PER_BATCH = 8


class FakeDevice:
    """align_batch_async starts 'device work' immediately on a thread;
    collect() joins it — the contract DeviceEngine implements."""

    def __init__(self):
        self.bail_count = 0

    def align_batch_async(self, items):
        import threading
        done = threading.Event()

        def work():
            time.sleep(DEVICE_S)
            done.set()
        threading.Thread(target=work, daemon=True).start()

        def collect():
            done.wait()
            return ["M" * 4] * len(items)
        return collect


class SlowEmitRealigner(Realigner):
    # _finalize_records is the host finalize/SAM-assembly hook the
    # pipeline drives (on the MAIN thread since round 4, overlapping
    # stage B's collect of the next batch)
    def _finalize_records(self, meta, cigs):
        time.sleep(HOST_S)      # simulated finalize/SAM-assembly cost
        for (read, *_), c in zip(meta, cigs):
            yield read


def _reads(n):
    return [SamRecord(qname=f"r{i}", flag=0, rname="c", pos=1, mapq=60,
                      cigar="4M", rnext="*", pnext=0, tlen=4, seq="ACGT",
                      qual="IIII", tags={}) for i in range(n)]


class SlowSubmitDevice(FakeDevice):
    """Simulates window-building cost inside align_batch_async (stage A)."""

    def align_batch_async(self, items):
        time.sleep(HOST_S)
        return super().align_batch_async(items)


def test_submit_and_emit_overlap_device():
    """With submit cost S and emit cost H per batch, the 3-stage pipeline
    hides both behind device time: ~S + B*D + H, not B*(S+D+H)."""
    rl = SlowEmitRealigner.__new__(SlowEmitRealigner)
    rl.engine = "xla"
    rl._device = SlowSubmitDevice()
    rl.skipped = []
    rl.errors = []

    reads = _reads(BATCHES * READS_PER_BATCH)
    for r in reads:
        r.aln = ((b"", b"", "4M"))

    t0 = time.perf_counter()
    out = list(rl.realign_records(iter(reads), batch_size=READS_PER_BATCH))
    dt = time.perf_counter() - t0
    assert len(out) == len(reads)

    serial = BATCHES * (2 * HOST_S + DEVICE_S)
    # strictly better than serializing either host stage with the device
    assert dt < BATCHES * (DEVICE_S + HOST_S), (dt, serial)


def test_emit_overlaps_device():
    rl = SlowEmitRealigner.__new__(SlowEmitRealigner)
    rl.engine = "xla"
    rl._device = FakeDevice()
    rl.skipped = []
    rl.errors = []

    # route reads through the non-native prep path (no .aln attribute);
    # give records enough shape for _prep_batch
    reads = _reads(BATCHES * READS_PER_BATCH)
    for r in reads:
        r.aln = ((b"", b"", "4M"))      # native fast path: skip MD parse

    t0 = time.perf_counter()
    out = list(rl.realign_records(iter(reads), batch_size=READS_PER_BATCH))
    dt = time.perf_counter() - t0
    assert len(out) == len(reads)

    serial = BATCHES * (DEVICE_S + HOST_S)
    pipelined = BATCHES * DEVICE_S + HOST_S
    # generous margin for slow CI, but strictly below the serialized time
    assert dt < serial - HOST_S / 2, (dt, serial, pipelined)
