"""Explicit, hashable configuration for the realignment engine.

Replaces the reference's mutable global argparse namespace (`cfg.args`,
reference: src/cfg.py:4-5) with a frozen dataclass so that configs can be
passed through jit boundaries, hashed for kernel-cache keys, and shipped to
worker hosts without fork-inheritance tricks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def apply_platform_env() -> None:
    """Honor ``NPORE_PLATFORM`` (e.g. ``cpu``) at CLI startup.

    Lets a caller pin the CLIs' JAX platform (shell-pipeline tests pin the
    CPU) without exporting JAX_PLATFORMS to every tool the pipeline runs."""
    import os
    plat = os.environ.get("NPORE_PLATFORM")
    if plat:
        import jax
        jax.config.update("jax_platforms", plat)


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """Parameters of the banded n-polymer DP (reference: src/aln.pyx:379-382)."""
    max_n: int = 6            # max n-polymer period (src/realign.py:47-49)
    max_l: int = 100          # max repeat-unit count (src/realign.py:50-52)
    r: int = 30               # band half-width -> band of 2r+1 cells
    max_b_rows: int = 20000   # anti-diagonal chunk size
    indel_start: float = 5.0
    indel_extend: float = 1.0
    inf: float = 100.0        # per-step penalty ceiling (src/aln.pyx:426-428)

    @property
    def band_width(self) -> int:
        return 2 * self.r + 1


@dataclasses.dataclass(frozen=True)
class RealignConfig:
    """End-to-end realignment run configuration (reference: src/realign.py:15-71)."""
    bam: str = ""
    ref: str = ""
    out_prefix: str = ""
    stats_dir: str = "./stats"
    contig: Optional[str] = None
    contig_beg: Optional[int] = None
    contig_end: Optional[int] = None
    contigs: Optional[str] = None
    bed: Optional[str] = None
    max_reads: int = 0
    chunk_width: int = 100000
    recalc_cms: bool = False
    recalc_exit: bool = False
    plot: bool = False
    align: AlignConfig = dataclasses.field(default_factory=AlignConfig)

    # engine knobs (new; no reference equivalent)
    batch_reads: int = 128       # reads per device batch
    engine: str = "auto"         # 'auto' | 'cuda' | 'xla' | 'golden'
    min_bq: int = 13             # pileup min base quality (samtools default)


DEFAULT_ALIGN = AlignConfig()
