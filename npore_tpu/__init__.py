"""npore_tpu: n-polymer-aware nanopore read realignment on a GPU.

A ground-up reimplementation of the capabilities of nPoRe (TimD1/nPoRe) in
JAX: the banded 5-state alignment DP and its traceback run as one CUDA
kernel per window group on an NVIDIA GPU (a plain-JAX twin runs it on the
CPU), while BAM/FASTA/VCF/BED/pileup I/O is handled by a native host
runtime (no pysam / samtools / bedtools subprocesses).

Layout:
  io/        SAM/BAM/FASTA/VCF/BED codecs + pileup engine (host)
  model/     confusion matrices and score-matrix construction
  golden/    executable NumPy specification of the reference semantics
  ops/       device kernels: n-polymer scan, banded DP, traceback
  engine/    window building, batching, realignment orchestration
  parallel/  jax.sharding mesh utilities, multi-host data parallelism
  cli/       command-line entry points (realign, standardize-vcf, bed, ...)
"""

__version__ = "0.1.0"
