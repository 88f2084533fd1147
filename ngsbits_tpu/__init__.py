"""ngsbits_tpu — an accelerator-backed NGS QC/processing framework.

A from-scratch reimplementation of the capabilities of imgag/ngs-bits,
designed around batched device compute:

- Host side: streaming decoders (gzip FASTQ, BGZF BAM/VCF) that turn
  sequencing records into fixed-width int8/uint8 tensors.
- Device side: JAX/XLA computations for the inner loops: per-cycle
  base/quality accumulation, adapter-overlap scanning, coverage
  accumulation, pileups, genotype correlations.
- Multi-device: data-parallel sharding of record batches over a
  `jax.sharding.Mesh` with psum merges of the (small) accumulator states.

Layout:
  core/      domain substrate: intervals, histogram, stats, qcML writer
  io/        FASTQ/BAM/VCF/BED/FASTA readers and writers (host)
  ops/       device compute (jit) for the hot loops
  parallel/  mesh construction + sharded accumulation helpers
  tools/     CLI tools mirroring the ngs-bits tool surface
"""

__version__ = "0.1.0"
APP_NAME = "ngsbits-tpu"
