"""margin_tpu: a JAX long-read phasing + polishing engine.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
UCSC-nanopore-cgl/margin (`margin phase` read haplotagging / VCF phasing and
`margin polish` haploid+diploid assembly polishing), run on an NVIDIA GPU.

Architecture:
  - Host side (numpy / C++): BAM/VCF/FASTA I/O, chunk geometry, graph surgery
    (POA augmentation, HMM tiling/merge schedules), stitching bookkeeping.
  - Device side (JAX, and Pallas on the Triton route): batched dense and
    banded 3-state pair-HMM forward / forward-backward (the allele-support
    and read-to-POA alignment engines), the read-partition
    forward-backward over het sites (bit-plane popcount emissions
    expressed as one-hot matmuls), and repeat count Bayesian inference.
  - Scale-out: genomic chunks are data-parallel shards over a
    `jax.sharding.Mesh`; chunk seams are resolved by a collective stitching
    pass (gathered read-id sets + boundary sequences).

Reference parity citations in docstrings use `file:line` into the upstream C
code (see SURVEY.md).
"""

__version__ = "0.1.0"

from margin_tpu.alphabet import Alphabet  # noqa: F401
from margin_tpu.rle import RleString  # noqa: F401
