"""gam_ngs_tpu — a GPU-accelerated genome-assembly reconciliation engine.

A from-scratch reimplementation of the capabilities of GAM-NGS
(vice87/gam-ngs): merging two assemblies (master + slave) of the same
organism using read alignments as evidence.  The compute-heavy paths
(banded Smith-Waterman, read-table joins, region scoring) run as JAX
programs on the GPU, the banded-SW forward as a CUDA kernel
(ops/bsw_cuda.cu); the streaming I/O plane is native host code.

Layout:
  io/        file-format codecs (FASTA, BGZF/BAM, .blocks, .isize, ...)
  core/      columnar data model, library stats, block construction
  ops/       device kernels (banded SW, seed finder) + oracles
  graphs/    contig-pair / strand / assembly / compact block graphs
  merge/     fork solving, merge paths, contig weaving
  models/    end-to-end pipelines (create, merge, n50)
  parallel/  device mesh + sharded batch dispatch
  utils/     C++-compatible formatting, logging, timers
"""

__version__ = "0.1.0"
