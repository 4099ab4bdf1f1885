"""gam create — block construction pipeline.

Reference driver: CreateBlocks::execute (/root/reference/src/CreateBlocks.cc:63).
Produces <prefix>.blocks, <master-list>.isize and <slave-list>.isize with
reference-identical contents.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

from ..core import blocks as blocks_mod
from ..core.multibam import MultiBam
from ..io import blocks_io
from ..utils.metrics import Metrics
from ..utils.misc import format_time, path_basename


@dataclass
class CreateOptions:
    master_bam_file: str = ""
    slave_bam_file: str = ""
    min_block_size: int = 50
    no_multiplicity_filter: bool = False
    output_file_prefix: str = "out"
    debug: bool = False
    # block-construction engine: "auto" (native if built, else the JAX
    # join), "native" (C++ scan), "tpu" (JAX join on the default device,
    # ops/device_join.py; renamed in ROADMAP D7), "oracle" (exact
    # Python scan)
    engine: str = "auto"


def run_create(opts: CreateOptions, log=print):
    t1 = time.time()
    metrics = Metrics()

    from ..parallel.distributed import proc_info

    pid, nproc = proc_info()
    if nproc > 1:
        log(f"[main] distributed create: process {pid}/{nproc}")

    if opts.no_multiplicity_filter:
        log("[main] option --noMultiplicityFilter provided; reads will be "
            "processed as if they had unique mapping")

    log("[main] opening BAM files")
    master = MultiBam.open(opts.master_bam_file)

    from ..native import native_available

    engine = opts.engine
    if engine == "auto":
        use_native = native_available() and not os.environ.get("GAM_NO_NATIVE")
        engine = "native" if use_native else "tpu"
    if nproc > 1:
        engine = "dist"  # sharded device join is the only multi-host path

    log("[main] loading reads in memory")
    with metrics.phase("load_reads"):
        if engine == "dist":
            from ..parallel.create_dist import distributed_coverage_vectors

            master_cov = distributed_coverage_vectors(
                master, opts.no_multiplicity_filter, pid, nproc)
        else:
            master_cov = blocks_mod.coverage_vectors(
                master, opts.no_multiplicity_filter)
        if engine == "oracle":
            map1, map2 = blocks_mod.load_reads_map(
                master, opts.no_multiplicity_filter)

    # stats through the GetNextAlignment(update_stats=true) path
    if engine == "dist":
        from ..parallel.create_dist import distributed_library_stats

        distributed_library_stats(master, True, pid, nproc)
    else:
        master.compute_statistics(require_paired_flag=True)
    if pid == 0:
        master.write_stats_to_file(opts.master_bam_file + ".isize")

    log(f"[main] reads loaded in {format_time(time.time() - t1)}")
    log("[main] finding blocks")

    if engine == "dist":
        # range-decode only this host's slave contig shard: with a
        # .gidx index the streaming decoder inflates just that slice
        # (header lengths are the shard weights so every host derives
        # identical ranges without decoding anything first)
        import numpy as np

        from ..io import bamlist
        from ..io.bam import read_bam_header
        from ..parallel.create_dist import shard_ranges_by_weight

        s_paths, _, _ = bamlist.load_bam_file_names(opts.slave_bam_file)
        hdr = read_bam_header(s_paths[0])
        s_ranges = shard_ranges_by_weight(
            np.asarray(hdr.ref_lengths, np.int64) + 1, nproc)
        slave = MultiBam.open(opts.slave_bam_file,
                              ref_range=s_ranges[pid])
    else:
        slave = MultiBam.open(opts.slave_bam_file)
    with metrics.phase("find_blocks"):
        if engine == "dist":
            from ..parallel.create_dist import (
                distributed_coverage_vectors,
                distributed_find_blocks,
            )

            slave_cov = distributed_coverage_vectors(
                slave, opts.no_multiplicity_filter, pid, nproc,
                ranges=s_ranges)
            m_cols = blocks_mod.stream_columns(
                master, opts.no_multiplicity_filter)
            s_cols = blocks_mod.stream_columns(
                slave, opts.no_multiplicity_filter)
            cols = distributed_find_blocks(
                m_cols, s_cols, opts.min_block_size, pid, nproc,
                ctg_ranges=s_ranges, s_local=True)
            blocks = blocks_mod.block_table_from_columns(cols)
        else:
            slave_cov = blocks_mod.coverage_vectors(
                slave, opts.no_multiplicity_filter)
            if engine == "native":
                blocks = blocks_mod.find_blocks_fast(
                    master, slave, opts.min_block_size,
                    opts.no_multiplicity_filter)
            elif engine == "tpu":
                blocks = blocks_mod.find_blocks_device_path(
                    master, slave, opts.min_block_size,
                    opts.no_multiplicity_filter)
            else:
                blocks = blocks_mod.find_blocks(
                    slave, opts.min_block_size, map1, map2,
                    opts.no_multiplicity_filter)
        blocks_mod.update_coverages(blocks, master_cov, slave_cov)
    metrics.count("blocks", len(blocks))

    if engine == "dist":
        from ..parallel.create_dist import distributed_library_stats

        distributed_library_stats(slave, True, pid, nproc,
                                  rows_are_local=True)
    else:
        slave.compute_statistics(require_paired_flag=True)
    if pid == 0:
        slave.write_stats_to_file(opts.slave_bam_file + ".isize")

    log(f"[main] blocks found = {len(blocks)}")
    if pid == 0:
        log(f"[main] writing blocks on file: "
            f"{path_basename(opts.output_file_prefix)}")
        blocks_io.write_blocks(opts.output_file_prefix + ".blocks", blocks)

        if opts.debug:
            _write_blocks_verbose(
                opts.output_file_prefix + ".blocks.verbose.txt", blocks,
                master.ref_names, slave.ref_names)

        metrics.write(opts.output_file_prefix + ".metrics.json")
    if nproc > 1:
        # Trailing barrier: without it nothing stops a non-writer host
        # from racing ahead into `gam merge` (load_blocks) before host 0
        # has durably written .blocks/.isize.  One tiny allgather after
        # the writes makes the inter-phase checkpoint contract
        # (Block.cc:732 -> Merge.cc:110) hold across hosts.
        from ..parallel.distributed import allgather_obj

        allgather_obj(("create_done", pid))
    log(f"[main] total execution time = {format_time(time.time() - t1)}")
    return blocks


def _write_blocks_verbose(path, blocks, master_names, slave_names):
    """Block::writeBlocksVerbose (Block.cc:749)."""
    with open(path, "w") as fh:
        fh.write("# This file should NOT be used as input for gam-merge "
                 "command. It is only provided to easily look how blocks "
                 "have been built.\n")
        fh.write(blocks_io.HEADER)
        for i in range(len(blocks)):
            r = blocks.row(i)
            reads_len = (r[5] + r[11]) // 2  # Block::getReadsLen
            fh.write(
                f"{r[0]}\t{master_names[r[1]]}\t{chr(r[2])}\t{r[3]}\t{r[4]}\t{reads_len}"
                f"\t{slave_names[r[7]]}\t{chr(r[8])}\t{r[9]}\t{r[10]}\t{reads_len}\n"
            )
