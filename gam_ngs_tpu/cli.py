"""`gam` command-line interface.

Subcommands mirror the reference binaries and their flags:
  gam create  — gam-create (/root/reference/src/OptionsCreate.cc:46-73)
  gam merge   — gam-merge  (/root/reference/src/OptionsMerge.cc:47-82)
  gam n50     — gam-n50    (/root/reference/src/n50.cc)

Defaults follow the reference: min-block-size 50 for create, 5 for merge
(OptionsMerge.cc:230); coverage filter 0.75; output prefix "out".
"""

from __future__ import annotations

import argparse
import sys


def _add_create(sub):
    p = sub.add_parser("create", help="build blocks from two alignments")
    p.add_argument("--master-bam", required=True,
                   help="coordinate-sorted PE alignments of the master assembly (BAM-list file)")
    p.add_argument("--slave-bam", required=True,
                   help="coordinate-sorted PE alignments of the slave assembly (BAM-list file)")
    p.add_argument("--min-block-size", type=int, default=50,
                   help="minimum number of reads needed to build a block [default=50]")
    p.add_argument("--no-mult-filter", action="store_true",
                   help="process all reads as if uniquely mapped")
    p.add_argument("--output", default="out", help="output-file's prefix")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", choices=["auto", "tpu", "native", "oracle"],
                   default="auto",
                   help="block-construction engine: 'tpu' = JAX "
                        "sort/join on the default JAX device "
                        "(ops/device_join.py), 'native' = C++ scan, "
                        "'oracle' = exact Python scan, 'auto' = native "
                        "if built else the JAX join")
    _add_dist(p)
    return p


def _add_dist(p):
    g = p.add_argument_group("multi-host (jax.distributed)")
    g.add_argument("--coordinator", default="",
                   help="coordinator address host:port; enables multi-"
                        "process mode (every process runs the same "
                        "command, host 0 writes the outputs)")
    g.add_argument("--num-processes", type=int, default=None)
    g.add_argument("--process-id", type=int, default=None)


def _add_merge(sub):
    p = sub.add_parser("merge", help="merge two assemblies given blocks")
    p.add_argument("--master-bam", required=True)
    p.add_argument("--slave-bam", required=True)
    p.add_argument("--master-mp-bam", default="")
    p.add_argument("--slave-mp-bam", default="")
    p.add_argument("--blocks-file", required=True)
    p.add_argument("--master-fasta", required=True)
    p.add_argument("--slave-fasta", required=True)
    p.add_argument("--min-block-size", type=int, default=5)
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--coverage-filter", type=float, default=0.75)
    p.add_argument("--no-mult-filter", action="store_true")
    p.add_argument("--output-graphs", action="store_true")
    p.add_argument("--output", default="out")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", choices=["auto", "gpu", "cpu", "oracle"],
                   default="auto",
                   help="banded-SW engine: 'gpu' = the CUDA kernel (fails "
                        "without a GPU), 'cpu' = the XLA forward on the "
                        "CPU, 'auto' = the CUDA kernel on a GPU else the "
                        "XLA forward, 'oracle' = the exact host oracle")
    p.add_argument("--checkpoint", action="store_true",
                   help="partition-level resume via <output>.ckpt/")
    _add_dist(p)
    return p


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="gam",
        description="GPU-accelerated genomic assemblies merger (GAM-NGS "
                    "capabilities)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_create(sub)
    _add_merge(sub)
    p50 = sub.add_parser("n50", help="FASTA N50/L50 statistics")
    p50.add_argument("fasta")
    pidx = sub.add_parser(
        "index", help="build <bam>.gidx contig-offset indexes so "
                      "multi-host create decodes only its shard")
    pidx.add_argument("bams", nargs="+",
                      help="BAM files or bam-list files")

    args = ap.parse_args(argv)
    if getattr(args, "device", "") == "cpu":
        import jax

        # before any backend exists: the CPU platform, not just XLA:CPU
        jax.config.update("jax_platforms", "cpu")

    if getattr(args, "coordinator", ""):
        from .parallel.distributed import init_distributed

        pid, n = init_distributed(args.coordinator, args.num_processes,
                                  args.process_id)
        print(f"[main] jax.distributed initialized: process {pid}/{n}")
    if args.cmd in ("create", "merge"):
        # after jax.distributed: it must precede the first backend
        from .ops.bsw_batch import enable_compilation_cache

        enable_compilation_cache()

    if args.cmd == "create":
        from .models.create import CreateOptions, run_create
        if args.min_block_size < 1:
            print("WARNING: min-block-size is less than 1", file=sys.stderr)
        run_create(CreateOptions(
            master_bam_file=args.master_bam,
            slave_bam_file=args.slave_bam,
            min_block_size=args.min_block_size,
            no_multiplicity_filter=args.no_mult_filter,
            output_file_prefix=args.output,
            debug=args.debug,
            engine=args.device,
        ))
        from .utils.misc import max_rss_line
        print(max_rss_line("[gam-create]"))  # src/gam-create.cc:64
        return 0

    if args.cmd == "merge":
        from .models.merge import MergeOptions, run_merge
        engine = None
        if args.device != "oracle":
            import jax

            from .ops.bsw_batch import BswEngine

            if args.device == "gpu" and jax.default_backend() != "gpu":
                print(f"[error] --device gpu: no GPU (JAX backend is "
                      f"{jax.default_backend()!r})", file=sys.stderr)
                return 1
            backend = {"auto": "auto", "gpu": "cuda",
                       "cpu": "xla"}[args.device]
            mesh = None
            # multi-process runs shard by graph partition, each host
            # aligning its own batches: the engine mesh must be LOCAL
            # (a global mesh would need lockstep calls across hosts)
            if jax.process_count() == 1 and len(jax.devices()) > 1:
                from .parallel import device_mesh

                mesh = device_mesh()
            engine = BswEngine(backend=backend, mesh=mesh)
        run_merge(MergeOptions(
            master_bam_file=args.master_bam,
            slave_bam_file=args.slave_bam,
            master_mp_bam_file=args.master_mp_bam,
            slave_mp_bam_file=args.slave_mp_bam,
            blocks_file=args.blocks_file,
            master_fasta_file=args.master_fasta,
            slave_fasta_file=args.slave_fasta,
            min_block_size=args.min_block_size,
            threads_num=args.threads,
            coverage_threshold=args.coverage_filter,
            no_multiplicity_filter=args.no_mult_filter,
            output_file_prefix=args.output,
            output_graphs=args.output_graphs,
            debug=args.debug,
            engine=engine,
            checkpoint=args.checkpoint,
            batched_weights=(args.device != "oracle"),
        ))
        from .utils.misc import max_rss_line
        print(max_rss_line("[main]"))  # src/gam-merge.cc:64
        return 0

    if args.cmd == "n50":
        from .models.n50 import run_n50
        run_n50(args.fasta)
        return 0

    if args.cmd == "index":
        from .io import bamlist
        from .native.bamdecode import available, build_index
        if not available():
            print("[error] native gamio library unavailable; "
                  "gam index requires it", file=sys.stderr)
            return 1
        paths = []
        for p in args.bams:
            if p.endswith(".bam"):
                paths.append(p)
            else:  # bam-list file
                names, _, _ = bamlist.load_bam_file_names(p)
                paths.extend(names)
        rc = 0
        for p in paths:
            # build_index returns False when the native lib bails, and
            # the native writer silently skips the write on fopen/rename
            # failure — verify the artifact actually exists before
            # claiming success.
            ok = build_index(p)
            import os as _os
            if ok and _os.path.exists(p + ".gidx"):
                print(f"[index] wrote {p}.gidx")
            else:
                print(f"[error] failed to write {p}.gidx", file=sys.stderr)
                rc = 1
        return rc

    return 1


if __name__ == "__main__":
    sys.exit(main())
