"""Multi-host merge scaling evidence (BASELINE config 4 analogue).

Runs `gam merge` sequentially and as a REAL N-process jax.distributed
(gloo) run on the same synthetic corpus — with .gidx indexes so each
host range-decodes only the contig runs its owned graph partitions
touch — then reports per-host resident alignment rows, partition-phase
seconds, and verifies host 0's outputs are byte-identical to the
sequential run.

Usage: python bench/dist_scale.py [genome_mb] [nproc] [--json PATH]
(CPU backend; the multi-chip device path is exercised separately by
__graft_entry__.dryrun_multichip.)
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "tests"))

_DRIVER = r"""
import sys

workdir, ml, sl, mfa, sfa, blocks, coord, nproc, pid, out = sys.argv[1:11]
import jax
jax.config.update("jax_platforms", "cpu")
if coord:
    from gam_ngs_tpu.parallel.distributed import init_distributed
    init_distributed(coord, int(nproc), int(pid))
from gam_ngs_tpu.models.merge import MergeOptions, run_merge
from gam_ngs_tpu.ops.bsw_batch import BswEngine

def log(*a):
    line = " ".join(str(x) for x in a)
    if line.startswith(("[dist]", "[merge] Total")):
        print(line, flush=True)

run_merge(MergeOptions(
    master_bam_file=ml, slave_bam_file=sl, blocks_file=blocks,
    master_fasta_file=mfa, slave_fasta_file=sfa, min_block_size=10,
    output_file_prefix=out, engine=BswEngine(backend="xla")), log=log)
import resource
print("DRIVER_MAXRSS_MB",
      resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024,
      flush=True)
print("DRIVER_OK", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    genome_mb = float(args[0]) if args else 4.0
    nproc = int(args[1]) if len(args) > 1 else 2
    json_out = None
    if "--json" in sys.argv:
        json_out = sys.argv[sys.argv.index("--json") + 1]

    import jax

    jax.config.update("jax_platforms", "cpu")

    from e2e_scale import build_corpus

    from gam_ngs_tpu.models.create import CreateOptions, run_create
    from gam_ngs_tpu.models.merge import MergeOptions, run_merge
    from gam_ngs_tpu.native.bamdecode import available, build_index
    from gam_ngs_tpu.ops.bsw_batch import BswEngine

    tmp = tempfile.mkdtemp()
    c = build_corpus(genome_mb, tmp, break_every=4)
    if available():  # .gidx -> hosts inflate only their contig shards
        build_index(c["mp"])
        build_index(c["sp"])

    run_create(CreateOptions(
        master_bam_file=c["ml"], slave_bam_file=c["sl"],
        min_block_size=10, output_file_prefix=f"{tmp}/out"),
        log=lambda *_: None)

    t0 = time.time()
    run_merge(MergeOptions(
        master_bam_file=c["ml"], slave_bam_file=c["sl"],
        blocks_file=f"{tmp}/out.blocks", master_fasta_file=c["mfa"],
        slave_fasta_file=c["sfa"], min_block_size=10,
        output_file_prefix=f"{tmp}/seq", engine=BswEngine(backend="xla")),
        log=lambda *_: None)
    t_seq = time.time() - t0
    seq_metrics = json.loads(open(f"{tmp}/seq.metrics.json").read())
    total_rows = None

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    coord = f"127.0.0.1:{_free_port()}"
    t0 = time.time()
    procs = []
    for pid in range(nproc):
        logf = f"{tmp}/driver.{pid}.log"
        fh = open(logf, "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", _DRIVER, tmp, c["ml"], c["sl"],
             c["mfa"], c["sfa"], f"{tmp}/out.blocks", coord, str(nproc),
             str(pid), f"{tmp}/dist"],
            stdout=fh, stderr=subprocess.STDOUT, text=True, env=env,
            cwd=tmp), logf, fh))
    residents = []
    compute_s = []
    cells_per_host = []
    maxrss = []
    for p, logf, fh in procs:
        p.wait(timeout=1800)
        fh.close()
        out = open(logf).read()
        assert p.returncode == 0 and "DRIVER_OK" in out, \
            f"driver failed:\n{out[-3000:]}"
        for line in out.splitlines():
            if line.startswith("[dist] resident"):
                residents.append(int(line.rsplit("=", 1)[1]))
            if "align compute seconds" in line:
                compute_s.append(float(
                    line.split("=", 1)[1].split("over")[0]))
            if "aligned cells" in line:
                cells_per_host.append(int(line.rsplit("=", 1)[1]))
            if line.startswith("DRIVER_MAXRSS_MB"):
                maxrss.append(int(line.split()[1]))
    t_dist = time.time() - t0

    for name in ("gam.fasta", "pctgs", "stats", "notmerged.fasta"):
        a = open(f"{tmp}/seq.{name}", "rb").read()
        b = open(f"{tmp}/dist.{name}", "rb").read()
        assert a == b, f"{name} differs (distributed vs sequential)"
    dist_metrics = json.loads(open(f"{tmp}/dist.metrics.json").read())

    # total rows = a full single-host decode for comparison
    from gam_ngs_tpu.core.multibam import MultiBam

    total_rows = sum(
        len(f.table)
        for lst in (c["ml"], c["sl"])
        for f in MultiBam.open(lst).files)

    rec = {
        "genome_mb": genome_mb,
        "nproc": nproc,
        "outputs_byte_identical": True,
        "t_merge_seq_s": round(t_seq, 2),
        "t_merge_dist_wall_s": round(t_dist, 2),
        "partition_s_seq": round(seq_metrics["phases"]["partition"], 2),
        "partition_s_dist_host0": round(
            dist_metrics["phases"]["partition"], 2),
        "align_s_seq": round(seq_metrics["phases"]["align"], 2),
        "align_s_dist_host0": round(dist_metrics["phases"]["align"], 2),
        "total_alignment_rows": total_rows,
        "align_compute_s_per_host": compute_s,
        "aligned_cells_per_host": cells_per_host,
        "aligned_cells_seq": seq_metrics["counters"].get("aligned_cells"),
        "maxrss_mb_per_host": maxrss,
        "resident_rows_per_host": residents,
        "resident_fraction_per_host": [round(r / total_rows, 3)
                                       for r in residents],
        "note": "all processes share ONE machine's CPU cores: the "
                "XLA-CPU align phase is core-saturated, so dist "
                "wall-clock does not improve here; the scaling "
                "evidence is resident rows ~1/N per host (ranged "
                "ingest) + byte-identical outputs — on separate "
                "hosts align time divides by the partition share",
    }
    print(json.dumps(rec, indent=1))
    if json_out:
        with open(json_out, "w") as fh:
            json.dump(rec, fh, indent=1)
        print(f"[json] wrote {json_out}")


if __name__ == "__main__":
    main()
