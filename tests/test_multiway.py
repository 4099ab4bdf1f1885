"""Multi-way merge: iterated pairwise reconciliation of 3 assemblies
(BASELINE.json config 5 shape, single-host form).

The reference supports N-way merging only by re-running gam-create +
gam-merge with the previous round's `.gam.fasta` as the new master
(example/README.md workflow); this test drives that exact loop: merge
assembly A with slave B (healing A's first junction), then feed the
merged assembly back as master against slave C (healing the remaining
junction), reconstructing the full genome.
"""

import numpy as np

import testutil
from gam_ngs_tpu.io import fasta
from gam_ngs_tpu.models.create import CreateOptions, run_create
from gam_ngs_tpu.models.merge import MergeOptions, run_merge
from gam_ngs_tpu.ops.bsw_batch import BswEngine

READ_LEN = 50
INSERT = 200


def _pairs(lo, hi):
    return [(p, p + INSERT - READ_LEN)
            for p in range(lo, hi - INSERT + 1, 8)]


def _records_for_assembly(genome, contig_spans, pairs):
    """Fabricate FR pair records against an assembly given each contig's
    (name, genome_offset, length); a pair is kept iff both mates land
    fully inside one contig.  Read names are keyed by pair index so the
    same physical read carries the same name in every assembly's BAM."""
    recs = []
    for i, (p, m) in enumerate(pairs):
        seq1 = genome[p:p + READ_LEN]
        seq2 = genome[m:m + READ_LEN]
        for ref_id, (_name, off, length) in enumerate(contig_spans):
            if p >= off and m + READ_LEN <= off + length:
                recs += testutil.make_pe_records(
                    f"pair{i}", seq1, ref_id, p - off, False,
                    seq2, ref_id, m - off, True)
                break
    return recs


def _write_assembly(tmp_path, tag, genome, contig_spans, pairs):
    """Write <tag>.bam/.list/.fasta for an assembly; returns paths."""
    names = [n for n, _o, _l in contig_spans]
    lens = [l for _n, _o, l in contig_spans]
    bam = str(tmp_path / f"{tag}.bam")
    testutil.write_sorted_bam(
        bam, names, lens,
        _records_for_assembly(genome, contig_spans, pairs))
    lst = str(tmp_path / f"{tag}.list")
    testutil.write_bam_list(lst, [bam], [(100, 1000)])
    fa = str(tmp_path / f"{tag}.fasta")
    fasta.write_fasta(fa, [(n, fasta.seq_to_codes(genome[o:o + l]))
                           for n, o, l in contig_spans])
    return lst, fa


def _merge_round(tmp_path, tag, ml, sl, mfa, sfa, engine):
    run_create(CreateOptions(master_bam_file=ml, slave_bam_file=sl,
                             min_block_size=10,
                             output_file_prefix=str(tmp_path / tag)),
               log=lambda *_: None)
    run_merge(MergeOptions(
        master_bam_file=ml, slave_bam_file=sl,
        blocks_file=str(tmp_path / f"{tag}.blocks"),
        master_fasta_file=mfa, slave_fasta_file=sfa,
        min_block_size=10, output_file_prefix=str(tmp_path / tag),
        engine=engine), log=lambda *_: None)
    out = str(tmp_path / f"{tag}.gam.fasta")
    return [(name, fasta.codes_to_bytes(seq).decode())
            for name, seq in fasta.read_fasta(out)], out


def test_three_assembly_iterated_merge(tmp_path):
    rng = np.random.default_rng(7777)
    genome = testutil.random_genome(rng, 9000)
    pairs = _pairs(0, 9000)

    # assembly A: junctions at 3000 and 6000
    a_spans = [("A0", 0, 3000), ("A1", 3000, 3000), ("A2", 6000, 3000)]
    # slave B spans A's first junction only
    b_spans = [("B0", 2000, 2500)]
    # slave C spans the junction that survives round 1
    c_spans = [("C0", 5000, 2500)]

    ml, mfa = _write_assembly(tmp_path, "a", genome, a_spans, pairs)
    sl, sfa = _write_assembly(tmp_path, "b", genome, b_spans, pairs)
    engine = BswEngine()

    merged1, merged1_fa = _merge_round(tmp_path, "r1", ml, sl, mfa, sfa,
                                       engine)
    seqs1 = sorted(s for _n, s in merged1)
    assert seqs1 == sorted([genome[:6000], genome[6000:]]), \
        "round 1 must heal the 3000 junction and keep A2 unmerged"

    # round 2: previous merged assembly becomes the master — locate each
    # merged contig in the genome to fabricate its read alignments
    m2_spans = []
    for name, seq in merged1:
        off = genome.find(seq)
        assert off >= 0
        m2_spans.append((name, off, len(seq)))
    ml2 = str(tmp_path / "m2.list")
    bam2 = str(tmp_path / "m2.bam")
    testutil.write_sorted_bam(
        bam2, [n for n, _o, _l in m2_spans], [l for _n, _o, l in m2_spans],
        _records_for_assembly(genome, m2_spans, pairs))
    testutil.write_bam_list(ml2, [bam2], [(100, 1000)])

    sl2, sfa2 = _write_assembly(tmp_path, "c", genome, c_spans, pairs)

    merged2, _ = _merge_round(tmp_path, "r2", ml2, sl2, merged1_fa, sfa2,
                              engine)
    assert [s for _n, s in merged2] == [genome], \
        "round 2 must heal the remaining junction: full genome"


_DIST_DRIVER = r"""
import os, sys

workdir, coord, nproc, pid = sys.argv[1:5]
import jax
jax.config.update("jax_platforms", "cpu")
tests_dir = os.environ["GAM_TESTS_DIR"]
sys.path.insert(0, tests_dir)

if coord:
    from gam_ngs_tpu.parallel.distributed import init_distributed
    init_distributed(coord, int(nproc), int(pid))

import testutil
from test_multiway import _pairs, _records_for_assembly
from gam_ngs_tpu.io import fasta
from gam_ngs_tpu.models.create import CreateOptions, run_create
from gam_ngs_tpu.models.merge import MergeOptions, run_merge
from gam_ngs_tpu.ops.bsw_batch import BswEngine
from gam_ngs_tpu.parallel.distributed import allgather_obj, proc_info

genome = open(os.path.join(workdir, "genome.txt")).read().strip()
pairs = _pairs(0, len(genome))
engine = BswEngine(backend="xla")

def rnd(tag, ml, sl, mfa, sfa):
    run_create(CreateOptions(
        master_bam_file=ml, slave_bam_file=sl, min_block_size=10,
        output_file_prefix=os.path.join(workdir, tag)),
        log=lambda *_: None)
    run_merge(MergeOptions(
        master_bam_file=ml, slave_bam_file=sl,
        blocks_file=os.path.join(workdir, tag + ".blocks"),
        master_fasta_file=mfa, slave_fasta_file=sfa, min_block_size=10,
        output_file_prefix=os.path.join(workdir, tag), engine=engine),
        log=lambda *_: None)

j = lambda n: os.path.join(workdir, n)
rnd("r1", j("a.list"), j("b.list"), j("a.fasta"), j("b.fasta"))

# round 2 master = round 1's merged assembly; host 0 fabricates its BAM
mypid, nproc_now = proc_info()
if mypid == 0:
    merged = [(n, fasta.codes_to_bytes(s).decode())
              for n, s in fasta.read_fasta(j("r1.gam.fasta"))]
    spans = []
    for name, seq in merged:
        off = genome.find(seq)
        assert off >= 0
        spans.append((name, off, len(seq)))
    testutil.write_sorted_bam(
        j("m2.bam"), [n for n, _o, _l in spans],
        [l for _n, _o, l in spans],
        _records_for_assembly(genome, spans, pairs))
    testutil.write_bam_list(j("m2.list"), [j("m2.bam")], [(100, 1000)])
if nproc_now > 1:
    allgather_obj(("round1_done", mypid))  # m2.bam durable before round 2

rnd("r2", j("m2.list"), j("c.list"), j("r1.gam.fasta"), j("c.fasta"))
print("DRIVER_OK", flush=True)
"""


def test_three_assembly_iterated_merge_two_process(tmp_path):
    """BASELINE config 5 at N=2 hosts: the iterated 3-assembly
    reconciliation runs as a real 2-process jax.distributed pipeline
    (sharded create + merge each round, inter-round barrier); host 0's
    final assembly must equal the sequential run byte-for-byte and
    reconstruct the genome."""
    import os
    import socket
    import subprocess
    import sys

    rng = np.random.default_rng(7777)
    genome = testutil.random_genome(rng, 9000)
    pairs = _pairs(0, 9000)
    a_spans = [("A0", 0, 3000), ("A1", 3000, 3000), ("A2", 6000, 3000)]
    b_spans = [("B0", 2000, 2500)]
    c_spans = [("C0", 5000, 2500)]

    def setup(d):
        d.mkdir(exist_ok=True)
        (d / "genome.txt").write_text(genome)
        _write_assembly(d, "a", genome, a_spans, pairs)
        _write_assembly(d, "b", genome, b_spans, pairs)
        _write_assembly(d, "c", genome, c_spans, pairs)

    seq_dir, dist_dir = tmp_path / "seq", tmp_path / "dist"
    setup(seq_dir)
    setup(dist_dir)

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env["GAM_TESTS_DIR"] = os.path.join(repo, "tests")

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"

    def launch(workdir, c, n, pid):
        logf = str(workdir / f"mw.{pid}.log")
        fh = open(logf, "w")
        return subprocess.Popen(
            [sys.executable, "-c", _DIST_DRIVER, str(workdir), c,
             str(n), str(pid)],
            stdout=fh, stderr=subprocess.STDOUT, text=True, env=env,
            cwd=str(workdir)), logf

    procs = [launch(seq_dir, "", 1, 0),
             launch(dist_dir, coord, 2, 0),
             launch(dist_dir, coord, 2, 1)]
    for p, logf in procs:
        p.wait(timeout=480)
        out = open(logf).read()
        assert p.returncode == 0 and "DRIVER_OK" in out, \
            f"driver failed ({logf}):\n{out[-3000:]}"

    seq_fa = (seq_dir / "r2.gam.fasta").read_bytes()
    dist_fa = (dist_dir / "r2.gam.fasta").read_bytes()
    assert seq_fa == dist_fa, "distributed multiway differs from sequential"
    recs = fasta.read_fasta(str(dist_dir / "r2.gam.fasta"))
    seqs = [fasta.codes_to_bytes(s).decode() for _n, s in recs]
    assert genome in seqs, "final merged assembly must be the genome"
