"""Sharded pipeline step on the virtual 8-device CPU mesh."""

import numpy as np

from gam_ngs_tpu.parallel import device_mesh, dryrun_step
from gam_ngs_tpu.parallel.mesh import DATA_AXIS


def test_mesh_axes():
    """One flat data axis at every device count (no host/chip split)."""
    for n in (1, 4, 7, 8):
        assert device_mesh(n).axis_names == (DATA_AXIS,)


def test_mesh_shape():
    mesh = device_mesh(8)
    assert mesh.devices.shape == (8,)
    assert mesh.axis_names == (DATA_AXIS,)


def test_dryrun_step_runs_and_validates():
    mesh = device_mesh(8)
    out = dryrun_step(mesh)
    # dirs sharded over batch: 16 problems, 64 rows
    assert out[0].shape[0] == 16
    assert float(out[6]) > 0


def test_step_sharding_layout():
    import jax

    mesh = device_mesh(8)
    out = dryrun_step(mesh)
    dirs, lib_count = out[0], out[3]
    # batch outputs sharded over all 8 devices; stats replicated
    assert len(dirs.sharding.device_set) == 8
    assert lib_count.sharding.is_fully_replicated


def test_engine_sharded_over_mesh():
    """align_many with a mesh shards the batch over all 8 CPU devices
    and stays oracle-exact."""
    import numpy as np

    from gam_ngs_tpu.ops.bsw_batch import BswEngine
    from gam_ngs_tpu.ops.bsw_ref import bsw_align

    mesh = device_mesh(8)
    eng = BswEngine(band=20, mesh=mesh)
    rng = np.random.default_rng(31)
    probs = []
    for k in range(21):  # pads to 3 per device -> B=64 on the mesh
        a = rng.integers(0, 5, size=int(rng.integers(60, 200))).astype(
            np.uint8)
        b = a[5:].copy()
        m = rng.random(len(b)) < 0.05
        b[m] = (b[m] + 1) % 5
        probs.append((a, 0, len(a) - 1, b, 0, len(b) - 1, False, False))
    got = eng.align_many(probs)
    for g, p in zip(got, probs):
        want = bsw_align(*p, band=20)
        assert g.score == want.score
        assert g.edits.tolist() == want.edits.tolist()


def test_shard_partitions_balanced_and_deterministic():
    from gam_ngs_tpu.parallel.distributed import shard_partitions

    sizes = [100, 1, 50, 50, 2, 99, 3, 1]
    shards = [shard_partitions(sizes, 3, h) for h in range(3)]
    # complete, disjoint
    allidx = sorted(i for s in shards for i in s)
    assert allidx == list(range(len(sizes)))
    # balanced: no host more than ~half the total
    loads = [sum(sizes[i] for i in s) for s in shards]
    assert max(loads) <= 110
    # single host owns everything
    assert shard_partitions(sizes, 1, 0) == list(range(len(sizes)))


def test_distributed_build_matches_sequential(tmp_path):
    """Single-process distributed build == plain batched build (the
    splice-by-graph-order path, collectives short-circuited)."""
    import sys
    sys.path.insert(0, "tests")
    import numpy as np
    from test_merge_pipeline import _build_inputs
    from gam_ngs_tpu.core.multibam import MultiBam
    from gam_ngs_tpu.core.refseq import RefSequence
    from gam_ngs_tpu.graphs.partition import partition_blocks
    from gam_ngs_tpu.io import blocks_io
    from gam_ngs_tpu.merge.builder import build_pctgs_batched
    from gam_ngs_tpu.models.create import CreateOptions, run_create
    from gam_ngs_tpu.ops.bsw_batch import BswEngine
    from gam_ngs_tpu.parallel.distributed import distributed_build_pctgs
    from gam_ngs_tpu.graphs import paired
    from gam_ngs_tpu.core import blocks as blocks_mod

    genome, ml, sl, mfa, sfa = _build_inputs(tmp_path)
    run_create(CreateOptions(master_bam_file=ml, slave_bam_file=sl,
                             min_block_size=10,
                             output_file_prefix=str(tmp_path / "out")),
               log=lambda *_: None)
    blocks = blocks_io.load_blocks(str(tmp_path / "out.blocks"), 10)
    master = MultiBam.open(ml)
    slave = MultiBam.open(sl)
    master.read_stats_from_file(ml + ".isize")
    slave.read_stats_from_file(sl + ".isize")
    master_ref = RefSequence.from_header(master.ref_names,
                                         master.ref_lengths)
    slave_ref = RefSequence.from_header(slave.ref_names,
                                        slave.ref_lengths)
    master_ref.load_sequences(mfa)
    slave_ref.load_sequences(sfa)
    graphs, _stats = partition_blocks(blocks, master, None, slave, None)

    seq_pctgs: list = []
    build_pctgs_batched(graphs, master_ref, slave_ref, master, slave,
                        seq_pctgs, BswEngine())
    dist_pctgs = distributed_build_pctgs(graphs, master_ref, slave_ref,
                                         master, slave, BswEngine())
    assert len(dist_pctgs) == len(seq_pctgs)
    for a, b in zip(dist_pctgs, seq_pctgs):
        assert np.array_equal(a.sequence(), b.sequence())


def test_allgather_barrier_timeout():
    """A hung collective raises BarrierTimeout instead of blocking the
    pod forever (SURVEY.md §5: the multi-host path needs basic
    barrier-timeout failure detection), and poisons the process: any
    later collective raises immediately rather than mismatching the
    orphaned in-flight one."""
    import threading

    import pytest

    from gam_ngs_tpu.parallel import distributed
    from gam_ngs_tpu.parallel.distributed import (BarrierTimeout,
                                                  allgather_obj)

    release = threading.Event()

    def hung_gather(_x):
        release.wait(30)

    try:
        with pytest.raises(BarrierTimeout, match="allgather"):
            allgather_obj({"k": 1}, timeout_s=0.2, _gather=hung_gather)
        # poisoned: even a would-be-fine collective refuses to run
        with pytest.raises(BarrierTimeout, match="poisoned"):
            allgather_obj({"k": 2}, timeout_s=5.0, _gather=lambda x: x)
    finally:
        release.set()  # let the worker thread exit promptly
        distributed._reset_poison()


def test_barrier_timeout_env_validation(monkeypatch):
    import pytest

    from gam_ngs_tpu.parallel.distributed import barrier_timeout_s

    monkeypatch.setenv("GAM_BARRIER_TIMEOUT", "12.5")
    assert barrier_timeout_s() == 12.5
    monkeypatch.setenv("GAM_BARRIER_TIMEOUT", "bogus")
    with pytest.raises(ValueError, match="GAM_BARRIER_TIMEOUT"):
        barrier_timeout_s()
    monkeypatch.setenv("GAM_BARRIER_TIMEOUT", "-1")
    with pytest.raises(ValueError, match="GAM_BARRIER_TIMEOUT"):
        barrier_timeout_s()


def test_allgather_injected_gather_roundtrip():
    """allgather_obj reassembles pickled payloads per process via the
    injected collective (simulating 2 hosts in one process)."""
    import numpy as np

    from gam_ngs_tpu.parallel.distributed import allgather_obj

    objs = [{"host": 0, "v": [1, 2]}, {"host": 1, "v": "x" * 100}]
    import pickle

    payloads = [np.frombuffer(pickle.dumps(o), np.uint8) for o in objs]
    cap = max(len(p) for p in payloads)

    def fake_gather(x):
        if x.dtype == np.int64:  # size exchange
            return np.array([[len(p)] for p in payloads], np.int64)
        out = np.zeros((2, cap), np.uint8)
        for k, p in enumerate(payloads):
            out[k, :len(p)] = p
        return out

    got = allgather_obj(objs[0], timeout_s=5.0, _gather=fake_gather)
    assert got == objs


def test_allgather_propagates_worker_exception():
    from gam_ngs_tpu.parallel.distributed import allgather_obj
    import pytest

    def broken_gather(_x):
        raise ValueError("peer died")

    with pytest.raises(ValueError, match="peer died"):
        allgather_obj([1], timeout_s=5.0, _gather=broken_gather)


def test_sharded_partition_ingestion_matches_sequential(tmp_path):
    """Multi-host partition phase: deferred MultiBams + per-host contig
    runs + owned-jobs-only edge weighting + final-prop allgather must
    reproduce the sequential edge props exactly, while each host keeps
    strictly fewer alignment rows resident than a full decode."""
    import sys as _sys
    import os as _os
    _sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))
    import testutil
    from test_create_dist import run_lockstep
    from gam_ngs_tpu.core.multibam import MultiBam
    from gam_ngs_tpu.graphs.partition import partition_blocks
    from gam_ngs_tpu.models.create import CreateOptions, run_create

    rng = np.random.default_rng(77)
    # TWO independent components: S0 bridges M0|M1, S1 bridges M2|M3
    g1 = testutil.random_genome(rng, 6000)
    g2 = testutil.random_genome(rng, 6000)
    m_recs, s_recs = [], []
    READ_LEN, INSERT = 50, 200
    i = 0
    for base, g in ((0, g1), (1, g2)):
        for p in range(0, 6000 - INSERT, 8):
            q = p + INSERT - READ_LEN
            name = f"r{base}_{i}"
            i += 1
            s1, s2 = g[p:p + READ_LEN], g[q:q + READ_LEN]
            hi = q + READ_LEN
            mc = 2 * base
            if hi <= 3000:
                m_recs += testutil.make_pe_records(
                    name, s1, mc, p, False, s2, mc, q, True)
            elif p >= 3000:
                m_recs += testutil.make_pe_records(
                    name, s1, mc + 1, p - 3000, False, s2, mc + 1,
                    q - 3000, True)
            s_recs += testutil.make_pe_records(
                name, s1, base, p, False, s2, base, q, True)

    mp, sp = str(tmp_path / "m.bam"), str(tmp_path / "s.bam")
    testutil.write_sorted_bam(
        mp, ["M0", "M1", "M2", "M3"], [3000] * 4, m_recs)
    testutil.write_sorted_bam(sp, ["S0", "S1"], [6000, 6000], s_recs)
    ml, sl = str(tmp_path / "m.list"), str(tmp_path / "s.list")
    testutil.write_bam_list(ml, [mp], [(100, 1000)])
    testutil.write_bam_list(sl, [sp], [(100, 1000)])
    blocks = run_create(CreateOptions(
        master_bam_file=ml, slave_bam_file=sl, min_block_size=10,
        output_file_prefix=str(tmp_path / "out")), log=lambda *_: None)

    def open_pair(deferred):
        if deferred:
            m = MultiBam.open_deferred(ml)
            s = MultiBam.open_deferred(sl)
        else:
            m = MultiBam.open(ml)
            s = MultiBam.open(sl)
        m.read_stats_from_file(ml + ".isize")
        s.read_stats_from_file(sl + ".isize")
        return m, s

    # sequential baseline
    m_seq, s_seq = open_pair(False)
    seq_graphs, seq_stats = partition_blocks(blocks, m_seq, None, s_seq,
                                             None)
    assert len(seq_graphs) == 2
    total_rows = sum(len(f.table) for mb in (m_seq, s_seq)
                     for f in mb.files)

    def host(pid, gather):
        m, s = open_pair(True)
        graphs, stats = partition_blocks(
            blocks, m, None, s, None, shard=(pid, 2), _allgather=gather)
        resident = sum(len(f.table) for mb in (m, s) for f in mb.files)
        props = [[(g.prop[e]["weight"], g.prop[e]["rnum"],
                   g.prop[e]["min_cov"]) for e in g.edges()]
                 for g in graphs]
        return resident, props, stats.stats_text()

    results = run_lockstep(host, 2)
    seq_props = [[(g.prop[e]["weight"], g.prop[e]["rnum"],
                   g.prop[e]["min_cov"]) for e in g.edges()]
                 for g in seq_graphs]
    for pid, (resident, props, stats_text) in enumerate(results):
        assert props == seq_props, f"host {pid} edge props diverged"
        assert stats_text == seq_stats.stats_text()
        assert resident < total_rows, \
            f"host {pid} decoded everything ({resident}/{total_rows})"
    # the two components split one per host
    assert sum(r for r, _, _ in results) <= total_rows


def test_engine_mesh_device_traceback():
    """Meshed DEVICE traceback: the fused forward + find-max + lockstep
    walk shard_mapped over the batch axis, oracle-exact."""
    import numpy as np

    from gam_ngs_tpu.ops.bsw_batch import BswEngine
    from gam_ngs_tpu.ops.bsw_ref import bsw_align

    mesh = device_mesh(8)
    eng = BswEngine(band=20, mesh=mesh, backend="xla",
                    traceback="device", fetch="edits")
    rng = np.random.default_rng(32)
    probs = []
    for k in range(13):
        a = rng.integers(0, 5, size=int(rng.integers(60, 200))).astype(
            np.uint8)
        b = a[4:].copy()
        m = rng.random(len(b)) < 0.06
        b[m] = (b[m] + 1) % 5
        probs.append((a, 0, len(a) - 1, b, 0, len(b) - 1, False, False))
    got = eng.align_many(probs)
    for g, p in zip(got, probs):
        want = bsw_align(*p, band=20)
        assert g.score == want.score
        assert g.begin_a == want.begin_a and g.begin_b == want.begin_b
        assert g.edits.tolist() == want.edits.tolist()


def test_resident_region_count_meshed(tmp_path, monkeypatch):
    """The resident edge-weight count sharded over the virtual 8-mesh
    (one chunk per device, arena replicated) matches the un-meshed and
    the sequential-oracle results."""
    import testutil
    from gam_ngs_tpu.core.multibam import MultiBam
    from gam_ngs_tpu.graphs.assembly import AssemblyGraph
    from gam_ngs_tpu.graphs.compact import CompactAssemblyGraph
    from gam_ngs_tpu.graphs.partition import (
        partition_blocks_by_paired_contigs,
    )
    from gam_ngs_tpu.models.create import CreateOptions, run_create
    from gam_ngs_tpu.ops import region_score as rs

    monkeypatch.setenv("GAM_RESIDENT", "1")
    rng = np.random.default_rng(123)
    genome = testutil.random_genome(rng, 9000)
    cuts = [0, 3000, 6000, 9000]
    m_recs, s_recs = [], []
    for i, p in enumerate(range(0, 9000 - 220, 6)):
        q = p + 170
        s1, s2 = genome[p:p + 50], genome[q:q + 50]
        for c in range(3):
            if p >= cuts[c] and q + 50 <= cuts[c + 1]:
                m_recs += testutil.make_pe_records(
                    f"r{i}", s1, c, p - cuts[c], False,
                    s2, c, q - cuts[c], True)
        s_recs += testutil.make_pe_records(f"r{i}", s1, 0, p, False,
                                           s2, 0, q, True)
    mp, sp = str(tmp_path / "m.bam"), str(tmp_path / "s.bam")
    testutil.write_sorted_bam(mp, ["M0", "M1", "M2"],
                              [3000, 3000, 3000], m_recs)
    testutil.write_sorted_bam(sp, ["S0"], [9000], s_recs)
    ml, sl = str(tmp_path / "m.list"), str(tmp_path / "s.list")
    testutil.write_bam_list(ml, [mp], [(50, 500)])
    testutil.write_bam_list(sl, [sp], [(50, 500)])
    blocks = run_create(CreateOptions(
        master_bam_file=ml, slave_bam_file=sl, min_block_size=10,
        output_file_prefix=str(tmp_path / "out")), log=lambda *_: None)
    master, slave = MultiBam.open(ml), MultiBam.open(sl)
    master.read_stats_from_file(ml + ".isize")
    slave.read_stats_from_file(sl + ".isize")

    mesh = device_mesh(8)
    parts = partition_blocks_by_paired_contigs(blocks)
    for ag_id, rows in enumerate(parts, start=1):
        ag = AssemblyGraph(blocks, rows, ag_id)
        cg_seq = CompactAssemblyGraph(ag)
        cg_seq.compute_edge_weights(master, None, slave, None,
                                    batched=False)
        cg_mesh = CompactAssemblyGraph(ag)
        jobs = cg_mesh.prepare_edge_weights(master, None, slave, None)
        assert jobs and "_mb" in jobs[0]
        cg_mesh.apply_edge_weights(rs.count_jobs(jobs, mesh=mesh))
        for e in cg_seq.edges():
            assert cg_seq.prop[e]["weight"] == cg_mesh.prop[e]["weight"]
            assert cg_seq.prop[e]["rnum"] == cg_mesh.prop[e]["rnum"]


def test_engine_mesh_resident_arena():
    """Meshed fused path with the RESIDENT SEQUENCE ARENA: the arena
    replicates to every virtual device (P(None) spec) while the problem
    axis shards; forward + rc orientations oracle-exact."""
    import numpy as np

    from gam_ngs_tpu.io.fasta import reverse_complement
    from gam_ngs_tpu.ops.bsw_batch import BswEngine
    from gam_ngs_tpu.ops.bsw_ref import bsw_align

    mesh = device_mesh(8)
    eng = BswEngine(band=20, mesh=mesh, backend="xla",
                    traceback="device", fetch="edits")
    rng = np.random.default_rng(41)
    contigs = [rng.integers(0, 5, size=int(rng.integers(80, 220))).astype(
        np.uint8) for _ in range(5)]
    eng.register_contigs(contigs)
    probs = []
    for k in range(11):
        a = contigs[k % 5]
        b0 = contigs[(k + 2) % 5]
        b = reverse_complement(b0) if k % 2 else b0
        probs.append((a, 0, len(a) - 1, b, 0, len(b) - 1, False,
                      k % 3 == 0))
    got = eng.align_many(probs)
    for g, p in zip(got, probs):
        want = bsw_align(*p, band=20)
        assert g.score == want.score
        assert g.begin_a == want.begin_a and g.begin_b == want.begin_b
        if want.edits is not None and g.edits is not None:
            assert g.edits.tolist() == want.edits.tolist()
