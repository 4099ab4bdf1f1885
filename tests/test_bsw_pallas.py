"""Fused device path (forward -> device find-max -> lockstep walk, one
dispatch) vs the exact oracle.  On the CPU the fused path runs the XLA
forward; the GPU kernel takes the same path on the card (tests marked
`gpu` in test_bsw_gpu.py)."""

import numpy as np
import pytest

from gam_ngs_tpu.ops.bsw_batch import BswEngine
from gam_ngs_tpu.ops.bsw_ref import bsw_align


def assert_same(aln1, aln2, label=""):
    assert aln1.begin_a == aln2.begin_a, label
    assert aln1.begin_b == aln2.begin_b, label
    assert aln1.score == aln2.score, label
    assert aln1.homology == pytest.approx(aln2.homology, abs=1e-12), label
    assert aln1.edits.tolist() == aln2.edits.tolist(), label


ENGINE = BswEngine(band=30, backend="xla", traceback="device")


def mutate(rng, seq, sub=0.02, ins=0.01, dele=0.01):
    out = []
    for c in seq:
        r = rng.random()
        if r < dele:
            continue
        if r < dele + ins:
            out.append(rng.integers(0, 4))
        if rng.random() < sub:
            out.append((c + 1 + rng.integers(0, 3)) % 4)
        else:
            out.append(c)
    return np.array(out, np.uint8)


def test_random_pairs_with_n():
    rng = np.random.default_rng(10)
    problems = []
    for k in range(6):
        n = int(rng.integers(80, 350))
        hi = 5 if k % 2 == 0 else 4
        a = rng.integers(0, hi, size=n).astype(np.uint8)
        b = mutate(rng, a)
        problems.append((a, 0, len(a) - 1, b, 0, len(b) - 1, False, False))
    got = ENGINE.align_many(problems)
    for k, pr in enumerate(problems):
        assert_same(got[k], bsw_align(*pr, band=30), f"case {k}")


@pytest.mark.parametrize("fs,fe", [(True, False), (False, True),
                                   (True, True)])
def test_force_flags(fs, fe):
    rng = np.random.default_rng(11)
    g = rng.integers(0, 4, size=500).astype(np.uint8)
    a = g[:330].copy()
    b = mutate(rng, g[:350])
    pr = (a, 0, len(a) - 1, b, 0, len(b) - 1, fs, fe)
    assert_same(ENGINE.align_one(*pr), bsw_align(*pr, band=30))


def test_offset_semiglobal_window():
    rng = np.random.default_rng(12)
    g = rng.integers(0, 4, size=800).astype(np.uint8)
    b = g[400:650].copy()
    pr = (g, 380, 700, b, 0, 249, False, False)
    assert_same(ENGINE.align_one(*pr), bsw_align(*pr, band=30))


def test_offset_prefix_divergent_tail():
    """Regression: lane-varying scan slopes (fresh-start boundaries) —
    the doubling-scan combine must use the current element's slope."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 5, size=300).astype(np.uint8)
    b = np.concatenate([a[40:200],
                        rng.integers(0, 4, size=30).astype(np.uint8)])
    pr = (a, 0, 299, b, 0, len(b) - 1, False, False)
    assert_same(ENGINE.align_one(*pr), bsw_align(*pr, band=30))


DEVICE_TB = BswEngine(band=30, backend="xla", traceback="device",
                      fetch="edits")


def test_device_traceback_matches_oracle():
    """Lockstep on-device traceback walk == oracle edits exactly."""
    rng = np.random.default_rng(14)
    problems = []
    for k in range(5):
        n = int(rng.integers(80, 300))
        a = rng.integers(0, 5, size=n).astype(np.uint8)
        b = mutate(rng, a)
        problems.append((a, 0, len(a) - 1, b, 0, len(b) - 1,
                         k % 2 == 0, False))
    got = DEVICE_TB.align_many(problems)
    for k, pr in enumerate(problems):
        assert_same(got[k], bsw_align(*pr, band=30), f"case {k}")


def test_device_traceback_not_found_and_empty():
    a = np.zeros(40, np.uint8)
    # empty window mixes with real problems in one chunk
    probs = [(a, 0, 39, a, 30, 5, False, False),
             (a, 0, 39, a[:30], 0, 29, False, False)]
    got = DEVICE_TB.align_many(probs)
    assert got[0].length == 0
    assert_same(got[1], bsw_align(*probs[1], band=30))


def test_negative_begin_a_forces_full_rows():
    """Reference tail alignments may pass begin_a < 0
    (PctgBuilder.cc:1549): pos==0 lanes then appear at arbitrary row
    depth (the GPU kernel keeps its exact body for such problems); the
    result must stay cell-exact vs the oracle."""
    rng = np.random.default_rng(33)
    g = rng.integers(0, 4, size=400).astype(np.uint8)
    a = g[:250].copy()
    b = np.concatenate([rng.integers(0, 4, size=60).astype(np.uint8),
                        g[:200]])
    probs = [
        (a, -40, 190, b, 0, len(b) - 1, False, True),
        (a, -120, 150, b, 0, len(b) - 1, False, False),
        # mixed batch: one non-negative problem shares the chunk
        (a, 0, len(a) - 1, b, 0, len(b) - 1, False, False),
    ]
    got = ENGINE.align_many(probs)
    for k, pr in enumerate(probs):
        assert_same(got[k], bsw_align(*pr, band=30), f"case {k}")


def test_deep_rows_lean_tiles_exact():
    """Problems far longer than the band (the GPU kernel's lean body
    covers most steps): cell-exact, including per-problem x_size
    variation in one batch and matches landing in deep rows."""
    rng = np.random.default_rng(34)
    probs = []
    for k, n in enumerate((700, 1000, 430)):
        a = rng.integers(0, 5, size=n).astype(np.uint8)
        b = mutate(rng, a)
        probs.append((a, 0, n - 1, b, 0, len(b) - 1, k == 1, False))
    got = ENGINE.align_many(probs)
    for k, pr in enumerate(probs):
        assert_same(got[k], bsw_align(*pr, band=30), f"case {k}")


def test_lean_fetch_matches_oracle():
    """fetch="lean" ships only the walk summary (no edit strings); the
    fields the merge consumes (score/begin/homology/length/first/last
    match) must match the oracle exactly."""
    import numpy as np

    from gam_ngs_tpu.ops.bsw_ref import bsw_align
    from gam_ngs_tpu.ops.editops import first_match_pos, last_match_pos

    eng = BswEngine(band=25, backend="xla", traceback="device",
                    fetch="lean")
    rng = np.random.default_rng(9)
    probs = []
    for _ in range(16):
        a = rng.integers(0, 5, int(rng.integers(150, 250))).astype(
            np.uint8)
        b = a[3:].copy()
        m = rng.random(len(b)) < 0.07
        b[m] = (b[m] + 1) % 5
        if rng.random() < 0.4 and len(b) > 30:
            p = int(rng.integers(0, len(b) - 5))
            b = np.delete(b, slice(p, p + 3))
        fs = bool(rng.random() < 0.25)
        fe = bool(rng.random() < 0.25)
        probs.append((a, 0, len(a) - 1, b, 0, len(b) - 1, fs, fe))
    got = eng.align_many(probs)
    for g, pr in zip(got, probs):
        w = bsw_align(*pr, band=25)
        assert g.lean is not None and len(g.edits) == 0
        assert (g.score, g.begin_a, g.begin_b) == \
            (w.score, w.begin_a, w.begin_b)
        assert abs(g.homology - w.homology) < 1e-9
        assert g.length == w.length
        assert first_match_pos(g) == first_match_pos(w)
        assert last_match_pos(g) == last_match_pos(w)


def test_lean_merge_outputs_identical(tmp_path):
    """Full merge with the lean-fetch engine produces byte-identical
    outputs to the sequential oracle (outputs derive only from the
    summary fields)."""
    import numpy as np
    import testutil
    from gam_ngs_tpu.io import fasta
    from gam_ngs_tpu.models.create import CreateOptions, run_create
    from gam_ngs_tpu.models.merge import MergeOptions, run_merge

    rng = np.random.default_rng(71)
    genome = testutil.random_genome(rng, 6000)
    m_recs, s_recs = [], []
    for i, p in enumerate(range(0, 6000 - 200, 7)):
        q = p + 150
        s1, s2 = genome[p:p + 50], genome[q:q + 50]
        if q + 50 <= 3000:
            m_recs += testutil.make_pe_records(f"r{i}", s1, 0, p, False,
                                               s2, 0, q, True)
        elif p >= 3000:
            m_recs += testutil.make_pe_records(f"r{i}", s1, 1, p - 3000,
                                               False, s2, 1, q - 3000,
                                               True)
        s_recs += testutil.make_pe_records(f"r{i}", s1, 0, p, False,
                                           s2, 0, q, True)
    mp, sp = str(tmp_path / "m.bam"), str(tmp_path / "s.bam")
    testutil.write_sorted_bam(mp, ["M0", "M1"], [3000, 3000], m_recs)
    testutil.write_sorted_bam(sp, ["S0"], [6000], s_recs)
    ml, sl = str(tmp_path / "m.list"), str(tmp_path / "s.list")
    testutil.write_bam_list(ml, [mp], [(100, 1000)])
    testutil.write_bam_list(sl, [sp], [(100, 1000)])
    mfa, sfa = str(tmp_path / "m.fasta"), str(tmp_path / "s.fasta")
    fasta.write_fasta(mfa, [
        ("M0", fasta.seq_to_codes(genome[:3000])),
        ("M1", fasta.seq_to_codes(genome[3000:]))])
    fasta.write_fasta(sfa, [("S0", fasta.seq_to_codes(genome))])
    run_create(CreateOptions(
        master_bam_file=ml, slave_bam_file=sl, min_block_size=10,
        output_file_prefix=str(tmp_path / "out")), log=lambda *_: None)
    blobs = {}
    for tag, eng in (("seq", None),
                     ("lean", BswEngine(backend="xla",
                                        traceback="device",
                                        fetch="lean"))):
        run_merge(MergeOptions(
            master_bam_file=ml, slave_bam_file=sl,
            blocks_file=str(tmp_path / "out.blocks"),
            master_fasta_file=mfa, slave_fasta_file=sfa,
            min_block_size=10, output_file_prefix=str(tmp_path / tag),
            engine=eng, batched_weights=eng is not None),
            log=lambda *_: None)
        blobs[tag] = (tmp_path / f"{tag}.gam.fasta").read_bytes()
    assert blobs["seq"] == blobs["lean"]
