"""Edge semantics of the fused device path vs the exact oracle.

The GPU kernel (ops/bsw_cuda.cu) steps the band along anti-diagonals
and switches per problem between an exact body and a lean one; these
cases pin the semantics that split must preserve — force_start/
force_end quirk lanes (banded_smith_waterman.cc:116,201), begin_a < 0
tail windows (PctgBuilder.cc:1549), x_size <= FORCE_MAXGAP_LEN underflow
windows — at band=30 and the production band=150.  Here they run the
XLA fused path on the CPU; test_bsw_gpu.py runs them on the card.
"""

import numpy as np
import pytest

from gam_ngs_tpu.ops.bsw_batch import BswEngine
from gam_ngs_tpu.ops.bsw_ref import bsw_align


def assert_same(aln1, aln2, label=""):
    assert aln1.begin_a == aln2.begin_a, label
    assert aln1.begin_b == aln2.begin_b, label
    assert aln1.score == aln2.score, label
    assert aln1.homology == pytest.approx(aln2.homology, abs=1e-12), label
    if aln1.edits is not None and aln2.edits is not None:
        assert aln1.edits.tolist() == aln2.edits.tolist(), label


ENG30 = BswEngine(band=30, backend="xla", traceback="device",
                  fetch="edits")
ENG150 = BswEngine(band=150, backend="xla", traceback="device",
                   fetch="edits")


def test_antidiag_selected():
    """On the CPU "auto" resolves to the XLA forward with the host walk;
    the fused device path is selected explicitly."""
    auto = BswEngine(band=30)
    assert auto.kernel == "xla"
    assert auto._resolve_traceback() == "host"
    assert not auto._resolve_lean()
    assert ENG30.kernel == "xla" and ENG30._resolve_traceback() == "device"


def mutate(rng, seq, sub=0.03, ins=0.012, dele=0.012):
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


def test_fuzz_band30_mixed_flags():
    rng = np.random.default_rng(71)
    problems = []
    for k in range(10):
        n = int(rng.integers(40, 320))
        hi = 5 if k % 3 == 0 else 4
        a = rng.integers(0, hi, size=n).astype(np.uint8)
        b = mutate(rng, a)
        fs = k % 2 == 0
        fe = k % 3 == 1
        problems.append((a, 0, len(a) - 1, b, 0, len(b) - 1, fs, fe))
    got = ENG30.align_many(problems)
    for k, pr in enumerate(problems):
        assert_same(got[k], bsw_align(*pr, band=30), f"case {k}")


def test_band150_production_shapes():
    rng = np.random.default_rng(72)
    problems = []
    for k in range(4):
        n = int(rng.integers(200, 900))
        a = rng.integers(0, 4, size=n).astype(np.uint8)
        b = mutate(rng, a)
        problems.append((a, 0, len(a) - 1, b, 0, len(b) - 1,
                         k % 2 == 0, k == 3))
    got = ENG150.align_many(problems)
    for k, pr in enumerate(problems):
        assert_same(got[k], bsw_align(*pr, band=150), f"case {k}")


def test_force_end_underflow_windows():
    """x_size <= FORCE_MAXGAP_LEN + force_end: the reference's unsigned
    window bound wraps and every diagonal candidate is excluded — by
    the device find-max and by the host one alike."""
    rng = np.random.default_rng(73)
    a = rng.integers(0, 4, size=120).astype(np.uint8)
    problems = []
    for xs in (2, 5, 10, 11, 12):
        problems.append((a, 0, len(a) - 1, a[:60].copy(), 0, xs - 1,
                         False, True))
    for eng in (ENG30, BswEngine(band=30, backend="xla", traceback="host")):
        eng_label = eng._resolve_traceback()
        got = eng.align_many(problems)
        for k, pr in enumerate(problems):
            assert_same(got[k], bsw_align(*pr, band=30),
                        f"{eng_label} x_size case {k}")


def test_negative_begin_a_no_fallback():
    """begin_a < 0 problems share a batch with ordinary ones (the GPU
    kernel keeps its exact body for them alone)."""
    rng = np.random.default_rng(74)
    g = rng.integers(0, 4, size=500).astype(np.uint8)
    a = g[:280].copy()
    b = np.concatenate([rng.integers(0, 4, size=50).astype(np.uint8),
                        g[:240]])
    problems = [
        (a, -35, 200, b, 0, len(b) - 1, False, True),
        (a, -100, 170, b, 0, len(b) - 1, False, False),
        (a, 0, len(a) - 1, mutate(rng, a), 0, 270, False, False),
    ]
    got = ENG30.align_many(problems)
    for k, pr in enumerate(problems):
        assert_same(got[k], bsw_align(*pr, band=30), f"case {k}")


def test_force_start_deep_pos0():
    """force_start with the pos==0 column crossing FORCE_MAXGAP_LEN
    rows (the fresh/forced transition at i == 10)."""
    rng = np.random.default_rng(75)
    a = rng.integers(0, 4, size=80).astype(np.uint8)
    b = np.concatenate([a[:40], rng.integers(0, 4, 25).astype(np.uint8)])
    # begin_a = 0 puts pos==0 in-band for the first `band` rows
    pr = (a, 0, 79, b, 0, len(b) - 1, True, False)
    assert_same(ENG30.align_one(*pr), bsw_align(*pr, band=30))


def test_edits_fetch_matches_lean():
    eng_e = BswEngine(band=30, backend="xla", traceback="device",
                      fetch="edits")
    eng_l = BswEngine(band=30, backend="xla", traceback="device",
                      fetch="lean")
    rng = np.random.default_rng(76)
    a = rng.integers(0, 4, size=260).astype(np.uint8)
    b = mutate(rng, a)
    pr = (a, 0, len(a) - 1, b, 0, len(b) - 1, False, False)
    ref = bsw_align(*pr, band=30)
    got_e = eng_e.align_one(*pr)
    got_l = eng_l.align_one(*pr)
    assert_same(got_e, ref)
    assert got_l.begin_a == ref.begin_a and got_l.score == ref.score
    assert got_l.length == ref.length
    assert got_l.homology == pytest.approx(ref.homology, abs=1e-12)


def test_resident_arena_matches_oracle():
    """Resident sequence arena: problems referencing registered contigs
    (forward AND memoized reverse-complement orientations) dispatch as
    coordinates and must match the oracle exactly; unregistered arrays
    (tail slices) fall back to window-payload chunks in the same call."""
    from gam_ngs_tpu.io.fasta import reverse_complement

    rng = np.random.default_rng(91)
    eng = BswEngine(band=30, backend="xla", traceback="device",
                    fetch="edits")
    c0 = rng.integers(0, 5, size=240).astype(np.uint8)
    c1 = mutate(rng, c0)
    c2 = rng.integers(0, 4, size=180).astype(np.uint8)
    eng.register_contigs([c0, c1, c2])

    rc1 = reverse_complement(c1)
    assert reverse_complement(rc1) is c1  # memoized two-way
    tail = c0[60:].copy()                 # NOT registered

    problems = [
        (c0, 0, len(c0) - 1, c1, 0, len(c1) - 1, False, False),
        (c0, 0, len(c0) - 1, rc1, 0, len(rc1) - 1, False, False),
        (rc1, 0, len(rc1) - 1, c2, 0, len(c2) - 1, True, False),
        (c2, 0, len(c2) - 1, c0, 10, 200, False, True),
        (tail, 0, len(tail) - 1, c1, 0, len(c1) - 1, False, False),
    ]
    # every registered-pair problem must have resolved arena coords
    got = eng.align_many(problems)
    for k, pr in enumerate(problems):
        assert_same(got[k], bsw_align(*pr, band=30), f"arena case {k}")
    assert eng._seq_lookup(rc1) is not None
    assert eng._seq_lookup(tail) is None


def test_resident_arena_lean_fetch():
    from gam_ngs_tpu.io.fasta import reverse_complement
    from gam_ngs_tpu.ops.editops import first_match_pos, last_match_pos

    rng = np.random.default_rng(92)
    eng = BswEngine(band=30, backend="xla", traceback="device",
                    fetch="lean")
    c0 = rng.integers(0, 4, size=300).astype(np.uint8)
    c1 = mutate(rng, c0)
    eng.register_contigs([c0, c1])
    pr = (c0, 0, len(c0) - 1, reverse_complement(c1), 0, len(c1) - 1,
          False, False)
    want = bsw_align(*pr, band=30)
    g = eng.align_one(*pr)
    assert g.begin_a == want.begin_a and g.score == want.score
    assert g.length == want.length
    assert first_match_pos(g) == first_match_pos(want)
    assert last_match_pos(g) == last_match_pos(want)
