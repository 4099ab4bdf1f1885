"""Synthetic genome / read / BAM fabrication for tests."""

from __future__ import annotations

import numpy as np

from gam_ngs_tpu.io import bam as bam_io
from gam_ngs_tpu.io.fasta import codes_to_bytes, seq_to_codes, reverse_complement

BASES = "ATCG"


def random_genome(rng: np.random.Generator, length: int) -> str:
    return "".join(BASES[i] for i in rng.integers(0, 4, size=length))


def make_pe_records(name: str, seq1: str, ref1: int, pos1: int, rev1: bool,
                    seq2: str, ref2: int, pos2: int, rev2: bool,
                    nh: int = 1, xt: str = "U") -> list[dict]:
    """A proper FR read pair, both mates mapped."""
    tags = bam_io.make_tag_i("NH", nh) + bam_io.make_tag_A("XT", xt)
    f1 = 0x1 | 0x40 | (0x10 if rev1 else 0) | (0x20 if rev2 else 0)
    f2 = 0x1 | 0x80 | (0x10 if rev2 else 0) | (0x20 if rev1 else 0)
    r1 = dict(name=name, flag=f1, ref_id=ref1, pos=pos1,
              cigar=[(len(seq1), "M")], seq=seq1, mate_ref_id=ref2,
              mate_pos=pos2, tags=tags)
    r2 = dict(name=name, flag=f2, ref_id=ref2, pos=pos2,
              cigar=[(len(seq2), "M")], seq=seq2, mate_ref_id=ref1,
              mate_pos=pos1, tags=tags)
    return [r1, r2]


def random_cigar(rng: np.random.Generator, rl: int) -> list[tuple[int, str]]:
    """Random CIGAR consuming exactly `rl` query bases whose REFERENCE
    span never exceeds rl (so read placements computed for a pure-M
    read stay within contig bounds).  Draws soft clips, insertions,
    deletions / reference skips, =/X decompositions, and occasional
    hard clips / padding — the op set BamAlignment::GetEndPosition
    sums (lib/bamtools-2.3.0/src/api/BamAlignment.cpp:478: M/D/N/=/X
    consume reference; I/S/H/P don't)."""
    if rl < 24:
        return [(rl, "M")]
    s_lead = int(rng.integers(1, 8)) if rng.random() < 0.4 else 0
    s_tail = int(rng.integers(1, 8)) if rng.random() < 0.4 else 0
    ins = int(rng.integers(1, 5)) if rng.random() < 0.5 else 0
    mid = rl - s_lead - s_tail - ins  # aligned query bases, >= 6
    slack = s_lead + s_tail + ins     # ref-span headroom
    dele = int(rng.integers(1, min(5, slack) + 1)) \
        if slack and rng.random() < 0.6 else 0
    d_op = "N" if rng.random() < 0.2 else "D"

    if ins and dele:
        m1 = int(rng.integers(1, mid - 1))
        m2 = int(rng.integers(1, mid - m1))
        m3 = mid - m1 - m2
    elif ins or dele:
        m1 = int(rng.integers(1, mid))
        m2, m3 = mid - m1, 0
    else:
        m1, m2, m3 = mid, 0, 0

    ops: list[tuple[int, str]] = []
    if s_lead and rng.random() < 0.15:
        ops.append((int(rng.integers(1, 6)), "H"))
    if s_lead:
        ops.append((s_lead, "S"))

    def emit_m(k: int) -> None:
        if k <= 0:
            return
        if k >= 4 and rng.random() < 0.2:
            x = int(rng.integers(1, k))
            ops.append((x, "="))
            ops.append((k - x, "X"))
        else:
            ops.append((k, "M"))

    emit_m(m1)
    if ins:
        if rng.random() < 0.1:
            ops.append((int(rng.integers(1, 4)), "P"))
        ops.append((ins, "I"))
    if ins and dele:
        emit_m(m2)
        ops.append((dele, d_op))
        emit_m(m3)
    elif dele:
        ops.append((dele, d_op))
        emit_m(m2)
    else:
        emit_m(m2)
    if s_tail:
        ops.append((s_tail, "S"))
        if rng.random() < 0.15:
            ops.append((int(rng.integers(1, 6)), "H"))
    return ops


def sort_records(records: list[dict]) -> list[dict]:
    """Coordinate sort (stable) like samtools."""
    return sorted(records, key=lambda r: (r["ref_id"] & 0xFFFFFFFF, r["pos"]))


def write_sorted_bam(path: str, ref_names, ref_lengths, records):
    bam_io.write_bam(path, ref_names, ref_lengths, sort_records(records))


def write_bai_stub(bam_path: str, n_ref: int) -> None:
    """Minimal valid .bai (BAI\\1, n_ref, zero bins/offsets per ref).

    The reference's MultiBamReader::Open exits unless every BAM has an
    index (MultiBamReader.cc:96-103), but the gam-create path streams
    sequentially and never queries regions, so an empty-bins index
    satisfies BamStandardIndex::Load (BamStandardIndex_p.cpp:544)."""
    import struct

    with open(bam_path + ".bai", "wb") as fh:
        fh.write(b"BAI\x01")
        fh.write(struct.pack("<i", n_ref))
        fh.write(struct.pack("<ii", 0, 0) * n_ref)


def write_bam_list(path: str, bam_paths, inserts=None):
    with open(path, "w") as fh:
        for i, p in enumerate(bam_paths):
            fh.write(p + "\n")
            if inserts is not None:
                fh.write(f"{inserts[i][0]} {inserts[i][1]}\n")
            else:
                fh.write("\n")


def sample_reads_from(genome: str, rng, n_pairs: int, read_len: int = 50,
                      insert: int = 200, prefix: str = "r") -> list[tuple]:
    """Sample FR pairs: (name, fwd_pos, rev_pos).  Positions are 0-based."""
    out = []
    max_start = len(genome) - insert
    for i in range(n_pairs):
        p = int(rng.integers(0, max(1, max_start)))
        out.append((f"{prefix}{i}", p, p + insert - read_len))
    return out


def _reg2bin(beg: int, end: int) -> int:
    """SAM-spec reg2bin: smallest bin fully containing [beg, end)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def write_real_bai(bam_path: str) -> None:
    """Write a spec-correct .bai for a BAM produced by write_bam:
    records binned by reg2bin over their CIGAR reference span, one
    chunk per maximal same-bin run (records are coordinate sorted),
    and a 16kb linear index (min voff whose window any record
    overlaps, carry-filled like samtools).  Virtual offsets are exact,
    computed from the BGZF block table — this index satisfies real
    region queries through BamTools' BamStandardIndex (which the
    reference's gam-merge edge-weighting depends on,
    CompactAssemblyGraph.cc:418 SetRegion) as well as gam's
    bai->gidx bridge."""
    import bisect
    import struct

    from gam_ngs_tpu.io import bgzf

    with open(bam_path, "rb") as fh:
        comp = fh.read()
    # BGZF block table: (file_offset, uncompressed_start)
    starts_c, starts_u = [], []
    off = ucum = 0
    while off < len(comp):
        xlen = struct.unpack_from("<H", comp, off + 10)[0]
        eo, end = off + 12, off + 12 + xlen
        bsize = None
        while eo < end:
            si1, si2 = comp[eo], comp[eo + 1]
            slen = struct.unpack_from("<H", comp, eo + 2)[0]
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack_from("<H", comp, eo + 4)[0] + 1
            eo += 4 + slen
        isize = struct.unpack_from("<I", comp, off + bsize - 4)[0]
        starts_c.append(off)
        starts_u.append(ucum)
        off += bsize
        ucum += isize

    def voff(u):
        k = bisect.bisect_right(starts_u, u) - 1
        return (starts_c[k] << 16) | (u - starts_u[k])

    _REF_CONSUME = {0: 1, 2: 1, 3: 1, 7: 1, 8: 1}  # M D N = X

    raw = bgzf.read_file(bam_path)
    (l_text,) = struct.unpack_from("<i", raw, 4)
    p = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", raw, p)
    p += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", raw, p)
        p += 8 + l_name
    # per ref: {bin: [[chunk_beg, chunk_end], ...]}, linear index list
    bins = [dict() for _ in range(n_ref)]
    lidx = [[] for _ in range(n_ref)]
    while p < len(raw):
        (bs,) = struct.unpack_from("<i", raw, p)
        rid, pos, bin_mq_nl, flag_nc = struct.unpack_from(
            "<iiII", raw, p + 4)
        if 0 <= rid < n_ref and pos >= 0:
            n_cigar = flag_nc & 0xFFFF
            l_read_name = bin_mq_nl & 0xFF
            cp = p + 36 + l_read_name
            span = 0
            for k in range(n_cigar):
                (cig,) = struct.unpack_from("<I", raw, cp + 4 * k)
                span += (cig >> 4) * _REF_CONSUME.get(cig & 0xF, 0)
            end_pos = pos + max(span, 1)
            b = _reg2bin(pos, end_pos)
            v0, v1 = voff(p), voff(p + 4 + bs)
            runs = bins[rid].setdefault(b, [])
            if runs and runs[-1][1] == v0:
                runs[-1][1] = v1        # extend the current chunk run
            else:
                runs.append([v0, v1])
            li = lidx[rid]
            for w in range(pos >> 14, ((end_pos - 1) >> 14) + 1):
                while len(li) <= w:
                    li.append(0)
                if li[w] == 0 or v0 < li[w]:
                    li[w] = v0
        p += 4 + bs

    out = [b"BAI\x01", struct.pack("<i", n_ref)]
    for r in range(n_ref):
        out.append(struct.pack("<i", len(bins[r])))
        for b in sorted(bins[r]):
            runs = bins[r][b]
            out.append(struct.pack("<Ii", b, len(runs)))
            for v0, v1 in runs:
                out.append(struct.pack("<QQ", v0, v1))
        li = lidx[r]
        # carry-fill empty windows with the previous window's offset
        # (samtools semantics: ioffset is monotone non-decreasing)
        prev = 0
        for w in range(len(li)):
            if li[w] == 0:
                li[w] = prev
            prev = li[w]
        out.append(struct.pack("<i", len(li)))
        for v in li:
            out.append(struct.pack("<Q", v))
    with open(bam_path + ".bai", "wb") as fh:
        fh.write(b"".join(out))


def parity_problems():
    """Banded-SW parity set: (main, negative-begin) problem lists.

    main: 48 problems in one padded bucket (XW=256) mixing force_start /
    force_end / N codes / indels; x_size <= FORCE_MAXGAP_LEN force_end
    windows, where the reference's unsigned bound (banded_smith_
    waterman.cc:201) must null the alignment; force_start lanes
    crossing the FORCE_MAXGAP_LEN fresh/forced boundary (:116); short
    windows (x_size 11..40).  neg: 16 begin_a < 0 tail windows
    (PctgBuilder.cc:1549), kept apart so the main set also runs as a
    batch of ordinary problems only."""
    rng = np.random.default_rng(7)
    main, neg = [], []
    for k in range(48):
        n = int(rng.integers(180, 250))
        a = rng.integers(0, 5, size=n).astype(np.uint8)
        b = a.copy()
        noise = rng.random(n) < 0.08
        b[noise] = (b[noise] + 1 + rng.integers(0, 3, noise.sum())) % 4
        if k % 3 == 0:  # indel
            cut = n // 2
            b = np.concatenate([b[:cut], b[cut + 7:]]).astype(np.uint8)
        fs, fe = k % 4 == 1, k % 4 == 2
        eb = len(b) - 1
        if k % 6 == 5:  # force_end underflow window (x_size <= 10)
            eb = int(rng.integers(1, 10))
            fe = True
        elif k % 6 == 4:  # short window
            eb = int(rng.integers(11, 40))
        main.append((a, 0, n - 1, b, 0, eb, fs, fe))
    for k in range(16):
        n = int(rng.integers(150, 240))
        a = rng.integers(0, 4, size=n).astype(np.uint8)
        b = np.concatenate([rng.integers(0, 4, 40).astype(np.uint8),
                            a[:170].copy()])
        ba = -int(rng.integers(5, 80))
        neg.append((a, ba, n - 1, b, 0, len(b) - 1, False, k % 2 == 0))
    return main, neg


def bucket_problems(rng: np.random.Generator, x_size: int, n: int,
                    band: int = 150):
    """n random band-width problems of one window length: a noisy copy
    of `a` with indels, so the optimum stays inside the band."""
    out = []
    for k in range(n):
        a = rng.integers(0, 4, size=x_size + 40).astype(np.uint8)
        b = a[20:20 + x_size].copy()
        flip = rng.random(x_size) < 0.05
        b[flip] = (b[flip] + 1) % 4
        if x_size > 60:
            cut = int(rng.integers(10, x_size - 20))
            b = np.concatenate([b[:cut], b[cut + 3:], a[:3]]).astype(
                np.uint8)
        out.append((a, 0, len(a) - 1, b, 0, len(b) - 1, k % 5 == 1,
                    k % 7 == 2))
    return out


def same_alignment(got, want, lean: bool) -> bool:
    """Exact agreement on score, begins, homology, length and, with the
    edit string fetched, the edits; lean results on first/last match."""
    from gam_ngs_tpu.ops.editops import first_match_pos, last_match_pos

    same = (got.score == want.score and got.begin_a == want.begin_a
            and got.begin_b == want.begin_b
            and got.homology == want.homology
            and got.length == want.length)
    if lean:
        return (same and first_match_pos(got) == first_match_pos(want)
                and last_match_pos(got) == last_match_pos(want))
    if want.edits is not None and got.edits is not None:
        return same and list(got.edits) == list(want.edits)
    return same
