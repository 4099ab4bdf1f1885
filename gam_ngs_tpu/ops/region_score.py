"""Batched junction-evidence counting — graph edge weighting on device.

The reference weighs every compact-graph edge by re-opening BAM regions
and counting F-oriented paired reads whose mate should cross the
junction (getLibRegionScore, CompactAssemblyGraph.cc:361-530) — one
mutex-guarded BamReader scan per (edge, library).  Here every
(edge, library) job is a contiguous slice of the HBM-resident
coordinate-sorted alignment table; all jobs (across every compact graph
of the run) are concatenated into ONE flat row stream and counted by a
single jitted dispatch returning one stacked (3, J) array — one
upload, one kernel, one download.

Layout: rows are laid out (R/LANES, LANES) (a 2-D form kept from the
first device this ran on; ROADMAP S6 measures it on the GPU).  Jobs
are contiguous row runs, so the segment reduction is a per-row cumsum,
an exclusive cumsum of row totals, and two J-sized gathers — no
scatter.
Job scalars are expanded to per-row arrays on the host (cheap numpy
broadcasts) instead of a device gather.  Row and job counts pad to
powers of two so the whole pipeline compiles O(log) distinct shapes.
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np

from ..io.bam import FMREVERSE, FMUNMAP, FPAIRED, FREVERSE

XT_U = ord("U")

# bytes-on-wire observability (models/merge snapshots these and records
# DELTAS in metrics, so multiple merges per process stay attributable):
# payload bytes uploaded per count_jobs call, dispatch count, the
# one-time resident-arena column uploads, and per-shape first-call
# seconds ("compile_s": trace + XLA compile or persistent-cache load +
# async dispatch — the cache hit/miss evidence; warm shapes cost ~0).
WIRE = {"bytes_up": 0, "dispatches": 0, "arena_bytes_up": 0,
        "shapes": [], "compile_s": {}}
_SHAPES_CAP = 256  # bound the in-process shape log


def _note_shape(shape: tuple, dt: float) -> None:
    if len(WIRE["shapes"]) < _SHAPES_CAP:
        WIRE["shapes"].append(shape)
    key = "x".join(str(s) for s in shape)
    if key not in WIRE["compile_s"] and len(WIRE["compile_s"]) < _SHAPES_CAP:
        WIRE["compile_s"][key] = round(dt, 3)


def use_resident() -> bool:
    """Device-resident region tables (SURVEY.md §2.7 "HBM region
    tables"): the coord-sorted alignment columns upload ONCE per table
    (cached on the table object), and every edge-weighting dispatch
    ships only per-job row RANGES + scalars (~32 B/job) instead of a
    row-copy payload (~26 B/row, tens of MB per run).  GAM_RESIDENT=0
    restores the payload path."""
    v = os.environ.get("GAM_RESIDENT")
    if v is not None:
        return v != "0"
    return True

_ROW_FIELDS = ("pos", "end_pos", "flag", "nh", "xt", "ref_id",
               "mate_ref", "mate_pos", "goodq")
_ROW_DTYPES = {"flag": np.uint16, "nh": np.uint16, "xt": np.uint8,
               "goodq": np.uint8}
_SCA_FIELDS = ("s1", "s2", "t", "max_insert", "seq_len", "no_mult")

LANES = 512

# Row cap per dispatch: bounds the int32 cumsum (cap * max-overlap
# 2^21 * ~2^9 < 2^31) and keeps every compiled shape small.
ROW_CAP = 1 << 21

# Hard bound on the int32 overlap cumsum within one dispatch: the
# summed overlap `ov` equals the FULL read length when a read ends
# inside the region, so long-read BAMs (10kb+ records) could overflow
# the row cap's short-read assumption.  Chunks are split when the
# host-side worst-case sum of read lengths exceeds this; a single job
# beyond it is counted exactly on the host instead.
OV_CAP = 1 << 30


@functools.lru_cache(maxsize=64)
def _count_kernel(R: int, J: int):
    import jax
    import jax.numpy as jnp

    assert R % LANES == 0
    R2 = R // LANES

    def f(pos, end_pos, flag, nh, xt, ref_id, mate_ref, mate_pos, goodq,
          valid, s1, s2, t, max_insert, seq_len, no_mult, starts, ends):
        """All row arrays (R2, LANES), flat row k at [k // LANES,
        k % LANES]; starts/ends (J,) int32 flat row offsets per job.
        Narrow fields (flag/nh uint16, xt/goodq/no_mult/valid uint8)
        upload at their wire width — the payload is the dominant cost
        of the partition phase on thin host->device links — and are
        widened here.

        Returns (3, J) int32 — good_reads, exp_reads, num_reads: the
        three accumulators of the reference's region loop.
        """
        flag = flag.astype(jnp.int32)
        nh = nh.astype(jnp.int32)
        xt = xt.astype(jnp.int32)
        goodq = goodq.astype(jnp.int32)
        no_mult = no_mult.astype(jnp.int32)
        valid = valid.astype(jnp.int32)
        rl = end_pos - pos
        end_read = pos + rl - 1
        end_mate = mate_pos + rl - 1

        paired = (flag & FPAIRED) != 0
        fwd = (flag & FREVERSE) == 0
        munmap = (flag & FMUNMAP) != 0
        mrev = (flag & FMREVERSE) != 0
        uniq = (no_mult != 0) | ((nh == 1) & (xt == XT_U))
        in_range = (pos >= s1) & (pos <= s2)

        base = (valid != 0) & (goodq != 0) & paired & uniq & in_range & fwd
        read_overlap = jnp.where(end_read > s2, s2 - pos + 1, rl)

        diff_ref = ref_id != mate_ref
        mate_crosses = end_mate >= t

        c1 = base & munmap
        c2 = base & ~munmap & diff_ref
        c2_exp = c2 & (pos + max_insert < seq_len)
        c3 = base & ~munmap & ~diff_ref & ~mrev & mate_crosses
        c4 = base & ~munmap & ~diff_ref & mrev & mate_crosses

        ov = read_overlap
        exp_m = jnp.where(c1 | c2_exp | c3 | c4, ov, 0)
        good_m = jnp.where(c4, ov, 0)
        num_m = jnp.where(c1 | c2 | c3 | c4, 1, 0)

        def jsum(v2):
            cr = jnp.cumsum(v2, axis=1)          # within-row inclusive
            row_tot = cr[:, -1]
            offs = jnp.cumsum(row_tot) - row_tot  # (R2,) exclusive
            c2d = cr + offs[:, None]              # global inclusive csum

            def at(idx):  # global inclusive csum at flat idx-1 (0 if 0)
                i = (idx - 1) // LANES
                j = (idx - 1) % LANES
                return jnp.where(idx > 0, c2d[i, j], 0)

            return at(ends) - at(starts)

        return jnp.stack([jsum(good_m), jsum(exp_m), jsum(num_m)])

    return jax.jit(f)


def _pow2(n: int, floor: int) -> int:
    return max(floor, 1 << int(np.ceil(np.log2(max(1, n)))))


# ---------------------------------------------------------------------------
# Device-resident arena path
# ---------------------------------------------------------------------------

def _host_cols(mb, lib: int):
    """Library `lib`'s coord-sorted columns on the HOST, cached on the
    table object (tables are replaced wholesale on ranged re-ingest, so
    object identity is the correct cache key).

    Narrow layout: pos/end_pos/mate_pos int32 + ONE uint8 bit-plane
    (paired, reverse, mate-unmapped, mate-reverse, nh==1&XT:U, goodq,
    ref!=mate_ref — everything getLibRegionScore reads from flags/tags,
    CompactAssemblyGraph.cc:361-530) = 13 B/row.  Also holds the int64
    prefix sum of read lengths (the OV_CAP overflow guard needs
    per-job Σrl in O(1)).

    Only the UNION of the job row ranges is ever shipped to the device
    (_count_jobs_resident coalesces them): junction regions are sparse
    — measured <1% of rows at 10 Mbp — so uploading full tables spent
    ~40 MB of thin-link bandwidth for ~100 KB of useful rows."""
    t = mb.files[lib].table
    cols = getattr(t, "_resident_cols", None)
    if cols is not None:
        return cols
    order = mb.coord_order(lib)
    pos = np.ascontiguousarray(t.pos[order], np.int32)
    end = np.ascontiguousarray(t.end_pos[order], np.int32)
    mate = np.ascontiguousarray(t.mate_pos[order], np.int32)
    flag = t.flag[order]
    bits = (((flag & FPAIRED) != 0) * 1
            | ((flag & FREVERSE) != 0) * 2
            | ((flag & FMUNMAP) != 0) * 4
            | ((flag & FMREVERSE) != 0) * 8
            | ((t.nh[order] == 1) & (t.xt[order] == XT_U)) * 16
            | (t.is_good_quality()[order] != 0) * 32
            | (t.ref_id[order] != t.mate_ref_id[order]) * 64
            ).astype(np.uint8)
    rlp = np.zeros(len(pos) + 1, np.int64)
    np.cumsum(np.clip(end.astype(np.int64) - pos, 0, None), out=rlp[1:])
    cols = (pos, end, mate, bits, rlp)
    t._resident_cols = cols
    return cols


def _resident_kernel_raw(R: int, J: int, T2: int):
    """Count kernel against the resident arena: per-dispatch inputs are
    just (starts, ends, lo) row ranges + per-job scalars; row fields
    gather from the (T2, LANES) resident columns on device."""
    import jax
    import jax.numpy as jnp

    assert R % LANES == 0
    R2 = R // LANES
    TMAX = T2 * LANES - 1

    def f(apos, aend, amate, abits, starts, ends, lo,
          s1, s2, t, max_insert, seq_len, no_mult):
        slot = (jax.lax.broadcasted_iota(jnp.int32, (R2, LANES), 0) * LANES
                + jax.lax.broadcasted_iota(jnp.int32, (R2, LANES), 1))
        job = jnp.searchsorted(ends, slot, side="right").astype(jnp.int32)
        jobc = jnp.clip(job, 0, J - 1)
        st = starts[jobc]
        en = ends[jobc]
        in_job = (slot >= st) & (slot < en)
        row = jnp.clip(lo[jobc] + (slot - st), 0, TMAX)
        ri, rj = row // LANES, row % LANES
        pos = apos[ri, rj]
        end_pos = aend[ri, rj]
        mate_pos = amate[ri, rj]
        bits = abits[ri, rj].astype(jnp.int32)
        s1j = s1[jobc]
        s2j = s2[jobc]
        tj = t[jobc]
        mij = max_insert[jobc]
        slj = seq_len[jobc]
        nmj = no_mult[jobc]

        rl = end_pos - pos
        end_read = pos + rl - 1
        end_mate = mate_pos + rl - 1
        paired = (bits & 1) != 0
        fwd = (bits & 2) == 0
        munmap = (bits & 4) != 0
        mrev = (bits & 8) != 0
        uniq = (nmj != 0) | ((bits & 16) != 0)
        goodq = (bits & 32) != 0
        diff_ref = (bits & 64) != 0
        in_range = (pos >= s1j) & (pos <= s2j)

        base = in_job & goodq & paired & uniq & in_range & fwd
        read_overlap = jnp.where(end_read > s2j, s2j - pos + 1, rl)
        mate_crosses = end_mate >= tj
        c1 = base & munmap
        c2 = base & ~munmap & diff_ref
        c2_exp = c2 & (pos + mij < slj)
        c3 = base & ~munmap & ~diff_ref & ~mrev & mate_crosses
        c4 = base & ~munmap & ~diff_ref & mrev & mate_crosses
        ov = read_overlap
        exp_m = jnp.where(c1 | c2_exp | c3 | c4, ov, 0)
        good_m = jnp.where(c4, ov, 0)
        num_m = jnp.where(c1 | c2 | c3 | c4, 1, 0)

        def jsum(v2):
            cr = jnp.cumsum(v2, axis=1)
            row_tot = cr[:, -1]
            offs = jnp.cumsum(row_tot) - row_tot
            c2d = cr + offs[:, None]

            def at(idx):
                i = (idx - 1) // LANES
                j = (idx - 1) % LANES
                return jnp.where(idx > 0, c2d[i, j], 0)

            return at(ends) - at(starts)

        return jnp.stack([jsum(good_m), jsum(exp_m), jsum(num_m)])

    return f


@functools.lru_cache(maxsize=64)
def _resident_kernel(R: int, J: int, T2: int):
    import jax

    return jax.jit(_resident_kernel_raw(R, J, T2))


@functools.lru_cache(maxsize=16)
def _resident_kernel_meshed(R: int, J: int, T2: int, mesh_key):
    """shard_map'd resident count: the arena columns are REPLICATED to
    every mesh device (P() specs) while the job axis shards — each
    device counts its own job group against its local arena copy, with
    no cross-chip traffic (jobs are independent, SURVEY.md §2.7)."""
    import jax
    from jax.sharding import PartitionSpec as P

    mesh = _MESHES[mesh_key]
    f = _resident_kernel_raw(R, J, T2)

    def local(apos, aend, amate, abits, starts, ends, lo,
              s1, s2, t, max_insert, seq_len, no_mult):
        res = f(apos, aend, amate, abits, starts[0], ends[0], lo[0],
                s1[0], s2[0], t[0], max_insert[0], seq_len[0],
                no_mult[0])
        return res[None]

    d = mesh.axis_names
    rep = P(None, None)
    job = P(d, None)
    return jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(rep,) * 4 + (job,) * 9,
        out_specs=P(d, None, None), check_vma=False))


_MESHES: dict = {}  # mesh registry so lru_cache keys stay hashable


def _materialize_resident(job: dict) -> dict:
    """Row-copy view of a resident range job (host-exact fallback)."""
    mb, lib = job["_mb"], job["lib"]
    t = mb.files[lib].table
    rows = mb.coord_order(lib)[job["lo"]:job["hi"]]
    return dict(
        pos=t.pos[rows], end_pos=t.end_pos[rows], flag=t.flag[rows],
        nh=t.nh[rows], xt=t.xt[rows], ref_id=t.ref_id[rows],
        mate_ref=t.mate_ref_id[rows], mate_pos=t.mate_pos[rows],
        goodq=t.is_good_quality()[rows],
        **{k: job[k] for k in _SCA_FIELDS})


def _count_jobs_resident(jobs: list[dict], mesh=None, defer: bool = False):
    """count_jobs against the device-resident arena: one searchsorted +
    four column gathers replace the per-row payload upload.  With a
    mesh, chunks dispatch in groups of n via shard_map (one chunk per
    device, arena replicated).

    defer=True returns a zero-arg finisher instead of results: every
    chunk is DISPATCHED (async) before returning, and the finisher
    forces the device->host fetches — the caller overlaps the device
    work + link round-trip with host work (run_merge fetches after
    load_seqs)."""
    import jax.numpy as jnp

    # coalesce the jobs' row ranges per table: only the UNION of
    # touched rows is shipped (junction regions are sparse — full
    # tables wasted ~400x the bytes at 10 Mbp)
    ranges: dict[int, list[tuple[int, int]]] = {}
    cols_of: dict[int, tuple] = {}
    for j in jobs:
        t = j["_mb"].files[j["lib"]].table
        if id(t) not in cols_of:
            cols_of[id(t)] = _host_cols(j["_mb"], j["lib"])
            ranges[id(t)] = []
        if j["hi"] > j["lo"]:
            ranges[id(t)].append((j["lo"], j["hi"]))

    # runs[tid] = coalesced ascending disjoint (lo, hi, arena_base)
    runs: dict[int, list[tuple[int, int, int]]] = {}
    total = 0
    for tid, rs_ in ranges.items():
        out = []
        for lo, hi in sorted(rs_):
            if out and lo <= out[-1][1]:
                if hi > out[-1][1]:
                    total += hi - out[-1][1]
                    out[-1] = (out[-1][0], hi, out[-1][2])
            else:
                out.append((lo, hi, total))
                total += hi - lo
        runs[tid] = out

    def arena_base(tid: int, lo: int) -> int:
        import bisect

        rr = runs[tid]
        k = bisect.bisect_right(rr, (lo, 1 << 62, 0)) - 1
        r_lo, _r_hi, r_base = rr[k]
        return r_base + (lo - r_lo)

    lens = [j["hi"] - j["lo"] for j in jobs]
    weights = []
    abs_lo = []
    for j in jobs:
        t = j["_mb"].files[j["lib"]].table
        rlp = cols_of[id(t)][4]
        weights.append(int(rlp[j["hi"]] - rlp[j["lo"]]))
        abs_lo.append(arena_base(id(t), j["lo"])
                      if j["hi"] > j["lo"] else 0)

    Tpad = _pow2(max(total, 1), LANES)
    T2 = Tpad // LANES

    arena = None  # built lazily (host-only fallback never pays it)

    def get_arena():
        nonlocal arena
        if arena is None:
            cat = []
            for k in range(4):
                dt = np.uint8 if k == 3 else np.int32
                buf = np.zeros(Tpad, dt)
                for tid, rr in runs.items():
                    col = cols_of[tid][k]
                    for lo, hi, bs in rr:
                        buf[bs:bs + hi - lo] = col[lo:hi]
                WIRE["arena_bytes_up"] += buf.nbytes
                cat.append(jnp.asarray(buf.reshape(T2, LANES)))
            arena = cat
        return arena

    results: list = [None] * len(jobs)
    n_dev = 1 if mesh is None else int(mesh.devices.size)
    # with a mesh, aim for >= n_dev chunks so every device gets one
    row_cap = ROW_CAP if n_dev <= 1 else min(
        ROW_CAP, max(LANES, -(-sum(lens) // n_dev)))
    chunk: list[int] = []
    chunk_rows = 0
    chunk_w = 0
    chunks: list[list[int]] = []
    for k, n in enumerate(lens):
        if weights[k] > OV_CAP:
            results[k] = _count_job_host(_materialize_resident(jobs[k]))
            continue
        if chunk and (chunk_rows + n > row_cap
                      or chunk_w + weights[k] > OV_CAP):
            chunks.append(chunk)
            chunk, chunk_rows, chunk_w = [], 0, 0
        chunk.append(k)
        chunk_rows += n
        chunk_w += weights[k]
    if chunk:
        chunks.append(chunk)

    def pack_chunk(idxs, R, J):
        starts = np.zeros(J, np.int32)
        ends = np.zeros(J, np.int32)
        lo = np.zeros(J, np.int32)
        sca = {f: np.zeros(J, np.int32) for f in _SCA_FIELDS}
        off = 0
        for jj, k in enumerate(idxs):
            starts[jj] = off
            off += lens[k]
            ends[jj] = off
            lo[jj] = abs_lo[k]
            for f in _SCA_FIELDS:
                sca[f][jj] = jobs[k][f]
        starts[len(idxs):] = off
        ends[len(idxs):] = off
        arrs = [starts, ends, lo] + [sca[f] for f in _SCA_FIELDS]
        WIRE["bytes_up"] += sum(a.nbytes for a in arrs)
        return arrs

    pending: list[tuple] = []
    if n_dev > 1 and chunks:
        # one chunk per mesh device, arena replicated, no cross-chip
        # traffic; groups pad to a common (R, J) so one executable
        # serves the whole group.  The mesh cache keys on a stable
        # descriptor (axis names + device ids), not id(mesh): id reuse
        # after GC would silently alias distinct meshes.
        key = (tuple(mesh.axis_names),
               tuple(d.id for d in mesh.devices.flat))
        _MESHES[key] = mesh
        for g in range(0, len(chunks), n_dev):
            grp = chunks[g:g + n_dev]
            R = max(_pow2(sum(lens[k] for k in c), LANES) for c in grp)
            J = max(_pow2(len(c), 8) for c in grp)
            stacked = [np.zeros((n_dev, J), np.int32) for _ in range(9)]
            for gi, idxs in enumerate(grp):
                for ai, a in enumerate(pack_chunk(idxs, R, J)):
                    stacked[ai][gi] = a
            kern = _resident_kernel_meshed(R, J, T2, key)
            WIRE["dispatches"] += 1
            t0 = time.perf_counter()
            res = kern(*get_arena(), *stacked)
            _note_shape((R, J, T2, n_dev), time.perf_counter() - t0)
            pending.append((grp, res))

        def _finish_meshed():
            for grp, res in pending:
                resh = np.asarray(res)  # (n_dev, 3, J)
                for gi, idxs in enumerate(grp):
                    for jj, k in enumerate(idxs):
                        results[k] = (int(resh[gi, 0, jj]),
                                      int(resh[gi, 1, jj]),
                                      int(resh[gi, 2, jj]))
            return results

        return _finish_meshed if defer else _finish_meshed()

    for idxs in chunks:
        rows_total = sum(lens[k] for k in idxs)
        R = _pow2(rows_total, LANES)
        J = _pow2(len(idxs), 8)
        arrs = pack_chunk(idxs, R, J)
        kern = _resident_kernel(R, J, T2)
        WIRE["dispatches"] += 1
        # the first call per shape pays trace + compile (or a
        # persistent-cache load) before its ASYNC dispatch returns —
        # timing it separates cache misses (compile seconds) from
        # hits (sub-second) in .metrics.json
        t0 = time.perf_counter()
        res = kern(*get_arena(), *arrs)
        _note_shape((R, J, T2), time.perf_counter() - t0)
        pending.append((idxs, res))  # fetch after every dispatch queued

    def _finish():
        for idxs, res in pending:
            resh = np.asarray(res)
            for jj, k in enumerate(idxs):
                results[k] = (int(resh[0, jj]), int(resh[1, jj]),
                              int(resh[2, jj]))
        return results

    return _finish if defer else _finish()


def _count_job_host(job: dict) -> tuple[int, int, int]:
    """Exact int64 host replica of the device kernel for one job —
    the overflow escape hatch for jobs whose Σ read lengths alone
    would exceed the int32 cumsum bound."""
    pos = np.asarray(job["pos"], np.int64)
    end_pos = np.asarray(job["end_pos"], np.int64)
    flag = np.asarray(job["flag"], np.int64)
    nh = np.asarray(job["nh"], np.int64)
    xt = np.asarray(job["xt"], np.int64)
    ref_id = np.asarray(job["ref_id"], np.int64)
    mate_ref = np.asarray(job["mate_ref"], np.int64)
    mate_pos = np.asarray(job["mate_pos"], np.int64)
    goodq = np.asarray(job["goodq"], bool)

    rl = end_pos - pos
    end_read = pos + rl - 1
    end_mate = mate_pos + rl - 1
    paired = (flag & FPAIRED) != 0
    fwd = (flag & FREVERSE) == 0
    munmap = (flag & FMUNMAP) != 0
    mrev = (flag & FMREVERSE) != 0
    uniq = bool(job["no_mult"]) | ((nh == 1) & (xt == XT_U))
    in_range = (pos >= job["s1"]) & (pos <= job["s2"])

    base = goodq & paired & uniq & in_range & fwd
    ov = np.where(end_read > job["s2"], job["s2"] - pos + 1, rl)

    diff_ref = ref_id != mate_ref
    mate_crosses = end_mate >= job["t"]
    c1 = base & munmap
    c2 = base & ~munmap & diff_ref
    c2_exp = c2 & (pos + job["max_insert"] < job["seq_len"])
    c3 = base & ~munmap & ~diff_ref & ~mrev & mate_crosses
    c4 = base & ~munmap & ~diff_ref & mrev & mate_crosses

    good = int(ov[c4].sum())
    exp = int(ov[c1 | c2_exp | c3 | c4].sum())
    num = int((c1 | c2 | c3 | c4).sum())
    return good, exp, num


def count_jobs(jobs: list[dict], mesh=None, defer: bool = False):
    """Count junction evidence for a list of jobs in ONE device pass
    (per ROW_CAP chunk).

    Each job: dict with row-array views (pos, end_pos, flag, nh, xt,
    ref_id, mate_ref, mate_pos, goodq — np arrays of the region rows)
    and scalars (s1, s2, t, max_insert, seq_len, no_mult) — OR the
    resident-range form (_mb, lib, lo, hi + the scalars), which counts
    against the device-resident arena without a row payload.
    Returns (good_reads, exp_reads, num_reads) per job, in order;
    defer=True returns a zero-arg finisher (dispatches now, fetches at
    the finisher call) instead.
    """
    if not jobs:
        return (lambda: []) if defer else []
    if "_mb" in jobs[0]:
        return _count_jobs_resident(jobs, mesh=mesh, defer=defer)

    lens = [len(j["pos"]) for j in jobs]
    # worst-case int32 cumsum contribution per job = Σ read lengths
    # (ov <= rl); used to split chunks before the kernel can overflow
    weights = [
        int(np.clip(np.asarray(j["end_pos"], np.int64)
                    - np.asarray(j["pos"], np.int64), 0, None).sum())
        for j in jobs]

    results: list = [None] * len(jobs)

    # chunk at job boundaries so each dispatch stays under ROW_CAP and
    # OV_CAP; a job that alone exceeds OV_CAP is counted on the host
    # (exact int64 numpy — junction regions are insert-sized, so this
    # path only triggers on extreme long-read coverage)
    chunk: list[int] = []
    chunk_rows = 0
    chunk_w = 0
    chunks: list[list[int]] = []
    for k, n in enumerate(lens):
        if weights[k] > OV_CAP:
            results[k] = _count_job_host(jobs[k])
            continue
        if chunk and (chunk_rows + n > ROW_CAP
                      or chunk_w + weights[k] > OV_CAP):
            chunks.append(chunk)
            chunk, chunk_rows, chunk_w = [], 0, 0
        chunk.append(k)
        chunk_rows += n
        chunk_w += weights[k]
    if chunk:
        chunks.append(chunk)
    for idxs in chunks:
        total = sum(lens[k] for k in idxs)
        R = _pow2(total, LANES)
        J = _pow2(len(idxs), 8)

        flat = {f: np.zeros(R, _ROW_DTYPES.get(f, np.int32))
                for f in _ROW_FIELDS}
        valid = np.zeros(R, np.uint8)
        sca_rows = {f: np.zeros(R, np.uint8 if f == "no_mult"
                                else np.int32) for f in _SCA_FIELDS}
        starts = np.zeros(J, np.int32)
        ends = np.zeros(J, np.int32)

        off = 0
        for j, k in enumerate(idxs):
            job = jobs[k]
            n = lens[k]
            for f in _ROW_FIELDS:
                v = job[f]
                if f == "nh":
                    # uint16 wire width: clip so oversized NH tags
                    # cannot wrap onto the ==1 uniqueness test
                    v = np.clip(v, 0, 65535)
                flat[f][off:off + n] = v
            valid[off:off + n] = 1
            for f in _SCA_FIELDS:
                sca_rows[f][off:off + n] = job[f]
            starts[j] = off
            ends[j] = off + n
            off += n
        # padding rows have valid=0: masked out of every count and
        # outside every [start, end) run

        def two_d(a):
            return a.reshape(R // LANES, LANES)

        WIRE["bytes_up"] += (sum(v.nbytes for v in flat.values())
                             + valid.nbytes
                             + sum(v.nbytes for v in sca_rows.values())
                             + starts.nbytes + ends.nbytes)
        WIRE["dispatches"] += 1
        kern = _count_kernel(R, J)
        res = np.asarray(kern(
            two_d(flat["pos"]), two_d(flat["end_pos"]),
            two_d(flat["flag"]), two_d(flat["nh"]), two_d(flat["xt"]),
            two_d(flat["ref_id"]), two_d(flat["mate_ref"]),
            two_d(flat["mate_pos"]), two_d(flat["goodq"]), two_d(valid),
            two_d(sca_rows["s1"]), two_d(sca_rows["s2"]),
            two_d(sca_rows["t"]), two_d(sca_rows["max_insert"]),
            two_d(sca_rows["seq_len"]), two_d(sca_rows["no_mult"]),
            starts, ends))
        for j, k in enumerate(idxs):
            results[k] = (int(res[0, j]), int(res[1, j]), int(res[2, j]))
    # the payload path fetches eagerly (it is the GAM_RESIDENT=0
    # fallback); defer just wraps the finished results
    return (lambda: results) if defer else results
