"""Device-side block construction: gam-create's compute core as JAX ops.

Reference semantics reproduced exactly:
  * Read::loadReadsMap  (/root/reference/lib/src/assembly/Read.cc:83)
  * Block::findBlocks   (/root/reference/lib/src/assembly/Block.cc:470)

The reference streams the slave BAM through a per-read hash-map lookup
and a sequential first-fit active-block list.  The device formulation
(SURVEY.md §2.3 / §7 phase 2) recasts the whole stream as array
programs over HBM-resident columns:

  1. JOIN — master and slave tables sort together by 128-bit read-name
     key (four uint32 sort keys + mate bit) in one stable multi-key
     `lax.sort`; a segmented forward-fill `associative_scan` propagates
     the latest master row to every slave row of the same key
     (last-write-wins, matching the reference's map insert order).
  2. RUN SEGMENTATION — a segmented running max of slave end
     coordinates splits the matched stream into independent *runs*
     (maximal slave-overlap chains).  No real block ever spans a run:
     extending a block needs `s_start <= block.s_end + 1`, and a run
     break means `s_start > max(previous s_end) + 1`.
  3. GROUP CHAIN ANALYSIS — within a run, reads group by master contig
     (a real block only absorbs reads of its own master contig).
     Segmented exclusive max/min scans over the group-sorted stream
     test, per read, whether it chain-extends the group's single
     growing block.  Groups where every read chains — the overwhelming
     majority — reduce to exactly one block via segment reductions; the
     rest (master-interval gaps = repeats/misjoins, or runs containing
     reads shorter than min-block-size, whose empty-block quirk couples
     groups) fall back to an exact host scan over a tiny residue.
  4. ORDERING — the reference emits a block when a later read's
     first-fit walk passes it while out of scope, and flushes the
     remainder in list order.  Equivalently: block B (creation rank
     r_B, permanently out of scope from stream index t_B) is emitted at
     the first read index >= t_B whose own match position exceeds r_B
     (reads that create a new block, or seed the trailing empty slot,
     pass the whole list).  That index is found for all blocks at once
     with a vectorized segment-tree first-exceed query, and blocks sort
     by (emit index, rank) — byte-identical output order.

Why runs are independent: an active block's slave frame end only grows
by absorbing an in-scope read, so at a run break every existing block
is permanently out of scope (or on an earlier contig) and can never
match again; the only state crossing the break is the at-most-one
trailing *empty* active block (created by an unmatched read shorter
than min-block-size, Block.cc:49), which the very next unmatched read
seeds unconditionally — runs containing short reads are handled by the
exact host scan, threading the empty-slot carry bit between consecutive
short runs, and a consumed carry only renames the next run's first
block seed (plus counting its strand evidence, findBlocks :540).
"""

from __future__ import annotations

import functools

import numpy as np

_NEG = -(2 ** 30)
_POS = 2 ** 30
_INF = np.int64(2 ** 62)


# ---------------------------------------------------------------------------
# device kernels
# ---------------------------------------------------------------------------

@functools.cache
def _kernels():
    import jax
    import jax.numpy as jnp

    def seg_scan_max(seg, val):
        def comb(a, b):
            return (b[0],
                    jnp.where(a[0] == b[0], jnp.maximum(a[1], b[1]), b[1]))

        return jax.lax.associative_scan(comb, (seg, val))[1]

    def exclusive(seg, incl, fill):
        prev = jnp.concatenate([jnp.full((1,), fill, incl.dtype), incl[:-1]])
        same = jnp.concatenate([jnp.zeros((1,), bool), seg[1:] == seg[:-1]])
        return jnp.where(same, prev, fill)

    @jax.jit
    def join(m_first, m_h2hi, m_h2lo, m_h1hi, m_h1lo,
             s_first, s_h2hi, s_h2lo, s_h1hi, s_h1lo):
        """For every slave row: index of the master row with the same
        (name-hash, mate) key — last occurrence in master stream order,
        as the reference's hash-map overwrite — or -1."""
        nm = m_first.shape[0]
        ns = s_first.shape[0]
        k0 = jnp.concatenate([m_first, s_first])
        k1 = jnp.concatenate([m_h2hi, s_h2hi])
        k2 = jnp.concatenate([m_h2lo, s_h2lo])
        k3 = jnp.concatenate([m_h1hi, s_h1hi])
        k4 = jnp.concatenate([m_h1lo, s_h1lo])
        tag = jnp.concatenate([jnp.zeros(nm, jnp.uint32),
                               jnp.ones(ns, jnp.uint32)])
        pos = jnp.arange(nm + ns, dtype=jnp.int32)
        # one stable multi-key sort: equal keys keep masters (tag 0)
        # first, in original stream order (stability)
        k0, k1, k2, k3, k4, stag, spos = jax.lax.sort(
            (k0, k1, k2, k3, k4, tag, pos), num_keys=6, is_stable=True)

        diff = ((k0[1:] != k0[:-1]) | (k1[1:] != k1[:-1])
                | (k2[1:] != k2[:-1]) | (k3[1:] != k3[:-1])
                | (k4[1:] != k4[:-1]))
        seg = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), jnp.cumsum(diff.astype(jnp.int32))])
        val = jnp.where(stag == 0, spos, jnp.int32(-1))

        def comb(a, b):
            sa, va = a
            sb, vb = b
            return (sb, jnp.where(vb >= 0, vb,
                                  jnp.where(sa == sb, va, jnp.int32(-1))))

        last_master = jax.lax.associative_scan(comb, (seg, val))[1]

        out = jnp.full((ns,), -1, jnp.int32)
        idx = jnp.where(stag == 1, spos - nm, ns)  # ns is out-of-bounds
        return out.at[idx].set(jnp.where(stag == 1, last_master, -1),
                               mode="drop")

    @jax.jit
    def analyze(s_ctg, s_start, s_end, m_ctg, m_begin, m_end):
        """Run segmentation + per-(run, master-contig) chain analysis.

        Coordinates are closed ([begin, end]).  Returns, over the
        matched stream: run_id (stream order), the (run, m_ctg)-sort
        permutation, group-start marks and per-read chain-ok flags
        (both in sorted order).  chain-ok: the read extends its group's
        single growing block, given every previous group read did.
        """
        n = s_ctg.shape[0]
        pos = jnp.arange(n, dtype=jnp.int32)

        # runs: segmented (by slave contig) running max of slave ends;
        # a contig change resets prev_max to _NEG, forcing a new run
        prev_max = exclusive(s_ctg, seg_scan_max(s_ctg, s_end),
                             jnp.int32(_NEG))
        new_run = (pos == 0) | (s_start > prev_max + 1)
        run_id = jnp.cumsum(new_run.astype(jnp.int32)) - 1

        run_s, mctg_s, pos_s, mb_s, me_s, ss_s, se_s = jax.lax.sort(
            (run_id, m_ctg, pos, m_begin, m_end, s_start, s_end),
            num_keys=2, is_stable=True)

        g_first = jnp.concatenate(
            [jnp.ones(1, bool),
             (run_s[1:] != run_s[:-1]) | (mctg_s[1:] != mctg_s[:-1])])
        gid = jnp.cumsum(g_first.astype(jnp.int32)) - 1

        gmax_me = exclusive(gid, seg_scan_max(gid, me_s), jnp.int32(_NEG))
        gmin_mb = -exclusive(gid, seg_scan_max(gid, -mb_s), jnp.int32(_NEG))
        gmax_se = exclusive(gid, seg_scan_max(gid, se_s), jnp.int32(_NEG))

        chain_ok = g_first | ((mb_s <= gmax_me + 1) & (me_s >= gmin_mb - 1)
                              & (ss_s <= gmax_se + 1))
        return run_id, pos_s, g_first, chain_ok

    return join, analyze


# ---------------------------------------------------------------------------
# exact host scan for the residue (short-read runs / non-chaining groups)
# ---------------------------------------------------------------------------

class _Blk:
    __slots__ = ("seed", "last", "cnt", "m_ctg", "m_begin", "m_end", "m_brl",
                 "s_ctg", "s_begin", "s_end", "s_brl", "pos", "neg")

    def __init__(self, seed, m_ctg, m_begin, m_end, m_len,
                 s_ctg, s_begin, s_end, s_len):
        self.seed = seed
        self.last = seed
        self.cnt = 1
        self.m_ctg = m_ctg
        self.m_begin = m_begin
        self.m_end = m_end
        self.m_brl = m_len
        self.s_ctg = s_ctg
        self.s_begin = s_begin
        self.s_end = s_end
        self.s_brl = s_len
        self.pos = 0
        self.neg = 0


def _exact_scan(idx, m_ctg, m_begin, m_end, m_len,
                s_ctg, s_start, s_end, s_len, conc,
                mbs: int, carry_in_empty: bool):
    """First-fit active-list scan (Block::findBlocks :528-577) over one
    residual slice, tracking block assignments rather than emitting.

    Returns (blocks, mr_seed, carry_out): blocks in creation order;
    mr_seed[i] = seed index of the real block read i walk-matched, or
    -1 when the read seeded a block / created an empty slot (its walk
    passed the whole list).  carry_out: an unseeded empty slot survives
    the slice.
    """
    blocks: list[_Blk] = []
    active: list[_Blk] = []  # creation order; pruned once out of scope
    has_empty = bool(carry_in_empty)
    n = len(idx)
    mr_seed = np.full(n, -1, np.int64)
    for i in range(n):
        sc, ss, se = int(s_ctg[i]), int(s_start[i]), int(s_end[i])
        mc, mb, me = int(m_ctg[i]), int(m_begin[i]), int(m_end[i])
        matched = None
        k = 0
        while k < len(active):
            b = active[k]
            if b.s_ctg < sc or b.s_end + 1 < ss:
                active.pop(k)  # permanently out of scope: never matches
                continue
            if (b.m_ctg == mc and mb <= b.m_end + 1 and me >= b.m_begin - 1
                    and b.s_ctg == sc and se >= b.s_begin - 1):
                matched = b
                break
            k += 1
        if matched is not None:
            b = matched
            b.cnt += 1
            b.m_brl += int(m_len[i])
            b.s_brl += int(s_len[i])
            if mb < b.m_begin:
                b.m_begin = mb
            if me > b.m_end:
                b.m_end = me
            if ss < b.s_begin:
                b.s_begin = ss
            if se > b.s_end:
                b.s_end = se
            if conc[i]:
                b.pos += 1
            else:
                b.neg += 1
            b.last = int(idx[i])
            mr_seed[i] = b.seed
        elif has_empty:
            # the trailing empty slot seeds unconditionally via addReads
            # — and that read's strand evidence counts (walk path)
            b = _Blk(int(idx[i]), mc, mb, me, int(m_len[i]),
                     sc, ss, se, int(s_len[i]))
            if conc[i]:
                b.pos += 1
            else:
                b.neg += 1
            blocks.append(b)
            active.append(b)
            has_empty = False
        elif int(m_len[i]) >= mbs and int(s_len[i]) >= mbs:
            # Block(mRead, sRead, minBlockSize) seeds; the seeding
            # read's strand evidence is NOT counted (findBlocks :577)
            b = _Blk(int(idx[i]), mc, mb, me, int(m_len[i]),
                     sc, ss, se, int(s_len[i]))
            blocks.append(b)
            active.append(b)
        else:
            has_empty = True
    return blocks, mr_seed, has_empty


# ---------------------------------------------------------------------------
# vectorized segment-tree: first index >= t with value > x
# ---------------------------------------------------------------------------

def _first_exceed(vals: np.ndarray, t: np.ndarray, x: np.ndarray
                  ) -> np.ndarray:
    """For each query q: min{ i >= t[q] : vals[i] > x[q] }, or len(vals)
    if none.  Lockstep segment-tree walk over all queries at once."""
    n = len(vals)
    nq = len(t)
    if nq == 0:
        return np.zeros(0, np.int64)
    p = 1
    while p < max(n, 1):
        p *= 2
    levels = [np.full(p, -_INF, np.int64)]
    levels[0][:n] = vals
    while len(levels[-1]) > 1:
        a = levels[-1]
        levels.append(np.maximum(a[0::2], a[1::2]))
    top = len(levels) - 1
    flat = np.concatenate(levels)
    off = np.zeros(top + 1, np.int64)
    for k in range(1, top + 1):
        off[k] = off[k - 1] + len(levels[k - 1])

    i = np.minimum(t, p).astype(np.int64)
    k = np.zeros(nq, np.int64)
    state = np.where(t >= n, 2, 0)  # 0=walk up, 1=descend, 2=done
    ans = np.full(nq, n, np.int64)

    for _ in range(4 * (top + 1) + 4):
        up = state == 0
        if not up.any():
            break
        oor = up & (i >= (p >> k))
        state[oor] = 2
        up &= ~oor
        climb = up & (i % 2 == 0) & (k < top)
        k[climb] += 1
        i[climb] >>= 1
        chk = up & ~climb
        if chk.any():
            w = np.nonzero(chk)[0]
            hit = flat[off[k[w]] + i[w]] > x[w]
            state[w[hit]] = 1
            i[w[~hit]] += 1

    for _ in range(top + 1):
        d = state == 1
        if not d.any():
            break
        fin = d & (k == 0)
        ans[fin] = i[fin]
        state[fin] = 2
        d &= ~fin
        if d.any():
            k[d] -= 1
            i[d] <<= 1
            w = np.nonzero(d)[0]
            left_fail = flat[off[k[w]] + i[w]] <= x[w]
            i[w[left_fail]] += 1
    return np.minimum(ans, n)


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------

def _pad_pow2(n: int, lo: int = 1024) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _split_u64(h: np.ndarray):
    h = h.astype(np.uint64)
    return ((h >> np.uint64(32)).astype(np.uint32),
            (h & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def find_blocks_device(m_cols: tuple, s_cols: tuple, min_block_size: int,
                       stats: dict | None = None) -> dict:
    """loadReadsMap + findBlocks over columnar streams, device-first.

    m_cols/s_cols: (h1 u64, h2 u64, first u8, ctg i32, pos i32, end i32,
    rev u8) of good-quality uniquely-mapped reads in merged coordinate
    order.  Returns the same columns dict as the native scan, rows in
    the reference's exact emission order.
    """
    local = local_block_arrays(m_cols, s_cols, min_block_size,
                               carry_in=False, stats=stats)
    return finalize_emission([local], int(min_block_size))


def local_block_arrays(m_cols: tuple, s_cols: tuple, min_block_size: int,
                       carry_in: bool = False,
                       stats: dict | None = None) -> dict:
    """Per-shard block construction: everything except emission order.

    Multi-host create shards the slave stream at contig boundaries
    (runs never span a contig — see module docstring); `carry_in` is
    the predecessor shard's trailing empty-slot bit.  Returns a dict of
    creation-order block arrays (b_*), per-matched-read walk-match
    seeds (mr_seed), per-block emission-query start (t_b, local stream
    index), the matched-stream length n, and carry_out — all with
    LOCAL (0-based) stream indices; the distributed combiner offsets
    them before finalize_emission.
    """
    mbs = int(min_block_size)
    mh1, mh2, mfirst, mctg, mpos, mend, mrev = [np.asarray(c) for c in m_cols]
    sh1, sh2, sfirst, sctg, spos, ssend, srev = [np.asarray(c) for c in s_cols]
    nm, ns = len(mh1), len(sh1)
    if nm == 0 or ns == 0:
        return _empty_local(carry_in)
    join, analyze = _kernels()

    # ---- 1. device join
    m2hi, m2lo = _split_u64(mh2)
    m1hi, m1lo = _split_u64(mh1)
    s2hi, s2lo = _split_u64(sh2)
    s1hi, s1lo = _split_u64(sh1)

    def padu(a, n, fill=0):
        out = np.full(n, fill, np.uint32)
        out[:len(a)] = a
        return out

    pm, ps = _pad_pow2(nm), _pad_pow2(ns)
    midx = np.asarray(join(
        padu(mfirst.astype(np.uint32), pm, 0xFFFFFFFF),
        padu(m2hi, pm), padu(m2lo, pm), padu(m1hi, pm), padu(m1lo, pm),
        padu(sfirst.astype(np.uint32), ps, 0xFFFFFFFE),
        padu(s2hi, ps), padu(s2lo, ps), padu(s1hi, ps), padu(s1lo, ps),
    ))[:ns]

    sel = np.nonzero(midx >= 0)[0]
    n = len(sel)
    if n == 0:
        return _empty_local(carry_in)
    mi = midx[sel]
    r_sctg = sctg[sel].astype(np.int32)
    r_sstart = spos[sel].astype(np.int32)
    r_send = (ssend[sel] - 1).astype(np.int32)       # closed end
    r_slen = (ssend[sel] - spos[sel]).astype(np.int32)
    r_mctg = mctg[mi].astype(np.int32)
    r_mbegin = mpos[mi].astype(np.int32)
    r_mend = (mend[mi] - 1).astype(np.int32)
    r_mlen = (mend[mi] - mpos[mi]).astype(np.int32)
    conc = ((mrev[mi] != 0) == (srev[sel] != 0))
    short = (r_mlen < mbs) | (r_slen < mbs)

    # ---- 2+3. device run/group analysis
    pn = _pad_pow2(n)

    def padi(a, fill):
        out = np.full(pn, fill, np.int32)
        out[:n] = a
        return out

    run_id, perm, g_first, chain_ok = (np.asarray(a) for a in analyze(
        padi(r_sctg, _POS), padi(r_sstart, 0), padi(r_send, 0),
        padi(r_mctg, _POS), padi(r_mbegin, 0), padi(r_mend, 0)))
    run_id = run_id[:n]
    sp = perm[:n].astype(np.int64)        # sorted order -> stream index
    g_first = g_first[:n]
    chain_ok = chain_ok[:n]

    # ---- group / run reductions (int64-exact, vectorized)
    starts = np.nonzero(g_first)[0]
    ends = np.append(starts[1:], n)
    ngrp = len(starts)
    g_cnt = (ends - starts).astype(np.int64)
    g_seed = sp[starts]
    g_last = sp[ends - 1]
    g_m_begin = np.minimum.reduceat(r_mbegin[sp], starts)
    g_m_end = np.maximum.reduceat(r_mend[sp], starts)
    g_s_begin = np.minimum.reduceat(r_sstart[sp], starts)
    g_s_end = np.maximum.reduceat(r_send[sp], starts)
    g_mbrl = np.add.reduceat(r_mlen[sp].astype(np.int64), starts)
    g_sbrl = np.add.reduceat(r_slen[sp].astype(np.int64), starts)
    g_pos = np.add.reduceat(conc[sp].astype(np.int64), starts)
    g_chain = np.logical_and.reduceat(chain_ok, starts)
    g_mctg = r_mctg[g_seed]
    g_sctg = r_sctg[g_seed]

    run_first = np.nonzero(np.diff(run_id, prepend=np.int32(-1)))[0]
    nruns = len(run_first)
    run_end = np.append(run_first[1:], n)
    run_short = np.logical_or.reduceat(short, run_first)
    g_run = run_id[g_seed]
    g_simple = g_chain & ~run_short[g_run]
    residual_groups = np.nonzero(~g_simple & ~run_short[g_run])[0]

    # ---- carry chain over short runs (exact scan per short run); the
    # incoming bit of run 0 is the predecessor SHARD's trailing slot
    carry_out = np.zeros(nruns, bool)
    res_blocks: list[_Blk] = []
    mr_seed = np.full(n, -1, np.int64)

    for r in np.nonzero(run_short)[0].tolist():
        lo, hi = int(run_first[r]), int(run_end[r])
        cin = bool(carry_in if r == 0
                   else run_short[r - 1] and carry_out[r - 1])
        blks, mrs, co = _exact_scan(
            np.arange(lo, hi), r_mctg[lo:hi], r_mbegin[lo:hi],
            r_mend[lo:hi], r_mlen[lo:hi], r_sctg[lo:hi], r_sstart[lo:hi],
            r_send[lo:hi], r_slen[lo:hi], conc[lo:hi], mbs, cin)
        carry_out[r] = co
        res_blocks.extend(blks)
        mr_seed[lo:hi] = mrs

    # all-long runs immediately following a carrying short run (or the
    # shard head, when the carry bit arrives from the previous shard)
    # consume the empty slot with their first matched read
    prev_short = np.concatenate([[carry_in], run_short[:-1]])
    prev_carry = np.concatenate([[carry_in], carry_out[:-1]])
    consumed_heads = run_first[(~run_short) & prev_short & prev_carry]
    consumed_set = set(consumed_heads.tolist())

    # non-simple all-long groups: exact scan per group (no empty slots —
    # every read is long enough to seed — except a consumed carry)
    for g in residual_groups.tolist():
        lo, hi = int(starts[g]), int(ends[g])
        rows = sp[lo:hi]
        blks, mrs, _ = _exact_scan(
            rows, r_mctg[rows], r_mbegin[rows], r_mend[rows], r_mlen[rows],
            r_sctg[rows], r_sstart[rows], r_send[rows], r_slen[rows],
            conc[rows], mbs, int(g_seed[g]) in consumed_set)
        res_blocks.extend(blks)
        mr_seed[rows] = mrs

    # ---- simple groups: one block each, fully vectorized
    simple = np.nonzero(g_simple)[0]
    s_seed = g_seed[simple]
    seed_conc = conc[s_seed].astype(np.int64)
    carried = np.isin(s_seed, consumed_heads) if len(consumed_heads) \
        else np.zeros(len(simple), bool)
    # the seeding read's evidence does not count unless it seeded a
    # carried empty slot (walk path, findBlocks :540)
    sg_pos = g_pos[simple] - np.where(carried, 0, seed_conc)
    sg_neg = (g_cnt - g_pos)[simple] - np.where(carried, 0, 1 - seed_conc)

    gid_sorted = np.repeat(np.arange(ngrp), g_cnt)
    in_simple = g_simple[gid_sorted]
    mr_seed[sp[in_simple]] = np.repeat(g_seed, g_cnt)[in_simple]
    mr_seed[s_seed] = -1

    if stats is not None:
        stats["matched_reads"] = int(n)
        stats["runs"] = int(nruns)
        stats["groups"] = int(ngrp)
        stats["simple_groups"] = int(len(simple))
        stats["residual_reads"] = int(np.sum(run_short[run_id])) + int(
            np.sum(g_cnt[residual_groups]))

    # ---- combined block arrays (creation order within the shard)
    nres = len(res_blocks)
    nsimp = len(simple)
    nb = nres + nsimp
    carry_out_global = bool(nruns > 0 and run_short[-1] and carry_out[-1])
    if nb == 0:
        out = _empty_local(carry_out_global)
        out["n"] = n
        out["mr_seed"] = mr_seed
        return out

    def col(attr, dtype, simple_arr):
        a = np.empty(nb, dtype)
        a[:nres] = [getattr(b, attr) for b in res_blocks]
        a[nres:] = simple_arr
        return a

    b_sctg = col("s_ctg", np.int32, g_sctg[simple])
    b_send = col("s_end", np.int32, g_s_end[simple])
    b_last = col("last", np.int64, g_last[simple])

    # the emission-query start is local-computable even under sharding:
    # shards split at slave-contig boundaries, so the first stream index
    # past a block's scope either lies inside this shard or is exactly
    # the shard end (the next shard starts a strictly greater contig)
    key = r_sctg.astype(np.int64) * (2 ** 33) + r_sstart.astype(np.int64)
    t_b = np.maximum(
        np.searchsorted(key, b_sctg.astype(np.int64) * (2 ** 33)
                        + b_send.astype(np.int64) + 2, side="left"),
        b_last + 1)

    return dict(
        n=n,
        carry_out=carry_out_global,
        mr_seed=mr_seed,
        t_b=t_b,
        b_seed=col("seed", np.int64, s_seed),
        b_last=b_last,
        b_cnt=col("cnt", np.int64, g_cnt[simple]),
        b_mctg=col("m_ctg", np.int32, g_mctg[simple]),
        b_mbegin=col("m_begin", np.int32, g_m_begin[simple]),
        b_mend=col("m_end", np.int32, g_m_end[simple]),
        b_mbrl=col("m_brl", np.int64, g_mbrl[simple]),
        b_sctg=b_sctg,
        b_sbegin=col("s_begin", np.int32, g_s_begin[simple]),
        b_send=b_send,
        b_sbrl=col("s_brl", np.int64, g_sbrl[simple]),
        b_pos=col("pos", np.int64, sg_pos),
        b_neg=col("neg", np.int64, sg_neg),
    )


def finalize_emission(locals_list: list[dict], min_block_size: int) -> dict:
    """Exact emission order over one or more shard-local results.

    Shards must be passed in slave-stream order; per-shard stream
    indices (b_seed, b_last, t_b, mr_seed) are offset by the matched
    counts of the preceding shards, then the global first-exceed query
    reproduces the reference's block emission order across shard
    boundaries (a block retired near a shard's end is emitted by a
    read of a LATER shard — findBlocks :528-577 walk semantics).
    """
    mbs = int(min_block_size)
    offs = np.cumsum([0] + [p["n"] for p in locals_list])

    def cat(keyname, off_by=None):
        arrs = []
        for k, p in enumerate(locals_list):
            a = p[keyname]
            if off_by is not None and len(a):
                if keyname == "mr_seed":
                    a = np.where(a >= 0, a + offs[k], a)
                else:
                    a = a + offs[k]
            arrs.append(a)
        return np.concatenate(arrs) if arrs else np.zeros(0, np.int64)

    b_cnt = cat("b_cnt")
    nb = len(b_cnt)
    if nb == 0:
        return _empty_cols()
    b_seed = cat("b_seed", off_by=True)
    b_last = cat("b_last", off_by=True)
    t_b = cat("t_b", off_by=True)
    mr_seed = cat("mr_seed", off_by=True)
    n = int(offs[-1])

    # ---- 4. exact emission order
    order_by_seed = np.argsort(b_seed, kind="stable")
    rank_of = np.empty(nb, np.int64)
    rank_of[order_by_seed] = np.arange(nb)
    seed_sorted = b_seed[order_by_seed]

    # per-read match rank: rank of the walk-matched block, else +inf
    mr_rank = np.full(n, _INF, np.int64)
    has_m = mr_seed >= 0
    mr_rank[has_m] = np.searchsorted(seed_sorted, mr_seed[has_m])

    emit = _first_exceed(mr_rank, t_b, rank_of)
    order = np.lexsort((rank_of, emit))
    order = order[b_cnt[order] >= mbs]

    b_pos = cat("b_pos")
    b_neg = cat("b_neg")
    return dict(
        num_reads=b_cnt[order],
        m_ctg=cat("b_mctg")[order],
        m_begin=cat("b_mbegin")[order],
        m_end=cat("b_mend")[order],
        m_block_reads_len=cat("b_mbrl")[order].astype(np.uint64),
        s_ctg=cat("b_sctg")[order],
        s_strand=np.where(b_pos[order] >= b_neg[order],
                          ord("+"), ord("-")).astype(np.uint8),
        s_begin=cat("b_sbegin")[order],
        s_end=cat("b_send")[order],
        s_block_reads_len=cat("b_sbrl")[order].astype(np.uint64),
    )


def _empty_local(carry_out: bool) -> dict:
    return dict(
        n=0, carry_out=bool(carry_out),
        mr_seed=np.zeros(0, np.int64), t_b=np.zeros(0, np.int64),
        b_seed=np.zeros(0, np.int64), b_last=np.zeros(0, np.int64),
        b_cnt=np.zeros(0, np.int64),
        b_mctg=np.zeros(0, np.int32), b_mbegin=np.zeros(0, np.int32),
        b_mend=np.zeros(0, np.int32), b_mbrl=np.zeros(0, np.int64),
        b_sctg=np.zeros(0, np.int32), b_sbegin=np.zeros(0, np.int32),
        b_send=np.zeros(0, np.int32), b_sbrl=np.zeros(0, np.int64),
        b_pos=np.zeros(0, np.int64), b_neg=np.zeros(0, np.int64),
    )


def _empty_cols() -> dict:
    return dict(
        num_reads=np.zeros(0, np.int64),
        m_ctg=np.zeros(0, np.int32), m_begin=np.zeros(0, np.int32),
        m_end=np.zeros(0, np.int32),
        m_block_reads_len=np.zeros(0, np.uint64),
        s_ctg=np.zeros(0, np.int32), s_strand=np.zeros(0, np.uint8),
        s_begin=np.zeros(0, np.int32), s_end=np.zeros(0, np.int32),
        s_block_reads_len=np.zeros(0, np.uint64),
    )
