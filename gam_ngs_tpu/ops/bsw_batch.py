"""Batched banded Smith-Waterman — the device engine.

The reference kernel (banded_smith_waterman.cc:70) is an O(x_size × 301)
DP whose band row i depends on row i-1 (diag/up) and on the same row's
previous column (left).  Two forwards implement it:

  * on the GPU, the CUDA kernel of ops/bsw_cuda.cu: one warp per
    problem steps the band along anti-diagonals (no in-row dependency),
    then runs find-max and the traceback walk in the same launch;
  * everywhere (and as the plain version the kernel is measured
    against), `forward_builder`: rows are steps of a `lax.scan`, the
    in-row left dependency is a max-plus prefix composition via
    `lax.associative_scan`, and each cell's traceback decision is kept
    as one byte.  Device find-max and a lockstep walk complete it.

Problems are bucketed by padded (x, band-window) shape and batched along
the leading axis.  Cell values and traceback are bit-identical to
ops.bsw_ref (validated in tests/test_bsw_batch.py and the `gpu`-marked
tests).  `BswEngine.align_many` is the public batched API; the wavefront
scheduler (merge.scheduler) feeds it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from . import bsw_cuda
from .bsw_ref import (
    BSW_MAX_ALIGNMENT,
    DEFAULT_BAND_SIZE,
    FORCE_MAXGAP_LEN,
    GAP,
)
from .editops import GAP_A, GAP_B, MATCH, MISMATCH, Alignment

NEG = -(1 << 29)

_DIR_DIAG, _DIR_UP, _DIR_LEFT = 0, 1, 2

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_cache_enabled = False


def compilation_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else `<checkout>/.jax_cache`
    (gitignored).  The directory is part of the cache key, so it is
    fixed rather than derived from the machine."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_REPO, ".jax_cache"))


def enable_compilation_cache() -> None:
    """Persist compiled executables across processes on the GPU.

    JAX reads JAX_COMPILATION_CACHE_DIR itself; only when it is unset is
    the checkout's fixed directory configured here.  The CPU backend
    keeps no persistent cache: XLA:CPU executables embed the host's
    machine features, so a cache shared between hosts can SIGILL, and
    CPU compiles are cheap."""
    global _cache_enabled
    if _cache_enabled:
        return
    _cache_enabled = True
    import jax

    if jax.default_backend() == "cpu":
        return
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(compilation_cache_dir(), exist_ok=True)
        jax.config.update("jax_compilation_cache_dir",
                          compilation_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def _base_score(ac, bc):
    """SCORING_MATRIX via masks (A,T,C,G,N codes; N==4)."""
    import jax.numpy as jnp

    s = jnp.where(ac == bc, 5, -4)
    s = jnp.where((ac == 4) | (bc == 4), 0, s)
    s = jnp.where((ac == 4) & (bc == 4), 5, s)
    return s.astype(jnp.int32)


def forward_builder(B: int, XW: int, AW: int, band: int):
    """Build the (unjitted) batched forward-DP function for fixed shapes.

    Exposed so parallel.step can wrap it in a sharded jit; BswEngine
    builds its own dispatches around it.
    """
    import jax
    import jax.numpy as jnp

    YS = 2 * band + 1      # logical band width
    YP = -(-(YS + 1) // 128) * 128  # padded lanes (one extra for shifts)

    j_idx = jnp.arange(YP, dtype=jnp.int32)          # lane index
    in_band = j_idx < YS
    ymax = YS - 1

    def scan_combine(a, b):
        c1, s1 = a
        c2, s2 = b
        c = jnp.maximum(c2, jnp.maximum(s2 + c1, NEG))
        s = jnp.maximum(s1 + s2, NEG)
        return c, s

    def forward(a_win, b_win, begin_a, end_a, a_len, x_size,
                force_start):
        """Shapes: a_win (B, AW) uint8, b_win (B, XW) uint8, rest (B,) int32.

        a_win is the band-ALIGNED window: a_win[t, k] = a[begin_a-band+k]
        (sentinel 255 out of range), so row i's band characters are the
        contiguous slice a_win[:, i:i+YP] — a dynamic slice, no gather.
        Requires AW >= XW + YP.

        Returns dirs (B, XW, YP) uint8, last_row (B, YP) int32, and
        dvacc (B, YP) int32 — the pos_a==end_a diagonal accumulator in
        compact lane layout: lane jj holds the band cell of row
        i = end_a-begin_a+band - jj (each lane has exactly one writer
        row, so no overwrites; the host indexes dvacc[t, jj] directly).
        Only the 1-byte direction matrix is materialized per cell;
        score rows live in the scan carry, so HBM writes are ~1
        byte/cell instead of 5.
        """
        fs = force_start.astype(bool)
        jd_base = end_a - begin_a + band  # (B,) diag lane at row 0
        lane = jnp.arange(YP, dtype=jnp.int32)[None, :]

        def dv_update(i, row, dvacc):
            hit = lane == (jd_base[:, None] - i)
            return jnp.where(hit, row, dvacc)

        def a_char_at(i):
            # row i band chars = aligned-window slice [i, i+YP)
            return jax.lax.dynamic_slice_in_dim(a_win, i, YP, axis=1)

        def row0():
            pos = begin_a[:, None] - band + j_idx[None, :]
            bc = b_win[:, 0][:, None]
            ac = a_char_at(0)
            diag = _base_score(ac, bc)
            valid_pos = (pos >= 0) & (pos < a_len[:, None])
            # force_start lanes also bound pos < a_len (the reference
            # throws out_of_range there; see ops/bsw_ref.py)
            cond_a = jnp.where(fs[:, None],
                               (pos >= 0) & (pos <= FORCE_MAXGAP_LEN)
                               & (pos < a_len[:, None]),
                               valid_pos)
            cond_b = fs[:, None] & (pos > FORCE_MAXGAP_LEN) & (pos < a_len[:, None])
            allow_left = (pos > 0) & (j_idx[None, :] > 0)
            base_a = jnp.where(allow_left, jnp.maximum(diag, GAP),
                               jnp.maximum(GAP, diag))
            base_b = jnp.where(allow_left, diag, diag)
            base = jnp.where(cond_b, base_b, base_a)
            valid = (cond_a | cond_b) & in_band[None, :]
            c = jnp.where(valid, base, 0)
            # row-0 quirk: left is UNPENALIZED (sw[0][j-1], no gap; :120/:128)
            s = jnp.where(valid & allow_left, jnp.int32(0), jnp.int32(NEG))
            c, _ = jax.lax.associative_scan(scan_combine, (c, s), axis=1)
            row = jnp.where(valid, c, 0).astype(jnp.int32)
            return row, pos, diag, valid_pos

        def row_general(i, prev):
            pos = begin_a[:, None] + i + j_idx[None, :] - band
            bc = jax.lax.dynamic_slice_in_dim(b_win, i, 1, axis=1)
            ac = a_char_at(i)
            sc = _base_score(ac, bc)
            valid_pos = (pos >= 0) & (pos < a_len[:, None])

            prev_up = jnp.roll(prev, -1, axis=1)  # prev[j+1]
            is_last = j_idx[None, :] == ymax
            up = jnp.where(is_last, GAP, prev_up + GAP)

            pos0 = pos == 0
            fresh = jnp.where(fs[:, None], pos0 & (i <= FORCE_MAXGAP_LEN), pos0)
            fresh_forced = fs[:, None] & pos0 & (i > FORCE_MAXGAP_LEN)

            base_fresh = jnp.where(is_last, jnp.maximum(sc, GAP),
                                   jnp.maximum(jnp.maximum(sc, up), GAP))
            base_forced = jnp.where(is_last, sc, jnp.maximum(sc, up))
            diag_acc = prev + sc
            is_first = j_idx[None, :] == 0
            base_gen = jnp.where(is_last, diag_acc,
                                 jnp.maximum(diag_acc, up))
            allow_left_gen = ~is_first

            base = jnp.where(fresh, base_fresh,
                             jnp.where(fresh_forced, base_forced, base_gen))
            allow_left = jnp.where(fresh | fresh_forced, False, allow_left_gen)
            valid = valid_pos & in_band[None, :]

            c = jnp.where(valid, base, 0)
            s = jnp.where(valid & allow_left, jnp.int32(GAP), jnp.int32(NEG))
            c, _ = jax.lax.associative_scan(scan_combine, (c, s), axis=1)
            row = jnp.where(valid, c, 0).astype(jnp.int32)
            return row, pos, sc, diag_acc, up, fresh | fresh_forced, valid_pos

        def dirs_for_row(i, row, prev, pos, sc):
            """Traceback decisions for all cells of row i (x==i)."""
            x_pos = i  # scalar traced
            bcmp = row
            # pos == 0 branch
            left_blocked = fs[:, None] & (x_pos > FORCE_MAXGAP_LEN)
            is_last = j_idx[None, :] == ymax
            d_pos0 = jnp.where(
                bcmp == sc, _DIR_DIAG,
                jnp.where(is_last | ((bcmp == GAP) & ~left_blocked),
                          _DIR_LEFT, _DIR_UP))
            # general branch
            diag_t = jnp.where(x_pos > 0, prev, 0) + sc
            prev_up = jnp.roll(prev, -1, axis=1)
            up_t = jnp.where((x_pos > 0) & ~is_last, prev_up + GAP, GAP)
            up_t = jnp.where(
                fs[:, None] & (x_pos == 0),
                jnp.where((pos >= 0) & (pos <= FORCE_MAXGAP_LEN), GAP, NEG),
                up_t)
            is_first = j_idx[None, :] == 0
            mid = ~is_first & ~is_last
            d_gen = jnp.where(
                bcmp == diag_t, _DIR_DIAG,
                jnp.where(mid & (bcmp == up_t), _DIR_UP,
                          jnp.where(mid, _DIR_LEFT,
                                    jnp.where(~is_last, _DIR_UP, _DIR_LEFT))))
            return jnp.where(pos == 0, d_pos0, d_gen).astype(jnp.uint8)

        # row 0
        row0_val, pos0_, diag0, _vp0 = row0()
        dirs0 = dirs_for_row(0, row0_val, jnp.zeros_like(row0_val), pos0_,
                             diag0)

        def step(carry, i):
            prev, last_row, dvacc = carry
            row, pos, sc, _diag_acc, _up, _fresh, _vp = row_general(i, prev)
            d = dirs_for_row(i, row, prev, pos, sc)
            last_row = jnp.where((i == x_size - 1)[:, None], row, last_row)
            return (row, last_row, dv_update(i, row, dvacc)), d

        init_last = jnp.where((x_size == 1)[:, None], row0_val,
                              jnp.zeros_like(row0_val))
        dvacc0 = dv_update(0, row0_val, jnp.zeros_like(row0_val))
        (final_row, last_row, dvacc), dirs_rest = jax.lax.scan(
            step, (row0_val, init_last, dvacc0),
            jnp.arange(1, XW, dtype=jnp.int32))

        dirs = jnp.concatenate([dirs0[:, None, :],
                                jnp.moveaxis(dirs_rest, 0, 1)], axis=1)
        return dirs, last_row, dvacc

    return forward


@dataclass
class _Prep:
    """Host-side preprocessed problem."""
    empty: bool
    a: np.ndarray = None
    b: np.ndarray = None
    begin_a: int = 0
    end_a: int = 0
    begin_b: int = 0
    x_size: int = 0
    a_win: np.ndarray = None
    b_win: np.ndarray = None
    force_start: bool = False
    force_end: bool = False
    # resident-arena coordinates (ofs, length, rev) when both sequences
    # live in the engine's device sequence arena — the dispatch then
    # ships ~13 ints instead of the packed windows
    a_arena: tuple | None = None
    b_arena: tuple | None = None


def _prepare(a, begin_a, end_a, b, begin_b, end_b, force_start, force_end,
             band) -> _Prep:
    if end_b < begin_b:
        return _Prep(empty=True)
    if end_b >= len(b):
        end_b = len(b) - 1
    x_size = end_b - begin_b + 1
    x_size = min(x_size, len(a) + band - begin_a)
    x_size = min(x_size, BSW_MAX_ALIGNMENT)
    if x_size <= 0:
        return _Prep(empty=True)
    # band-ALIGNED window: a_win[k] = a[begin_a - band + k], sentinel 255
    start = begin_a - band
    width = x_size + 2 * band
    a_win = np.full(width, 255, np.uint8)
    lo = max(0, start)
    hi = min(len(a), start + width)
    if hi > lo:
        a_win[lo - start:hi - start] = a[lo:hi]
    b_win = np.ascontiguousarray(b[begin_b:begin_b + x_size])
    return _Prep(False, a, b, begin_a, end_a, begin_b, x_size, a_win,
                 b_win, force_start, force_end)


def _find_max_from(last_row, diag_vals, diag_is, p: _Prep, band: int):
    """Reference find-max over last row + pos_a==end_a diagonal."""
    y_size = 2 * band + 1
    found = False
    max_i = max_j = 0
    max_score = 0

    if not p.force_end:
        base = p.begin_a + (p.x_size - 1) - band
        for j in range(y_size):
            pos = base + j
            if 0 <= pos <= p.end_a:
                v = int(last_row[j])
                if not found or v > max_score:
                    found, max_i, max_j, max_score = True, p.x_size - 1, j, v

    # unsigned-underflow quirk: see ops/bsw_ref.py find_max
    fe_low_ok = p.x_size - 1 - FORCE_MAXGAP_LEN >= 0
    for k in range(len(diag_is)):
        i = int(diag_is[k])
        if (not p.force_end) or (fe_low_ok and
                                 p.x_size - 1 - FORCE_MAXGAP_LEN <= i < p.x_size):
            v = int(diag_vals[k])
            if not found or v > max_score:
                j = p.end_a - p.begin_a - i + band
                found, max_i, max_j, max_score = True, i, j, v
    return found, max_i, max_j, max_score


def _device_traceback_raw(B: int, XW: int, band: int, LMAX: int,
                          lean: bool = False):
    """Lockstep vectorized traceback walk over the XLA forward's byte
    directions (B, XW, YP).

    One lax.scan step = one walk step for every problem: a 3-element
    gather + arithmetic.  Returns the walk summary (11, B) int32 (final
    x/y, step count, match/gap counts, first/last-match walk
    coordinates) and, unless lean, the edit codes in walk order packed
    four per byte as (B, LMAX/4) uint8.  The merge only consumes the
    summary fields (merge/align.py), so lean is lossless for it.
    """
    import jax
    import jax.numpy as jnp

    assert LMAX % 4 == 0

    def walk(dirs, a_win, b_win, begin_a, x0, y0):
        tb = jnp.arange(B, dtype=jnp.int32)
        yp = dirs.shape[2]
        aw = a_win.shape[1]

        def step(carry, _):
            (x, y, active, cnt, matches, gapa, gapb, hasm, fmx, fmy,
             lmx, lmy) = carry
            d = dirs[tb, jnp.clip(x, 0, XW - 1),
                     jnp.clip(y, 0, yp - 1)].astype(jnp.int32)
            ca = a_win[tb, jnp.clip(x + y, 0, aw - 1)].astype(jnp.int32)
            cb = b_win[tb, jnp.clip(x, 0, XW - 1)].astype(jnp.int32)
            is_match = (ca == cb) | (ca == 4) | (cb == 4)
            edit = jnp.where(d == _DIR_DIAG,
                             jnp.where(is_match, MATCH, MISMATCH),
                             jnp.where(d == _DIR_UP, GAP_A, GAP_B))
            edit = jnp.where(active, edit, 0).astype(jnp.uint8)
            # walk order is reverse alignment order: the first match
            # seen is the alignment's LAST match, the last one seen is
            # its FIRST — latch both (walk coords; host converts)
            is_m = active & (d == _DIR_DIAG) & is_match
            fmx = jnp.where(is_m, x, fmx)
            fmy = jnp.where(is_m, y, fmy)
            lmx = jnp.where(is_m & ~hasm, x, lmx)
            lmy = jnp.where(is_m & ~hasm, y, lmy)
            hasm = hasm | is_m
            matches = matches + is_m.astype(jnp.int32)
            gapa = gapa + (active & (d == _DIR_UP)).astype(jnp.int32)
            gapb = gapb + (active & (d == _DIR_LEFT)).astype(jnp.int32)
            nx = jnp.where(active & (d != _DIR_LEFT), x - 1, x)
            ny = jnp.where(active,
                           jnp.where(d == _DIR_UP, y + 1,
                                     jnp.where(d == _DIR_LEFT, y - 1, y)),
                           y)
            npos = begin_a + nx + ny - band
            nactive = active & (nx >= 0) & (ny >= 0) & (npos >= 0)
            return (nx, ny, nactive, cnt + active.astype(jnp.int32),
                    matches, gapa, gapb, hasm, fmx, fmy, lmx, lmy), edit

        active0 = (x0 >= 0) & (y0 >= 0) & (begin_a + x0 + y0 - band >= 0)
        z = jnp.zeros(B, jnp.int32)
        (xf, yf, _, cnt, matches, gapa, gapb, hasm, fmx, fmy, lmx,
         lmy), edits = jax.lax.scan(
            step, (x0, y0, active0, z, z, z, z,
                   jnp.zeros(B, bool), z, z, z, z), None, length=LMAX)
        summary = jnp.stack([xf, yf, cnt, matches, gapa, gapb,
                             hasm.astype(jnp.int32), fmx, fmy, lmx, lmy])
        if lean:
            return summary, None
        e4 = edits.reshape(LMAX // 4, 4, B)
        packed = (e4[:, 0] | (e4[:, 1] << 2) | (e4[:, 2] << 4)
                  | (e4[:, 3] << 6)).astype(jnp.uint8)
        return summary, packed.T

    return walk


def _find_max_builder(band: int, YP: int):
    """Device find-max over last row + pos_a==end_a diagonal.

    Vectorized replica of _find_max_from with the reference's exact
    candidate order (banded_smith_waterman.cc:175-214): last-row cells
    j ascending first (skipped under force_end), then diagonal cells i
    ascending (force_end keeps only the trailing FORCE_MAXGAP_LEN+1
    rows).  Ties resolve to the FIRST candidate in that order — the
    argmax picks the minimum priority among max-value candidates.
    """
    import jax.numpy as jnp

    ys = 2 * band + 1
    BIG = jnp.int32(1 << 30)
    NEGB = jnp.int32(-(1 << 30))  # below every reachable cell score

    def findmax(last_row, dvacc, begin_a, end_a, x_size, fend):
        j = jnp.arange(YP, dtype=jnp.int32)[None, :]
        ba = begin_a[:, None]
        ea = end_a[:, None]
        xs = x_size[:, None]
        fe = fend[:, None] != 0
        # last-row candidates (priority j)
        posj = ba + (xs - 1) - band + j
        ok_lr = (~fe) & (j < ys) & (posj >= 0) & (posj <= ea)
        # diagonal candidates: lane jj holds row i = end_a-begin_a+band-jj
        i0 = jnp.maximum(ea - ba - band, 0)
        i_of = (ea - ba + band) - j
        # unsigned-underflow quirk (see ops/bsw_ref.py find_max): for
        # x_size <= FORCE_MAXGAP_LEN the reference's force_end window
        # bound wraps and excludes EVERY diagonal candidate
        ok_dg = ((j < ys) & (i_of >= i0) & (i_of < xs)
                 & ((~fe) | ((i_of >= xs - 1 - FORCE_MAXGAP_LEN)
                             & (xs - 1 - FORCE_MAXGAP_LEN >= 0))))
        v = jnp.concatenate([jnp.where(ok_lr, last_row, NEGB),
                             jnp.where(ok_dg, dvacc, NEGB)], axis=1)
        p = jnp.concatenate([jnp.where(ok_lr, j, BIG),
                             jnp.where(ok_dg, ys + i_of - i0, BIG)], axis=1)
        m = jnp.max(v, axis=1)
        found = jnp.any(jnp.concatenate([ok_lr, ok_dg], axis=1), axis=1)
        pw = jnp.min(jnp.where(v == m[:, None], p, BIG), axis=1)
        is_lr = pw < ys
        i_dg = i0[:, 0] + (pw - ys)
        max_i = jnp.where(is_lr, x_size - 1, i_dg)
        max_j = jnp.where(is_lr, pw, (end_a - begin_a + band) - i_dg)
        return (max_i.astype(jnp.int32), max_j.astype(jnp.int32), m,
                found)

    return findmax


def _traceback_native(dirs: np.ndarray, cpl: int, p: "_Prep", band: int,
                      max_i: int, max_j: int):
    """C++ traceback walk (gamio_traceback) over one problem's
    directions; None -> Python fallback."""
    if os.environ.get("GAM_NO_NATIVE"):
        return None
    from ..native.loader import traceback_native

    a = np.ascontiguousarray(p.a, np.uint8)
    b = np.ascontiguousarray(p.b, np.uint8)
    res = traceback_native(dirs, cpl, dirs.shape[1], band, max_i, max_j,
                           p.begin_a, p.begin_b, a, b)
    if res is None:
        return None
    edits, matches, x, pos = res
    return list(edits), matches, x, pos


def _traceback_from_dirs(dirs, p: _Prep, band: int, max_i: int, max_j: int
                         ) -> tuple[list[int], int, int, int]:
    a, b = p.a, p.b
    x, y = max_i, max_j
    pos = p.begin_a + x + y - band
    edits: list[int] = []
    matches = 0
    y_size = 2 * band + 1
    while x >= 0 and y >= 0 and pos >= 0:
        d = int(dirs[x, y])
        if d == _DIR_DIAG:
            ca = int(a[pos])
            cb = int(b[p.begin_b + x])
            if ca == cb or ca == 4 or cb == 4:
                edits.append(MATCH)
                matches += 1
            else:
                edits.append(MISMATCH)
            x -= 1
        elif d == _DIR_UP:
            edits.append(GAP_A)
            x -= 1
            y += 1
        else:
            edits.append(GAP_B)
            y -= 1
        pos = p.begin_a + x + y - band
    edits.reverse()
    return edits, matches, x, pos


def _unpack4(pk, width: int):
    """Inverse of BswEngine._pack4 inside a jit: (B, width/2) -> (B,
    width) uint8 base codes (out-of-range sentinel 15)."""
    import jax.numpy as jnp

    return jnp.stack([pk & 15, pk >> 4], axis=2).reshape(pk.shape[0], width)


class BswEngine:
    """Batched banded-SW with shape-bucketed compilation caching.

    backend: "cuda" = the GPU kernel (ops/bsw_cuda.cu; raises without a
    GPU); "xla" = the lax.scan forward + XLA find-max and walk; "auto" =
    cuda on a GPU, xla elsewhere.

    traceback: "device" walks on the device and fetches a summary per
    problem; "host" fetches the directions and walks in C++ (or
    Python); "auto" = device with the CUDA kernel, host otherwise.
    fetch: "lean" (walk summary only) | "edits" (plus the edit string) |
    "auto" = lean with the CUDA kernel.

    mesh: optional jax.sharding.Mesh — problem batches are sharded over
    every mesh device with shard_map (each device runs the forward on
    its slice; there is no cross-device traffic because alignment
    problems are independent, SURVEY.md §2.7).
    """

    def __init__(self, band: int = DEFAULT_BAND_SIZE,
                 max_batch: int | None = None,
                 hbm_budget_bytes: int = 2 << 30, backend: str = "auto",
                 mesh=None, traceback: str = "auto", fetch: str = "auto"):
        if backend not in ("auto", "xla", "cuda"):
            raise ValueError(f"unknown backend {backend!r}")
        self.band = band
        self.kernel = self._resolve_kernel(backend)  # "cuda" | "xla"
        if self.kernel == "cuda":
            bsw_cuda.check_band(band)
        self.fetch = fetch  # "lean" | "edits" | "auto"
        self.mesh = mesh
        if max_batch is None:
            # one problem per warp: a wide dispatch fills the card, the
            # XLA scan vectorizes over the batch instead
            max_batch = 1024 if self.kernel == "cuda" else 64
            if mesh is not None:
                max_batch *= int(mesh.devices.size)
        self.max_batch = max_batch
        self.hbm_budget = hbm_budget_bytes
        self.traceback = traceback  # "host" | "device" | "auto"
        self._mesh_cache: dict = {}
        # resident sequence arena (register_contigs): id(arr) ->
        # (ofs, len, rev); _seq_keep pins arena writers, _seq_refs pins
        # rev-view registrations (id-keyed caches must keep keys alive)
        self._seq_map: dict[int, tuple[int, int, int]] = {}
        self._seq_keep: list = []
        self._seq_refs: list = []
        self._arena_len = 0
        self._arena_dev = None
        self.cells_aligned = 0  # logical band cells processed (metrics)
        self.bytes_up = 0       # host->device payload bytes (metrics)
        self.dispatches = 0
        # ragged-batching utilization (SURVEY §7): live problems vs
        # padded batch rows, and live DP rows vs padded xw*B rows;
        # problems per window bucket and reference tail windows
        # (begin_a < 0) seen
        self.util = {"live": 0, "batch": 0, "rows_live": 0,
                     "rows_padded": 0, "neg_begin": 0}
        self.buckets: dict[int, int] = {}
        enable_compilation_cache()

    @staticmethod
    def _resolve_kernel(backend: str) -> str:
        if backend != "auto":
            return backend
        import jax

        return "cuda" if jax.default_backend() == "gpu" else "xla"

    def _resolve_traceback(self) -> str:
        if self.traceback != "auto":
            return self.traceback
        return "device" if self.kernel == "cuda" else "host"

    def _resolve_lean(self) -> bool:
        if self.fetch != "auto":
            return self.fetch == "lean"
        return self.kernel == "cuda"

    @property
    def _yp(self) -> int:
        """Padded band lanes of the XLA forward (one extra for shifts);
        also the a-window slack of every bucket (>= 2*band + 1)."""
        return -(-(2 * self.band + 2) // 128) * 128

    # ---- resident sequence arena -------------------------------------
    # Registering the assemblies ONCE puts a 4-bit packed arena of all
    # contigs in device memory; arena-resident problems then dispatch
    # ~13 scalars each and the fused jit gathers/complements the windows
    # on device (SURVEY §2.7 "HBM region tables" applied to the
    # sequences themselves).  Opt-in (GAM_ARENA=1, ROADMAP D2).

    def register_contigs(self, arrays) -> None:
        """Add contig code arrays to the device sequence arena.  Reverse
        orientations are served from the same bytes (io.fasta's
        memoized reverse_complement maps an rc array to its base; the
        device gather flips the index and complements the code)."""
        added = False
        for a in arrays:
            if len(a) == 0 or id(a) in self._seq_map:
                continue
            self._seq_map[id(a)] = (self._arena_len, len(a), 0)
            self._seq_keep.append(a)
            self._arena_len += int(len(a))
            added = True
        if added:
            self._arena_dev = None  # rebuild

    def _seq_lookup(self, arr):
        ent = self._seq_map.get(id(arr))
        if ent is not None:
            return ent
        from ..io.fasta import rc_source

        src = rc_source(arr)
        if src is not None:
            base = self._seq_map.get(id(src))
            if base is not None:
                ent = (base[0], base[1], base[2] ^ 1)
                self._seq_map[id(arr)] = ent
                self._seq_refs.append(arr)
                return ent
        return None

    def _arena_packed(self):
        if self._arena_dev is None:
            import jax.numpy as jnp

            # pad to 1 MB multiples: the arena size differs per corpus
            # anyway (one compile set per corpus)
            tp = max(1 << 20, -(-self._arena_len // (1 << 20)) << 20)
            flat = np.zeros(tp, np.uint8)
            for a in self._seq_keep:
                ofs, ln, _rev = self._seq_map[id(a)]
                flat[ofs:ofs + ln] = a
            pk = (flat[0::2] | (flat[1::2] << 4)).astype(np.uint8)
            self.bytes_up += pk.nbytes  # one-time upload
            self._arena_dev = jnp.asarray(pk)
        return self._arena_dev

    # ---- compiled dispatches -----------------------------------------

    def _shard(self, build_local, B: int, in_specs, out_specs):
        """jit(build_local(B)), or its shard_map over the mesh."""
        import jax

        if self.mesh is None:
            return jax.jit(build_local(B))
        n = int(self.mesh.devices.size)
        return jax.jit(jax.shard_map(
            build_local(B // n), mesh=self.mesh, in_specs=in_specs,
            out_specs=out_specs, check_vma=False))

    def _fused_core(self, Bl: int, xw: int, aw: int, lmax: int,
                    lean: bool):
        """(a_win, b_win, begin_a, end_a, a_len, x_size, fstart, fend)
        -> (summary (Bl, 13) int32, edits (Bl, lmax/4) uint8 | None):
        forward, find-max and walk for unpacked uint8 windows."""
        import jax.numpy as jnp

        band = self.band
        if self.kernel == "cuda":
            bsw_cuda.register()
            mode = bsw_cuda.MODE_LEAN if lean else bsw_cuda.MODE_EDITS

            def core(a8, b8, begin_a, end_a, a_len, x_size, fstart, fend):
                params = jnp.stack([begin_a, end_a, a_len, x_size, fstart,
                                    fend]).astype(jnp.int32)
                _d, _r, summary, edits = bsw_cuda.bsw_call(
                    a8, b8, params, band, mode, lmax // 4)
                return summary[:, :13], (None if lean else edits)

            return core
        fwd = forward_builder(Bl, xw, aw, band)
        findmax = _find_max_builder(band, self._yp)
        walk = _device_traceback_raw(Bl, xw, band, lmax, lean=lean)

        def core(a8, b8, begin_a, end_a, a_len, x_size, fstart, fend):
            dirs, last_row, dvacc = fwd(a8, b8, begin_a, end_a, a_len,
                                        x_size, fstart)
            x0, y0, score, found = findmax(last_row, dvacc, begin_a,
                                           end_a, x_size, fend)
            summ, edits = walk(dirs, a8, b8, begin_a,
                               jnp.where(found, x0, -1), y0)
            summary = jnp.concatenate(
                [summ, score[None], found.astype(jnp.int32)[None]]).T
            return summary, edits

        return core

    def _fused_align(self, B: int, xw: int, aw: int, lmax: int,
                     lean: bool = False, arena: bool = False):
        """ONE dispatch / ONE fetch per chunk: 4-bit unpack -> forward ->
        device find-max -> traceback walk in a single jit.  The
        direction planes never leave the device (they are transient
        inside the program); the host fetches the (B, 13) summary and,
        unless lean, the packed edit codes.

        arena=True builds the RESIDENT-ARENA variant: instead of packed
        window payloads the dispatch takes (ofs, len, rev) coordinates
        per problem plus the one-time 4-bit contig arena, and the jit
        gathers the windows on device (reverse orientations flip the
        index and complement codes 0..3 via XOR 1)."""
        tpk = int(self._arena_packed().shape[0]) if arena else 0
        key = ("fused", B, xw, aw, lmax, lean, tpk, arena)
        fn = self._mesh_cache.get(key)
        if fn is not None:
            return fn
        import jax.numpy as jnp

        band = self.band

        def build_local(Bl):
            core = self._fused_core(Bl, xw, aw, lmax, lean)

            def out(res):
                return res[0] if lean else res

            def fused(a_pk, b_pk, begin_a, end_a, a_len, x_size, fstart,
                      fend):
                return out(core(_unpack4(a_pk, aw), _unpack4(b_pk, xw),
                                begin_a, end_a, a_len, x_size, fstart,
                                fend))

            def fused_arena(arena_pk, a_ofs, a_len, a_rev, begin_a,
                            end_a, b_ofs, b_len, b_rev, begin_b, x_size,
                            fstart, fend):
                flat = arena_pk.astype(jnp.int32)

                def win(ofs, ln, rev, start, width, fill):
                    k = jnp.arange(width, dtype=jnp.int32)[None, :]
                    p = start[:, None] + k
                    rv = (rev[:, None] == 1)
                    idx = jnp.where(rv, ofs[:, None] + ln[:, None] - 1 - p,
                                    ofs[:, None] + p)
                    idxc = jnp.clip(idx, 0, 2 * tpk - 1)
                    c = (flat[idxc >> 1] >> ((idxc & 1) * 4)) & 15
                    c = jnp.where(rv & (c < 4), c ^ 1, c)
                    return jnp.where((p >= 0) & (p < ln[:, None]), c,
                                     fill).astype(jnp.uint8)

                a8 = win(a_ofs, a_len, a_rev, begin_a - band, aw, 15)
                bfull = win(b_ofs, b_len, b_rev, begin_b, xw, 0)
                xi = jnp.arange(xw, dtype=jnp.int32)[None, :]
                b8 = jnp.where(xi < x_size[:, None], bfull,
                               jnp.uint8(0))
                return out(core(a8, b8, begin_a, end_a, a_len, x_size,
                                fstart, fend))

            return fused_arena if arena else fused

        from jax.sharding import PartitionSpec as P

        bspec = P(self.mesh.axis_names) if self.mesh is not None else None
        in_specs = ((P(None),) + (bspec,) * 12) if arena else (bspec,) * 8
        out_specs = bspec if lean else (bspec, bspec)
        fn = self._shard(build_local, B, in_specs, out_specs)
        self._mesh_cache[key] = fn
        return fn

    def _forward_host(self, B: int, xw: int, aw: int):
        """Forward only, for the host walk: packed windows -> (dirs,
        last_row, dvacc).  dirs is (B, XW, YP) uint8 from the XLA scan
        or the kernel's (B, T, 32) uint16 step planes; last_row and
        dvacc are j-space rows (lane j = band diagonal)."""
        key = ("host", B, xw, aw)
        fn = self._mesh_cache.get(key)
        if fn is not None:
            return fn
        import jax.numpy as jnp

        band = self.band
        if self.kernel == "cuda":
            bsw_cuda.register()

        def build_local(Bl):
            fwd = (None if self.kernel == "cuda"
                   else forward_builder(Bl, xw, aw, band))

            def forward(a_pk, b_pk, begin_a, end_a, a_len, x_size,
                        fstart):
                a8, b8 = _unpack4(a_pk, aw), _unpack4(b_pk, xw)
                if fwd is not None:
                    return fwd(a8, b8, begin_a, end_a, a_len, x_size,
                               fstart)
                params = jnp.stack([begin_a, end_a, a_len, x_size, fstart,
                                    jnp.zeros_like(fstart)]
                                   ).astype(jnp.int32)
                dirs, rows, _s, _e = bsw_cuda.bsw_call(
                    a8, b8, params, band, bsw_cuda.MODE_FORWARD)
                return dirs, rows[:, 0], rows[:, 1]

            return forward

        from jax.sharding import PartitionSpec as P

        bspec = P(self.mesh.axis_names) if self.mesh is not None else None
        fn = self._shard(build_local, B, (bspec,) * 7, (bspec,) * 3)
        self._mesh_cache[key] = fn
        return fn

    @staticmethod
    def _pack4(win: np.ndarray) -> np.ndarray:
        """Two 4-bit base codes per byte (halves the upload); the 255
        out-of-range sentinel becomes 15 (still != every real code and
        != 4/N)."""
        w = np.minimum(win, 15)
        return (w[:, 0::2] | (w[:, 1::2] << 4)).astype(np.uint8)

    @staticmethod
    def _pad_dim(n: int) -> int:
        """Window buckets {128, 256, 384, 512, 768, 1024, ...}: a 128
        floor, then 1x/1.5x per octave.  The 1.5x intermediate sizes
        bound padding waste to <= 1.5x (worst-case row-fill 67% vs the
        pure-pow2 scheme's 50%, SURVEY §7 "ragged batching"); ~16
        distinct shapes to 32k, each compiled once per cache."""
        if n <= 128:
            return 128
        p = 256
        while True:
            if n <= p:
                return p
            if n <= p * 3 // 2:
                return p * 3 // 2
            p *= 2

    def _per_problem_bytes(self, xw: int, aw: int) -> int:
        """Device bytes one problem of this bucket holds in a dispatch
        (direction planes dominate)."""
        if self.kernel == "cuda":
            return (bsw_cuda.steps(xw, self.band) * 2 * bsw_cuda.LANES
                    + aw + xw)
        return xw * self._yp + aw + 5 * xw

    def align_one(self, a, begin_a, end_a, b, begin_b, end_b,
                  force_start=False, force_end=False) -> Alignment:
        return self.align_many(
            [(a, begin_a, end_a, b, begin_b, end_b, force_start, force_end)]
        )[0]

    def align_many(self, problems) -> list[Alignment]:
        preps = [_prepare(*pr[:6],
                          pr[6] if len(pr) > 6 else False,
                          pr[7] if len(pr) > 7 else False,
                          self.band) for pr in problems]
        out: list[Alignment | None] = [None] * len(preps)

        # bucket live problems by padded shapes
        live = [i for i, p in enumerate(preps) if not p.empty]
        for i, p in enumerate(preps):
            if p.empty:
                out[i] = Alignment()

        fused_path = self._resolve_traceback() == "device"
        buckets: dict[tuple[int, int, bool], list[int]] = {}
        for i in live:
            p = preps[i]
            if fused_path and self._seq_map:
                p.a_arena = self._seq_lookup(p.a)
                p.b_arena = self._seq_lookup(p.b)
            arena_ok = p.a_arena is not None and p.b_arena is not None
            xw = self._pad_dim(p.x_size)
            buckets.setdefault((xw, xw + self._yp, arena_ok), []).append(i)
            self.buckets[xw] = self.buckets.get(xw, 0) + 1
            self.util["neg_begin"] += p.begin_a < 0
        chunks: list[tuple[list[int], int, int, bool]] = []
        for (xw, aw, arena_ok), idxs in buckets.items():
            bmax = max(1, min(self.max_batch,
                              self.hbm_budget
                              // self._per_problem_bytes(xw, aw)))
            for k in range(0, len(idxs), bmax):
                chunks.append((idxs[k:k + bmax], xw, aw, arena_ok))

        if fused_path:
            # dispatch EVERY chunk before fetching any result: executions
            # queue on the device while the host packs the next chunk
            pending = [self._dispatch_fused(chunk, preps, xw, aw, arena)
                       for chunk, xw, aw, arena in chunks]
            for pend in pending:
                self._collect_fused(pend, preps, out)
        else:
            for chunk, xw, aw, _arena in chunks:
                self._run_chunk(chunk, preps, out, xw, aw)

        return out  # type: ignore[return-value]

    def _pad_batch(self, n: int) -> int:
        """Quantize batch sizes to {8,16,32,64,...} (per device when a
        mesh is set): every distinct batch shape is a separate compile
        of the dispatch, so a handful of sizes keeps compiles (and
        persistent-cache entries) reused across rounds and runs.
        Dummy rows are empty problems the host ignores."""
        n_dev = 1 if self.mesh is None else int(self.mesh.devices.size)
        per = -(-n // n_dev)
        b = 8
        while b < per:
            b *= 2
        return b * n_dev

    def _pack_chunk(self, chunk, preps, xw, aw):
        B = self._pad_batch(len(chunk))
        a_win = np.full((B, aw), 255, np.uint8)
        b_win = np.zeros((B, xw), np.uint8)
        begin_a = np.zeros(B, np.int32)
        end_a = np.zeros(B, np.int32)
        a_len = np.zeros(B, np.int32)
        x_size = np.zeros(B, np.int32)
        fstart = np.zeros(B, np.int32)
        fend = np.zeros(B, np.int32)
        for t, i in enumerate(chunk):
            p = preps[i]
            a_win[t, :len(p.a_win)] = p.a_win
            b_win[t, :len(p.b_win)] = p.b_win
            begin_a[t] = p.begin_a
            end_a[t] = p.end_a
            a_len[t] = len(p.a)
            x_size[t] = p.x_size
            fstart[t] = int(p.force_start)
            fend[t] = int(p.force_end)
        self.cells_aligned += int(x_size.sum()) * (2 * self.band + 1)
        self.util["live"] += len(chunk)
        self.util["batch"] += B
        self.util["rows_live"] += int(x_size.sum())
        self.util["rows_padded"] += B * xw
        return B, a_win, b_win, begin_a, end_a, a_len, x_size, fstart, fend

    def _pack_chunk_arena(self, chunk, preps, xw):
        """Scalar columns of an arena-resident chunk (no window
        payloads — the fused jit gathers them from the device arena)."""
        B = self._pad_batch(len(chunk))
        names = ("a_ofs", "a_len", "a_rev", "begin_a", "end_a", "b_ofs",
                 "b_len", "b_rev", "begin_b", "x_size", "fstart", "fend")
        cols = {k: np.zeros(B, np.int32) for k in names}
        for t, i in enumerate(chunk):
            p = preps[i]
            ao, al, ar = p.a_arena
            bo, bl, br = p.b_arena
            cols["a_ofs"][t] = ao
            cols["a_len"][t] = al
            cols["a_rev"][t] = ar
            cols["begin_a"][t] = p.begin_a
            cols["end_a"][t] = p.end_a
            cols["b_ofs"][t] = bo
            cols["b_len"][t] = bl
            cols["b_rev"][t] = br
            cols["begin_b"][t] = p.begin_b
            cols["x_size"][t] = p.x_size
            cols["fstart"][t] = int(p.force_start)
            cols["fend"][t] = int(p.force_end)
        self.cells_aligned += int(cols["x_size"].sum()) * (2 * self.band + 1)
        self.util["live"] += len(chunk)
        self.util["batch"] += B
        self.util["rows_live"] += int(cols["x_size"].sum())
        self.util["rows_padded"] += B * xw
        return B, [cols[k] for k in names]

    def _dispatch_fused(self, chunk, preps, xw, aw, arena: bool = False):
        """Upload + launch the fused forward/find-max/walk dispatch for
        one chunk; returns what _collect_fused needs WITHOUT forcing the
        device result (the fetch happens after every chunk is queued)."""
        lmax = -(-(2 * xw + 2 * self.band + 8) // 4) * 4
        lean = self._resolve_lean()
        if arena:
            B, cols = self._pack_chunk_arena(chunk, preps, xw)
            fn = self._fused_align(B, xw, aw, lmax, lean=lean, arena=True)
            self.bytes_up += 12 * 4 * B
            self.dispatches += 1
            return chunk, fn(self._arena_packed(), *cols), lean
        (B, a_win, b_win, begin_a, end_a, a_len, x_size, fstart,
         fend) = self._pack_chunk(chunk, preps, xw, aw)
        fn = self._fused_align(B, xw, aw, lmax, lean=lean)
        a_pk, b_pk = self._pack4(a_win), self._pack4(b_win)
        self.bytes_up += a_pk.nbytes + b_pk.nbytes + 8 * 4 * B
        self.dispatches += 1
        res = fn(a_pk, b_pk, begin_a, end_a, a_len, x_size, fstart, fend)
        return chunk, res, lean

    def _collect_fused(self, pend, preps, out):
        chunk, res, lean = pend
        if lean:
            summ, edits = np.asarray(res), None
        else:
            summ, edits = (np.asarray(r) for r in res)
        band = self.band
        for t, i in enumerate(chunk):
            p = preps[i]
            (xf, yf, n, matches, gapa, gapb, hasm, fmx, fmy, lmx, lmy,
             score, found) = (int(v) for v in summ[t, :13])
            if not found:
                out[i] = Alignment()
                continue
            ba = p.begin_a + xf + yf - band + 1
            bb = p.begin_b + xf + 1
            hom = 0.0 if n == 0 else matches * 100.0 / n
            if lean:
                if hasm:
                    fm = (True, (p.begin_a + fmx + fmy - band,
                                 p.begin_b + fmx))
                    lm = (True, (p.begin_a + lmx + lmy - band,
                                 p.begin_b + lmx))
                else:
                    # reference no-match fallbacks (my_alignment.cc:168/
                    # :229): first -> fully-advanced position, last ->
                    # the alignment begin
                    fm = (False, (ba + n - gapa, bb + n - gapb))
                    lm = (False, (ba, bb))
                out[i] = Alignment(
                    begin_a=ba, begin_b=bb, a_size=len(p.a),
                    b_size=len(p.b), score=score, homology=hom,
                    lean=(n, matches, fm, lm))
                continue
            col = edits[t, :(n + 3) // 4]
            codes = np.empty(len(col) * 4, np.uint8)
            for s in range(4):
                codes[s::4] = (col >> (2 * s)) & 3
            out[i] = Alignment(
                begin_a=ba, begin_b=bb, a_size=len(p.a), b_size=len(p.b),
                score=score, homology=hom,
                edits=np.ascontiguousarray(codes[:n][::-1]))

    def _run_chunk(self, chunk, preps, out, xw, aw):
        band = self.band
        (B, a_win, b_win, begin_a, end_a, a_len, x_size, fstart,
         _fend) = self._pack_chunk(chunk, preps, xw, aw)
        fwd = self._forward_host(B, xw, aw)
        self.dispatches += 1
        dirs, last_rows, dvacc = (np.asarray(r) for r in fwd(
            self._pack4(a_win), self._pack4(b_win), begin_a, end_a, a_len,
            x_size, fstart))
        cpl = bsw_cuda.cells_per_lane(band) if self.kernel == "cuda" else 0

        y_size = 2 * band + 1
        for t, i in enumerate(chunk):
            p = preps[i]
            lr = last_rows[t, :y_size]
            # pos_a == end_a diagonal cells (one deposit per row)
            if p.end_a >= p.begin_a + band:
                i0 = p.end_a - (p.begin_a + band)
            else:
                i0 = 0
            diag_is = []
            diag_vals = []
            ii = i0
            jj = p.end_a - p.begin_a - ii + band
            while ii < p.x_size and jj >= 0:
                if 0 <= jj < y_size:
                    diag_is.append(ii)
                    diag_vals.append(dvacc[t, jj])
                ii += 1
                jj -= 1
            found, max_i, max_j, max_score = _find_max_from(
                lr, diag_vals, diag_is, p, band)
            if not found:
                out[i] = Alignment()
                continue
            res = _traceback_native(dirs[t], cpl, p, band, max_i, max_j)
            if res is None:
                view = (bsw_cuda.StepDirs(dirs[t], band) if cpl
                        else dirs[t])
                res = _traceback_from_dirs(view, p, band, max_i, max_j)
            edits, matches, x, pos = res
            homology = 0.0 if not edits else matches * 100.0 / len(edits)
            out[i] = Alignment(
                begin_a=pos + 1, begin_b=p.begin_b + x + 1,
                a_size=len(p.a), b_size=len(p.b), score=max_score,
                homology=homology, edits=np.array(edits, np.uint8))


_default_engine: BswEngine | None = None


def bsw_align_device(a, begin_a, end_a, b, begin_b, end_b,
                     force_start=False, force_end=False) -> Alignment:
    """Drop-in aligner callable backed by the batched device engine."""
    global _default_engine
    if _default_engine is None:
        _default_engine = BswEngine()
    return _default_engine.align_one(a, begin_a, end_a, b, begin_b, end_b,
                                     force_start, force_end)
