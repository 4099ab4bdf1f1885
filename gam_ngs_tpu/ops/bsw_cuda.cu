// Banded semi-global Smith-Waterman for NVIDIA Hopper (sm_90a), called
// from JAX through the XLA FFI (ops/bsw_cuda.py builds and binds it).
//
// One warp per problem.  The band (2*band+1 diagonals) is stepped along
// anti-diagonals t = 2i + j of the reference's band storage sw[i][j]
// (ops/bsw_ref.py): lane slot k holds cell i = t/2 - k, j = (t&1) + 2k,
// so every step reads only steps t-1 and t-2 and the in-row `left`
// dependency disappears.  Each lane owns CPL consecutive slots; the
// +-1-slot exchange is one __shfl_up_sync and one __shfl_down_sync per
// step.  The cell maximum and the add-max use Hopper's DPX instructions.
//
// Per step a lane writes one uint16 word of 2-bit traceback directions
// (slot r at bits 2r..2r+1) to dirs[p, t, lane]; the word layout is
// decoded on the host by ops/bsw_cuda.StepDirs.  After the forward the
// same warp runs the reference find-max (last row, then the
// pos_a == end_a diagonal, first candidate wins ties) and walks the
// traceback through staged direction rows, emitting the walk summary
// and, in edits mode, the 2-bit edit string.
//
// Cell values, directions and the walk are bit-identical to
// ops/bsw_ref.py; the arithmetic is int32 throughout.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kGap = -8;
constexpr int kNeg = -(1 << 29);
constexpr int kForceMaxGap = 10;
constexpr int kDiag = 0, kUp = 1, kLeft = 2;
constexpr int kGapA = 0, kGapB = 1, kMatch = 2, kMismatch = 3;
constexpr int kMaxCpl = 8;                   // 16-bit word = 8 slots
constexpr int kMaxBand = 32 * kMaxCpl - 1;   // band + 1 slots per step
constexpr int kWalkRows = 32;                // direction rows per refill
constexpr int kSummary = 16;
constexpr unsigned kFull = 0xffffffffu;

// mode: 0 = forward only (dirs + last row + diagonal for a host walk),
//       1 = forward + find-max + walk summary, 2 = as 1 plus edits
enum Mode { kForward = 0, kLean = 1, kEdits = 2 };

struct Problem {
  const uint8_t* a;  // band-aligned window: a[k] = A[begin_a - band + k]
  const uint8_t* b;  // b[i] = B[begin_b + i]
  int aw, xw, band, ys;
  int begin_a, end_a, a_len, x_size, fs;
};

__device__ __forceinline__ int base_score(int ac, int bc) {
  const bool an = ac == 4, bn = bc == 4;
  return (an && bn) ? 5 : ((an || bn) ? 0 : (ac == bc ? 5 : -4));
}

// One anti-diagonal step t of parity PAR.  LEAN drops the row-0,
// pos == 0 and validity cases: it is used only when begin_a >= 0 and
// t >= 2*band + 3, where no such cell exists inside the band (cells
// outside the valid region then hold values no valid cell reads).
template <int CPL, int PAR, bool LEAN>
__device__ __forceinline__ void dp_step(const Problem& P, int t, int lane,
                                        int (&prev1)[CPL],
                                        int (&prev2)[CPL],
                                        uint16_t* dirs_row, int jdb,
                                        int xs1, int* lr_sh, int* dv_sh) {
  const int base = t >> 1;
  const int chalf = base + PAR;
  const int k0 = lane * CPL;
  const int ymax = P.ys - 1;
  const int from_prev = __shfl_up_sync(kFull, prev1[CPL - 1], 1);
  const int from_next = __shfl_down_sync(kFull, prev1[0], 1);
  int row[CPL];
  uint32_t word = 0;
#pragma unroll
  for (int r = 0; r < CPL; ++r) {
    const int k = k0 + r;
    // up = sw[i-1][j+1], left = sw[i][j-1]: both from step t-1
    const int up_raw =
        PAR ? (r + 1 < CPL ? prev1[r + 1] : from_next) : prev1[r];
    const int left_raw = PAR ? prev1[r] : (r > 0 ? prev1[r - 1] : from_prev);
    const int ai = chalf + k;
    const int bi = base - k;
    const int ac = ai < P.aw ? P.a[ai] : 15;
    const int bc = (bi >= 0 && bi < P.xw) ? P.b[bi] : 15;
    const int sc = base_score(ac, bc);
    const int dv = prev2[r] + sc;  // sw[i-1][j] + score
    const int j = PAR + 2 * k;
    const bool jmax = !PAR && j == ymax;  // ymax is even
    const bool j0 = !PAR && k == 0;
    int v, d;
    if (LEAN) {
      const int uv = jmax ? kNeg : up_raw + kGap;
      const int lv = j0 ? kNeg : left_raw + kGap;
      v = __vimax3_s32(dv, uv, lv);
      const bool mid = !j0 && !jmax;
      d = v == dv ? kDiag
                  : (mid && v == uv) ? kUp
                                     : mid ? kLeft : (!jmax ? kUp : kLeft);
    } else {
      const int i = base - k;
      const int pos = P.begin_a - P.band + chalf + k;
      const bool valid = j < P.ys && i >= 0 && i < P.x_size && pos >= 0 &&
                         pos < P.a_len;
      const bool fs = P.fs != 0;
      const bool i0 = i == 0;
      const bool pos0 = pos == 0;
      const bool i0_forced = i0 && fs && pos > kForceMaxGap;
      const bool forced = !i0 && pos0 && fs && i > kForceMaxGap;
      const bool fresh = !i0 && pos0 && !forced;
      const bool general = !i0 && !pos0;
      // diag: cells whose sw[i-1][j] lies outside A or above row 0
      // read a stored 0, so dv degenerates to the fresh-start score
      const bool inc_up = (i0 && !i0_forced) || (!i0 && !jmax);
      const int uv = inc_up ? up_raw + kGap : kNeg;
      // row 0 takes sw[0][j-1] unpenalized (the reference's quirk)
      const int lv = (i0 && pos > 0 && !j0)
                         ? left_raw
                         : fresh ? kGap
                                 : (general && !j0) ? left_raw + kGap : kNeg;
      v = valid ? __vimax3_s32(dv, uv, lv) : 0;
      // traceback decisions in the reference's tie-break order
      const bool left_blocked = fs && i > kForceMaxGap;
      const int d_pos0 =
          v == sc ? kDiag
                  : ((jmax || (v == kGap && !left_blocked)) ? kLeft : kUp);
      int up_t = (i > 0 && !jmax) ? up_raw + kGap : kGap;
      if (fs && i0) up_t = (pos >= 0 && pos <= kForceMaxGap) ? kGap : kNeg;
      const bool mid = !j0 && !jmax;
      const int d_gen =
          v == dv ? kDiag
                  : (mid && v == up_t) ? kUp
                                       : mid ? kLeft : (!jmax ? kUp : kLeft);
      d = pos0 ? d_pos0 : d_gen;
    }
    row[r] = v;
    word |= static_cast<uint32_t>(d) << (2 * r);
    // one writer per j: the pos_a == end_a diagonal and the last row
    if (k == jdb - chalf) dv_sh[j] = v;
    if (k == base - xs1) lr_sh[j] = v;
  }
  dirs_row[lane] = static_cast<uint16_t>(word);
#pragma unroll
  for (int r = 0; r < CPL; ++r) {
    prev2[r] = prev1[r];
    prev1[r] = row[r];
  }
}

template <int CPL>
__global__ void __launch_bounds__(32)
    bsw_kernel(const uint8_t* __restrict__ a_win,
               const uint8_t* __restrict__ b_win,
               const int32_t* __restrict__ params, int n_prob, int aw,
               int xw, int n_steps, int band, int mode,
               uint16_t* __restrict__ dirs, int32_t* __restrict__ rows,
               int32_t* __restrict__ summary, uint8_t* __restrict__ edits,
               int edit_bytes) {
  constexpr int kRow = 64 * CPL;  // j-space width of the deposits
  __shared__ int lr_sh[kRow];
  __shared__ int dv_sh[kRow];
  __shared__ uint16_t walk_sh[kWalkRows * 32];

  const int p = blockIdx.x;
  const int lane = threadIdx.x;
  Problem P;
  P.a = a_win + static_cast<size_t>(p) * aw;
  P.b = b_win + static_cast<size_t>(p) * xw;
  P.aw = aw;
  P.xw = xw;
  P.band = band;
  P.ys = 2 * band + 1;
  P.begin_a = params[0 * n_prob + p];
  P.end_a = params[1 * n_prob + p];
  P.a_len = params[2 * n_prob + p];
  P.x_size = params[3 * n_prob + p];
  P.fs = params[4 * n_prob + p];
  const bool force_end = params[5 * n_prob + p] != 0;
  uint16_t* dp = dirs + static_cast<size_t>(p) * n_steps * 32;

  for (int j = lane; j < kRow; j += 32) {
    lr_sh[j] = 0;
    dv_sh[j] = 0;
  }
  __syncwarp();

  int prev1[CPL], prev2[CPL];
#pragma unroll
  for (int r = 0; r < CPL; ++r) prev1[r] = prev2[r] = 0;

  const int xs = min(P.x_size, xw);
  const int steps = xs > 0 ? 2 * (xs - 1) + P.ys : 0;
  const int lean_from = P.begin_a >= 0 ? 2 * band + 3 : INT_MAX;
  const int jdb = P.end_a - P.begin_a + band;
  const int xs1 = xs - 1;
  for (int t = 0; t < steps; t += 2) {
    if (t >= lean_from) {
      dp_step<CPL, 0, true>(P, t, lane, prev1, prev2, dp + t * 32, jdb, xs1,
                            lr_sh, dv_sh);
      if (t + 1 < steps)
        dp_step<CPL, 1, true>(P, t + 1, lane, prev1, prev2,
                              dp + (t + 1) * 32, jdb, xs1, lr_sh, dv_sh);
    } else {
      dp_step<CPL, 0, false>(P, t, lane, prev1, prev2, dp + t * 32, jdb,
                             xs1, lr_sh, dv_sh);
      if (t + 1 < steps)
        dp_step<CPL, 1, false>(P, t + 1, lane, prev1, prev2,
                               dp + (t + 1) * 32, jdb, xs1, lr_sh, dv_sh);
    }
  }
  __syncwarp();

  if (mode == kForward) {
    int32_t* out = rows + static_cast<size_t>(p) * 2 * kRow;
    for (int j = lane; j < kRow; j += 32) {
      out[j] = lr_sh[j];
      out[kRow + j] = dv_sh[j];
    }
    return;
  }

  // ---- find-max (reference candidate order, first hit wins ties) ----
  const int ys = P.ys;
  const int big = 1 << 30;
  const int i0 = max(P.end_a - P.begin_a - band, 0);
  int best_v = -(1 << 30), best_p = big;
  for (int j = lane; j < ys; j += 32) {
    const int posj = P.begin_a + xs1 - band + j;
    if (!force_end && posj >= 0 && posj <= P.end_a) {
      const int v = lr_sh[j];
      if (v > best_v || (v == best_v && j < best_p)) best_v = v, best_p = j;
    }
    // diagonal lane j holds row i = jdb - j.  With force_end the
    // reference's window bound is unsigned and wraps for
    // x_size <= FORCE_MAXGAP_LEN, excluding every candidate
    const int i = jdb - j;
    if (i >= i0 && i < xs &&
        (!force_end || (i >= xs1 - kForceMaxGap && xs1 - kForceMaxGap >= 0))) {
      const int v = dv_sh[j];
      const int pr = ys + i - i0;
      if (v > best_v || (v == best_v && pr < best_p)) best_v = v, best_p = pr;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(kFull, best_v, off);
    const int op = __shfl_xor_sync(kFull, best_p, off);
    if (ov > best_v || (ov == best_v && op < best_p)) best_v = ov, best_p = op;
  }
  const bool found = best_p < big;
  int x = -1, y = 0;
  if (found) {
    if (best_p < ys) {
      x = xs1;
      y = best_p;
    } else {
      x = i0 + best_p - ys;
      y = jdb - x;
    }
  }

  // ---- traceback walk (warp-uniform; rows staged in shared memory) ----
  bool active = x >= 0 && y >= 0 && P.begin_a + x + y - band >= 0;
  int cnt = 0, matches = 0, gapa = 0, gapb = 0, hasm = 0;
  int fmx = 0, fmy = 0, lmx = 0, lmy = 0;
  int staged_lo = INT_MAX;
  uint32_t ebyte = 0;
  uint8_t* eout = edits + static_cast<size_t>(p) * edit_bytes;
  const int cap = mode == kEdits ? 4 * edit_bytes : INT_MAX;
  while (active && cnt < cap) {
    const int t = 2 * x + y;
    if (t < staged_lo) {
      staged_lo = max(t - kWalkRows + 1, 0);
      __syncwarp();
      for (int e = lane; e < kWalkRows * 32; e += 32) {
        const int tt = staged_lo + e / 32;
        walk_sh[e] = tt < n_steps ? dp[tt * 32 + (e & 31)] : 0;
      }
      __syncwarp();
    }
    const int k = (t >> 1) - x;
    const int d =
        (walk_sh[(t - staged_lo) * 32 + k / CPL] >> (2 * (k % CPL))) & 3;
    const int ca = P.a[x + y];
    const int cb = P.b[x];
    const bool is_match = ca == cb || ca == 4 || cb == 4;
    if (mode == kEdits) {
      const int code = d == kDiag ? (is_match ? kMatch : kMismatch)
                                  : (d == kUp ? kGapA : kGapB);
      ebyte |= static_cast<uint32_t>(code) << (2 * (cnt & 3));
      if ((cnt & 3) == 3) {
        if (lane == 0) eout[cnt >> 2] = static_cast<uint8_t>(ebyte);
        ebyte = 0;
      }
    }
    // walk order is reverse alignment order: the first match seen is
    // the alignment's last one, the last seen its first
    if (d == kDiag && is_match) {
      fmx = x;
      fmy = y;
      if (!hasm) {
        lmx = x;
        lmy = y;
      }
      hasm = 1;
      ++matches;
    }
    gapa += d == kUp;
    gapb += d == kLeft;
    if (d != kLeft) --x;
    if (d == kUp) ++y;
    if (d == kLeft) --y;
    ++cnt;
    active = x >= 0 && y >= 0 && P.begin_a + x + y - band >= 0;
  }
  if (lane == 0) {
    if (mode == kEdits && (cnt & 3)) eout[cnt >> 2] = static_cast<uint8_t>(ebyte);
    int32_t* s = summary + static_cast<size_t>(p) * kSummary;
    const int vals[kSummary] = {x,    y,    cnt,  matches,      gapa, gapb,
                                hasm, fmx,  fmy,  lmx,          lmy,  best_v,
                                found ? 1 : 0, 0, 0, 0};
#pragma unroll
    for (int q = 0; q < kSummary; ++q) s[q] = vals[q];
  }
}

template <int CPL>
void launch(cudaStream_t stream, const ffi::Buffer<ffi::U8>& a_win,
            const ffi::Buffer<ffi::U8>& b_win,
            const ffi::Buffer<ffi::S32>& params, int n_prob, int aw, int xw,
            int n_steps, int band, int mode, uint16_t* dirs, int32_t* rows,
            int32_t* summary, uint8_t* edits, int edit_bytes) {
  bsw_kernel<CPL><<<n_prob, 32, 0, stream>>>(
      a_win.typed_data(), b_win.typed_data(), params.typed_data(), n_prob,
      aw, xw, n_steps, band, mode, dirs, rows, summary, edits, edit_bytes);
}

ffi::Error BswImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> a_win,
                   ffi::Buffer<ffi::U8> b_win, ffi::Buffer<ffi::S32> params,
                   ffi::ResultBuffer<ffi::U16> dirs,
                   ffi::ResultBuffer<ffi::S32> rows,
                   ffi::ResultBuffer<ffi::S32> summary,
                   ffi::ResultBuffer<ffi::U8> edits, int32_t band,
                   int32_t mode) {
  if (band < 0 || band > kMaxBand)
    return ffi::Error::InvalidArgument("band outside [0, 255]");
  if (mode < kForward || mode > kEdits)
    return ffi::Error::InvalidArgument("unknown mode");
  const auto ad = a_win.dimensions();
  const auto bd = b_win.dimensions();
  const auto pd = params.dimensions();
  if (ad.size() != 2 || bd.size() != 2 || pd.size() != 2 || ad[0] != bd[0] ||
      pd[1] != ad[0] || pd[0] < 6)
    return ffi::Error::InvalidArgument(
        "expected a_win (B, AW), b_win (B, XW), params (>=6, B)");
  const int n_prob = static_cast<int>(ad[0]);
  const int aw = static_cast<int>(ad[1]);
  const int xw = static_cast<int>(bd[1]);
  const int cpl = (band + 1 + 31) / 32;
  const int n_steps = 2 * (xw - 1) + 2 * band + 1;
  const auto dd = dirs->dimensions();
  const auto rd = rows->dimensions();
  const auto sd = summary->dimensions();
  const auto ed = edits->dimensions();
  if (dd.size() != 3 || dd[0] != n_prob || dd[1] != n_steps || dd[2] != 32)
    return ffi::Error::InvalidArgument("dirs must be (B, 2*(XW-1)+2*band+1, 32)");
  if (rd.size() != 3 || rd[0] != n_prob || rd[1] != 2 || rd[2] != 64 * cpl)
    return ffi::Error::InvalidArgument("rows must be (B, 2, 64*cells_per_lane)");
  if (sd.size() != 2 || sd[0] != n_prob || sd[1] != kSummary)
    return ffi::Error::InvalidArgument("summary must be (B, 16)");
  if (ed.size() != 2 || ed[0] != n_prob || ed[1] < 1)
    return ffi::Error::InvalidArgument("edits must be (B, >=1)");
  if (aw < xw + 2 * band + 1)
    return ffi::Error::InvalidArgument("a_win narrower than XW + 2*band + 1");
  if (n_prob == 0) return ffi::Error::Success();
  const int edit_bytes = static_cast<int>(ed[1]);
  uint16_t* dp = dirs->typed_data();
  int32_t* rp = rows->typed_data();
  int32_t* sp = summary->typed_data();
  uint8_t* ep = edits->typed_data();
#define GAM_LAUNCH(C)                                                        \
  case C:                                                                    \
    launch<C>(stream, a_win, b_win, params, n_prob, aw, xw, n_steps, band,   \
              mode, dp, rp, sp, ep, edit_bytes);                             \
    break;
  switch (cpl) {
    GAM_LAUNCH(1)
    GAM_LAUNCH(2)
    GAM_LAUNCH(3)
    GAM_LAUNCH(4)
    GAM_LAUNCH(5)
    GAM_LAUNCH(6)
    GAM_LAUNCH(7)
    GAM_LAUNCH(8)
    default:
      return ffi::Error::InvalidArgument("band too wide");
  }
#undef GAM_LAUNCH
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(GamBsw, BswImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U16>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Attr<int32_t>("band")
                                  .Attr<int32_t>("mode"));
