// Shared tile machinery of the grouped GEMMs on mma.sync: tgmm.cu's bf16
// kernel (B10) and the f32 kernels of gather_gmm.cu (B9), gmm.cu and
// tgmm.cu. (The bf16 forms of B9 and gmm run on the Hopper kernel of
// grouped_gemm_sm90.cuh.)
//
// bf16 runs on the tensor cores: a block of 8 warps owns a 128 x 128
// output tile and walks the reduction in 32-deep steps staged in shared
// memory by 16-byte cp.async copies, double-buffered; each warp owns a
// 64 x 32 piece of the tile (4 x 4 mma.sync m16n8k16 products a 16-deep
// step, f32 accumulators in registers). Two shared tile shapes:
//
//   - a "rows" tile [128][32]: 128 rows of a row-major source, 32 columns
//     of the reduction each;
//   - a "cols" tile [32][128]: 32 rows of the reduction, 128 columns each
//     (both operands of tgmm, whose reduction runs over the rows).
//
// Rows padded by 16 bytes keep the fragment reads free of bank conflicts.
// An A operand stored reduction-major (tgmm's lhs^T) reaches its fragments
// through ldmatrix.trans, a B operand stored [n][k] through plain 32-bit
// reads. Copies of rows or columns outside the problem are zero-filled, so
// masked rows add nothing to the sums.
//
// f32 runs on CUDA cores in full f32 (FMA) for exact parity checks, as the
// flash kernels do: a 64 x 64 tile, 4 x 4 outputs a thread, operands read
// element by element through the caller's accessors.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace ptt {
namespace gg {

constexpr int kBM = 128;   // output rows of a bf16 block
constexpr int kBN = 128;   // output columns of a bf16 block
constexpr int kBK = 32;    // reduction depth of a stage
constexpr int kThreads = 256;
constexpr int kWarpM = 64, kWarpN = 32;   // 2 x 4 warps
constexpr int kMT = kWarpM / 16;          // m16 tiles a warp
constexpr int kNT = kWarpN / 8;           // n8 tiles a warp
constexpr int kRowsLd = kBK + 8;          // [128][kBK] tile row, elements
constexpr int kColsLd = kBN + 8;          // [kBK][128] tile row, elements
constexpr int kTileElems = kBM * kRowsLd; // covers both shapes (5120 >= 4352)
static_assert(kBM == kBN && kBK * kColsLd <= kTileElems, "tile shapes");

using bf16 = __nv_bfloat16;
using Acc = float[kMT][kNT][4];

// shared memory of a bf16 block: 2 stages x (A, B)
struct Smem {
  bf16 t[2][2][kTileElems];
};

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// A "cols" tile: rows [r0, r0 + kBK) of `base` (row stride ld), columns
// [c0, c0 + 128); rows outside [lo, hi) and columns past ncols are zero.
__device__ __forceinline__ void load_cols(bf16* dst, const bf16* base,
                                          int64_t ld, int r0, int lo, int hi,
                                          int c0, int ncols, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int e = tid + i * kThreads;
    const int r = e >> 4, c = (e & 15) * 8;
    const int row = r0 + r;
    const bool v = row >= lo && row < hi && c0 + c < ncols;
    cp_async16(dst + r * kColsLd + c, v ? base + row * ld + c0 + c : base, v);
  }
}

// acc += A_stage * B_stage over one kBK-deep stage. A is a "rows" tile
// ([m][k]) or, with kATrans, a "cols" tile ([k][m]); B is a "cols" tile
// ([k][n]) or, with kBTrans, a "rows" tile ([n][k]).
template <bool kATrans, bool kBTrans>
__device__ __forceinline__ void mma_stage(Acc& acc, const bf16* As,
                                          const bf16* Bs, int warp, int lane) {
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, tig = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: matrix, row
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t a[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int row = wm * kWarpM + mt * 16;
      if (!kATrans) {
        load_a_frag(a[mt], As, kRowsLd, row, kk, g, tig);
      } else {
        // matrix mi: rows +8*(mi&1), reduction +8*(mi>>1) -> a0..a3
        ldmatrix_x4_trans(a[mt], As + (kk + (mi >> 1) * 8 + mr) * kColsLd
                                     + row + (mi & 1) * 8);
      }
    }
    uint32_t b[kNT][2];
    if (!kBTrans) {
#pragma unroll
      for (int nt = 0; nt < kNT; nt += 2) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, Bs + (kk + (mi & 1) * 8 + mr) * kColsLd
                                 + wn * kWarpN + (nt + (mi >> 1)) * 8);
        b[nt][0] = f[0];
        b[nt][1] = f[1];
        b[nt + 1][0] = f[2];
        b[nt + 1][1] = f[3];
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const bf16* p = Bs + (wn * kWarpN + nt * 8 + g) * kRowsLd + kk + tig * 2;
        b[nt][0] = ld_u32(p);
        b[nt][1] = ld_u32(p + 8);
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
  }
}

struct NoPrep {
  __device__ void operator()(int) const {}
};

// The double-buffered reduction over nk stages: stage(kt, buf) issues the
// copies of stage kt into buffer buf and commits them; prep(buf), after
// they landed, may rewrite buffer buf's tiles (ending in a barrier)
// before the stage's products.
template <bool kATrans, bool kBTrans, typename Stage, typename Prep = NoPrep>
__device__ __forceinline__ void mainloop(Acc& acc, Smem& sm, int nk,
                                         Stage stage, int warp, int lane,
                                         Prep prep = Prep()) {
  if (nk <= 0) return;
  stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      stage(kt + 1, (kt + 1) & 1);
      cp_async_wait<1>();   // stage kt landed; the next is in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    prep(kt & 1);
    mma_stage<kATrans, kBTrans>(acc, sm.t[kt & 1][0], sm.t[kt & 1][1], warp,
                                lane);
    __syncthreads();        // buffer kt & 1 free for stage kt + 2
  }
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// acc -> out rows [m0, m0 + 128) ∩ [0, M), columns [n0, n0 + 128) ∩ [0, N)
// (N a multiple of 8, so a column pair is inside or outside together)
template <typename OutT>
__device__ __forceinline__ void store_tile(const Acc& acc, OutT* out,
                                           int64_t ld, int m0, int n0, int M,
                                           int N, int warp, int lane) {
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = n0 + wn * kWarpN + nt * 8 + tig * 2;
      if (col >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * kWarpM + mt * 16 + g + half * 8;
        if (row < M)
          store2(out + row * ld + col, acc[mt][nt][2 * half],
                 acc[mt][nt][2 * half + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// f32 on CUDA cores
// ---------------------------------------------------------------------------
constexpr int kFM = 64, kFN = 64, kFK = 16;

struct SmemF32 {
  float a[kFK][kFM];
  float b[kFK][kFN];
};

// acc (this thread's 4 x 4 outputs: rows 4*(tid/16)+i, columns
// 4*(tid%16)+j of a 64 x 64 tile) += sum over k in [kbeg, kend) of
// a_at(row, k) * b_at(k, col); the accessors return 0 outside the problem.
template <typename AFn, typename BFn>
__device__ __forceinline__ void f32_tile(float (&acc)[4][4], SmemF32& sm,
                                         int kbeg, int kend, AFn a_at,
                                         BFn b_at, int tid) {
  const int ty = tid >> 4, tx = tid & 15;
  for (int k0 = kbeg; k0 < kend; k0 += kFK) {
    for (int e = tid; e < kFK * kFM; e += kThreads) {
      const int kk = e / kFM, i = e % kFM;
      const bool in = k0 + kk < kend;
      sm.a[kk][i] = in ? a_at(i, k0 + kk) : 0.f;
      sm.b[kk][i] = in ? b_at(k0 + kk, i) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(sm.a[kk][ty * 4 + i], sm.b[kk][tx * 4 + j], acc[i][j]);
    __syncthreads();
  }
}

template <typename OutT>
__device__ __forceinline__ void f32_store(const float (&acc)[4][4], OutT* out,
                                          int64_t ld, int m0, int n0, int M,
                                          int N, int tid) {
  const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) out[row * ld + col] = from_f32<OutT>(acc[i][j]);
    }
  }
}

// The groups of gs [E] that hold rows of [m0, m0 + bm) ∩ [0, M), in order:
// n entries of (group, first row, end row) in shared memory. Groups are
// consecutive row ranges in group order; empty groups hold no row.
struct TileGroups {
  int n;
  int g[kBM], lo[kBM], hi[kBM];
};

__device__ __forceinline__ void find_groups(TileGroups& tg, const int* gs,
                                            int E, int m0, int bm, int M,
                                            int tid) {
  if (tid == 0) {
    int start = 0, n = 0;
    const int m1 = min(m0 + bm, M);
    for (int e = 0; e < E && start < m1; ++e) {
      const int end = start + gs[e];
      const int lo = max(start, m0), hi = min(end, m1);
      if (lo < hi) {
        tg.g[n] = e;
        tg.lo[n] = lo;
        tg.hi[n] = hi;
        ++n;
      }
      start = end;
    }
    tg.n = n;
  }
  __syncthreads();
}

}  // namespace gg
}  // namespace ptt
