// Hopper (sm_90a) grouped-GEMM machinery shared by gather_gmm.cu (B9, bf16
// and int8 rhs), gmm.cu (B10's gmm, plain and transpose_rhs) and tgmm.cu
// (B10's tgmm, `tgmm_sm90` below): persistent, warp-specialised kernels
// built on wgmma, TMA and mbarrier stages (the building blocks in
// hopper.cuh). They replace the tiles of the TPU kernels
// paddle_tpu/kernels/moe_fused.py `gather_gmm` (pallas_call :266) and jax's
// megablox `gmm` and `tgmm`, which paddle_tpu/kernels/moe_dispatch.py calls
// from `_gmm_tuned` (:434) and `_gmm_tuned_bwd` (:445).
//
// What bounds these products on the H100 is the tensor cores: at the
// DeepSeekMoE step's shapes they do 330-660 GFLOP on 0.6-1.1 GB, 500-1000
// operations a byte against the card's ~295. Feeding the tensor cores takes
// deep asynchronous loads, warps that only compute and no block-wide
// barrier between stages (grouped_gemm.cuh's mma.sync tiles, with none of
// these, run at 20-28% of the bound). This design:
//
//   - wgmma.mma_async (bf16 in, f32 sums in registers). A block owns a
//     128 x BN output tile (BN = 256 or 128, the wrapper's choice): two
//     consumer warpgroups of 64 rows each, a 64 x BN accumulator a
//     warpgroup (128 or 64 registers a thread). Reduction stages are 64
//     deep, so a bf16 row of a stage is 128 bytes, one 128-byte swizzle row.
//   - A ring of 4 (BN 256) or 6 stages in dynamic shared memory (192 KB),
//     each with a full and an empty mbarrier. Warpgroup 0 produces: it keeps
//     loads in flight and gives most of its registers to the consumers
//     (setmaxnreg). Consumers release a stage once the wgmma that read it
//     has retired (wgmma.wait_group 1: one stage's products stay in flight).
//   - The weight tiles come by TMA from a 3-D map of the rhs, [E, K, N] (or
//     [E, N, K]): a stage past K, or columns past N, are TMA's zero fill,
//     never the next expert's rows. An [K, N] rhs arrives as 64-column boxes
//     of 128-byte swizzled rows (BN / 64 boxes a stage) and is read N-major
//     by wgmma; an [N, K] rhs is one K-major box.
//   - The lhs: gmm's [M, K] by TMA; B9's rows are a gather (x[idx[row]]),
//     which TMA cannot do, so the 128 producer threads issue them as 16-byte
//     cp.async copies into the same swizzled layout (zero-filled past K).
//     Each thread arrives on a stage's full barrier one stage after issuing
//     it (cp.async.wait_group, then fence.proxy.async: wgmma reads in the
//     async proxy what cp.async wrote in the generic one), so two stages of
//     row copies stay in flight and no consumer fences while its products
//     run.
//   - An int8 rhs (B9-int8) arrives as it is stored, by TMA (128-column
//     boxes of 128-byte swizzled rows: half the bytes of bf16), and the
//     product is computed transposed, out^T = W^T x^T: the weight tile is
//     wgmma's A operand, loaded from shared memory with ldmatrix.trans and
//     widened exactly in registers (a shift, masks and one bf16x2
//     subtraction a pair), and the gathered rows are its K-major B operand;
//     two k16 steps of A fragments stay in flight.
//     Widening into a bf16 stage in shared memory instead (written, fenced,
//     then read by both warpgroups' wgmma) cost B9-int8 ~0.6 ms at the
//     MoE step: the stage's shared-memory traffic, not the tensor cores,
//     set its pace.
//   - A persistent grid, one block per SM, walks the output tiles in a
//     static order, row tile by row tile with the column tiles of a row tile
//     together: the ~132 tiles in flight at once share one or two experts'
//     weight slabs and a dozen row tiles, which stay in L2. The producer
//     runs ahead into the next tile while the consumers store this one.
//   - The epilogue rounds the f32 sums to bf16 and stores them from
//     registers, 16 bytes a store after a shuffle within each quad of
//     lanes, masking rows and columns outside the problem. The stores are
//     streaming (st.global.cs): the output, far larger than L2, is not
//     read again here, and keeping it out of L2 keeps the weight slabs and
//     rows in (measured: B9-int8 faster, gmm unchanged). A gmm tile
//     whose rows span several groups runs one pass per group (fresh sums, a
//     store of that group's rows only); rows at or past sum(gs) are written
//     as zeros. No split of the reduction and no atomics: every output
//     element is summed in one fixed order, the same from run to run.
#pragma once

#include <algorithm>
#include <cstdint>

#include "hopper.cuh"

namespace ptt {
namespace sm90 {
namespace {

constexpr int kBM = 128;        // output rows of a tile (2 warpgroups x 64)
constexpr int kBK = 64;         // reduction depth of a stage (128-byte rows)
constexpr int kThreads = 384;   // warpgroup 0 loads, 1 and 2 compute

// Shapes of one instantiation. An int8 rhs is B9's only (N-major).
template <int BN, bool kGather, bool kTransB, bool kInt8B>
struct Cfg {
  static_assert(BN == 128 || BN == 256, "tile width");
  static_assert(!kInt8B || (kGather && !kTransB), "int8 rhs: B9 only");
  static constexpr int kABytes = kBM * kBK * 2;
  // the rhs tile of a stage: bf16, or int8 as it is stored
  static constexpr int kBBytes = BN * kBK * (kInt8B ? 1 : 2);
  static constexpr int kStageBytes = kABytes + kBBytes;
  // a 192 KB ring: 4 (bf16, BN 256), 6 or 8 (int8, BN 128) stages
  static constexpr int kStages = 196608 / kStageBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kBars = 2 * kStages;
  static constexpr int kAcc = BN / 2;   // f32 sums a consumer thread
  // rhs boxes a stage: 64 bf16 (or 128 int8) columns of 128-byte rows
  static constexpr int kBoxCols = kInt8B ? 128 : 64;
  // arrivals that fill a stage: the TMA thread's and, for B9, the 4
  // producer warps' (each once its row copies landed)
  static constexpr int kFullCount = kGather ? 5 : 1;
  // registers a thread after the split (128 x kLoadRegs + 256 x kMathRegs
  // = 64,512 of the SM's 65,536)
  static constexpr int kLoadRegs = kGather ? 56 : 40;
  static constexpr int kMathRegs = kGather ? 224 : 232;
  static int smem_bytes(int E) {
    return kAlign + kRingBytes + 8 * kBars + (kGather ? 0 : 4 * (E + 1));
  }
};

struct Args {
  const bf16* x;     // B9: the rows' source [T, K]
  const int* idx;    // B9: source row of each output row [M]
  const int* gid;    // B9: group of each tm-row tile
  const int* gs;     // gmm: group sizes [E]
  bf16* out;         // [M, N]
  int M, K, N, E, tm;
};

// ---------------------------------------------------------------------------
// tiles
// ---------------------------------------------------------------------------
// bytes the rhs boxes of one stage bring: an N-major tile skips the
// 64-column boxes wholly past N (their columns are never stored)
template <int BN, bool kTransB, int kCols = 64>
__device__ __forceinline__ int b_boxes(int n0, int N) {
  return kTransB ? 1 : min(BN / kCols, (N - n0 + kCols - 1) / kCols);
}

template <int BN, bool kTransB, bool kInt8 = false>
__device__ __forceinline__ void load_b(unsigned char* dst,
                                       const CUtensorMap* map, uint64_t* bar,
                                       int n0, int k0, int g, int boxes) {
  if (kTransB) {
    tma_load_3d(dst, map, bar, k0, n0, g);   // box {64, BN, 1}
  } else {   // boxes {64, 64, 1} of bf16, or {128, 64, 1} of int8
    constexpr int kCols = kInt8 ? 128 : 64;
    for (int j = 0; j < boxes; ++j)
      tma_load_3d(dst + j * (kBK * 128), map, bar, n0 + kCols * j, k0, g);
  }
}

// The gmm groups that hold rows of [m0, m1): offs[g] is the first row of
// group g (offs[E] = min(sum(gs), M)); empty groups are skipped.
struct GroupWalk {
  const int* offs;
  int E, m0, m1, g;
  __device__ GroupWalk(const int* o, int e, int lo, int hi)
      : offs(o), E(e), m0(lo), m1(hi) {
    int a = 0, b = E;   // first g with offs[g + 1] > m0
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (offs[mid + 1] > m0)
        b = mid;
      else
        a = mid + 1;
    }
    g = a;
  }
  __device__ bool next(int& grp, int& lo, int& hi) {
    while (g < E && offs[g] < m1) {
      const int l = max(offs[g], m0), h = min(offs[g + 1], m1);
      grp = g++;
      if (l < h) {
        lo = l;
        hi = h;
        return true;
      }
    }
    return false;
  }
};

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------
template <int BN, bool kGather, bool kTransB, bool kInt8B>
__global__ void __launch_bounds__(kThreads, 1)
grouped_gemm_sm90(const Args a, const __grid_constant__ CUtensorMap tmA,
                  const __grid_constant__ CUtensorMap tmB) {
  using C = Cfg<BN, kGather, kTransB, kInt8B>;
  extern __shared__ unsigned char dyn[];
  unsigned char* base = dyn + ((kAlign - (smem_u32(dyn) & (kAlign - 1))) &
                               (kAlign - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::kRingBytes);
  uint64_t* empty = full + C::kStages;
  int* offs = reinterpret_cast<int*>(full + C::kBars);
  auto stage = [&](int s) { return base + s * C::kStageBytes; };
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], C::kFullCount);
      mbar_init(&empty[s], 8);   // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!kGather && tid == 32) {
    int run = 0;
    offs[0] = 0;
    for (int e = 0; e < a.E; ++e) {
      run = min(run + a.gs[e], a.M);
      offs[e + 1] = run;
    }
  }
  __syncthreads();
  const int tiles_n = (a.N + BN - 1) / BN;
  const int tiles = ((a.M + kBM - 1) / kBM) * tiles_n;
  const int nk = (a.K + kBK - 1) / kBK;

  if (tid < 128) {
    // ---------------- producer warpgroup ----------------
    regs_down<C::kLoadRegs>();
    int s = 0;
    uint32_t ph = 0;
    if (!kGather) {
      if (tid != 0) return;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / tiles_n) * kBM, n0 = (t % tiles_n) * BN;
        const int boxes = b_boxes<BN, kTransB>(n0, a.N);
        const uint32_t bytes =
            C::kABytes + (kTransB ? C::kBBytes : boxes * kBK * 128);
        GroupWalk walk(offs, a.E, m0, min(m0 + kBM, a.M));
        int g, lo, hi;
        while (walk.next(g, lo, hi)) {
          for (int ks = 0; ks < nk; ++ks) {
            mbar_wait(&empty[s], ph ^ 1);
            mbar_arrive_tx(&full[s], bytes);
            tma_load_2d(stage(s), &tmA, &full[s], ks * kBK, m0);
            load_b<BN, kTransB>(stage(s) + C::kABytes, &tmB, &full[s], n0,
                                ks * kBK, g, boxes);
            if (++s == C::kStages) {
              s = 0;
              ph ^= 1;
            }
          }
        }
      }
      return;
    }
    // B9: thread 0 brings the rhs tile by TMA (as stored, for int8); every
    // thread copies 16-byte chunk c of rows rr + 16 i, i < 8, of the
    // gathered lhs. A stage is signalled once the next stage's copies are
    // issued and its own have landed and are fenced for the async proxy
    // (wgmma reads what cp.async wrote): two stages of copies in flight.
    // Signalling later, measured, tied the producer to the consumers'
    // release of earlier stages and cost B9-int8 ~10%.
    const int c = tid & 7, rr = tid >> 3;
    int pending = -1;   // the stage whose copies are not yet signalled
    auto signal = [&](int st) {
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(&full[st]);
    };
    // the source rows and group of this block's next tile, loaded a tile
    // ahead so that their latency never stalls the copies
    int nidx[8], ngid = 0;
    auto prefetch = [&](int t) {
      if (t >= tiles) return;
      const int m0 = (t / tiles_n) * kBM;
#pragma unroll
      for (int i = 0; i < 8; ++i) nidx[i] = a.idx[m0 + rr + 16 * i];
      ngid = a.gid[m0 / a.tm];
    };
    prefetch(blockIdx.x);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int n0 = (t % tiles_n) * BN;
      const int g = ngid;
      const int boxes = b_boxes<BN, false, C::kBoxCols>(n0, a.N);
      const bf16* src[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        src[i] = a.x + int64_t(nidx[i]) * a.K + c * 8;
      prefetch(t + gridDim.x);
      for (int ks = 0; ks < nk; ++ks) {
        mbar_wait(&empty[s], ph ^ 1);
        unsigned char* st = stage(s);
        if (tid == 0) {
          mbar_arrive_tx(&full[s], boxes * kBK * 128);
          load_b<BN, false, kInt8B>(st + C::kABytes, &tmB, &full[s], n0,
                                    ks * kBK, g, boxes);
        }
        const bool kin = ks * kBK + c * 8 < a.K;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          cp_async16(st + (rr + 16 * i) * 128 + ((c ^ (rr & 7)) << 4),
                     kin ? static_cast<const void*>(src[i] + ks * kBK)
                         : static_cast<const void*>(a.x),
                     kin);
        cp_async_commit();
        if (pending >= 0) {
          cp_async_wait<1>();
          fence_async_shared();
          signal(pending);
        }
        pending = s;
        if (++s == C::kStages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    cp_async_wait<0>();
    fence_async_shared();
    if (pending >= 0) signal(pending);
    return;
  }

  // ---------------- consumer warpgroups ----------------
  regs_up<C::kMathRegs>();
  const int wgi = tid / 128 - 1, lt = tid & 127;
  const int warp = lt >> 5, lane = tid & 31;
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  };
  int s = 0;
  uint32_t ph = 0;
  if constexpr (kInt8B) {
    // out^T = W^T x^T: the weight tile is wgmma's A, 64 columns a block,
    // MB blocks a warpgroup (its BN / 2 columns), read from the raw int8
    // tile with ldmatrix.trans and widened in registers; the gathered rows
    // are B (K-major, 128 rows). A fragment row r of a 16-column block
    // stands for column 2 * (r % 8) + r / 8, so that one transposed b16
    // matrix of int8 pairs gives a thread both its rows: an A fragment is
    // bytes 0, 2 (row r) or 1, 3 (row r + 8) of a loaded word.
    constexpr int MB = BN / 128;
    const int g = lane >> 2, q = lane & 3;
    // A fragments of kBufs k16 steps in flight (kBufs <= the 4 steps of a
    // stage, so a stage is released within the next one)
    constexpr int kBufs = 2;
    float acc[MB][64];
    uint32_t fa[kBufs][MB][4];
    // this lane's ldmatrix row: matrix mi = lane / 8 (block mi / 2, rows
    // 8 * (mi % 2) of the k16 step), row lane % 8; 16-byte column chunk of
    // the warp's 16 columns in its 128-column box
    const int mi = lane >> 3, lrow = (mi & 1) * 8 + (lane & 7);
    const int chunk = (BN == 256 ? 0 : 4 * wgi) + 4 * (mi >> 1) + warp;
    const int box = BN == 256 ? wgi : 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * kBM, n0 = (t % tiles_n) * BN;
#pragma unroll
      for (int b = 0; b < MB; ++b)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[b][i] = 0.f;
      int prev = -1, step = 0;
      for (int ks = 0; ks < nk; ++ks) {
        mbar_wait(&full[s], ph);
        const uint32_t xs = smem_u32(stage(s));
        const uint32_t wt = xs + C::kABytes + box * (kBK * 128);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          uint32_t (&f)[MB][4] = fa[kk % kBufs];
          // step - kBufs has retired: f is free
          if (step >= kBufs) wgmma_wait<kBufs - 1>();
          if (kk == kBufs - 1 && prev >= 0) {   // so has the last stage
            release(prev);
            prev = -1;
          }
          const int k = kk * 16 + lrow;
          const uint32_t addr = wt + k * 128 + ((chunk ^ (k & 7)) << 4);
          uint32_t w[4];
          if constexpr (MB == 2)
            ldsm_x4_t(w, addr);
          else
            ldsm_x2_t(w, addr);
#pragma unroll
          for (int b = 0; b < MB; ++b) {
            f[b][0] = widen2<false>(w[2 * b]);
            f[b][1] = widen2<true>(w[2 * b]);
            f[b][2] = widen2<false>(w[2 * b + 1]);
            f[b][3] = widen2<true>(w[2 * b + 1]);
          }
#pragma unroll
          for (int b = 0; b < MB; ++b) fence_acc(acc[b]);
          wgmma_fence();
#pragma unroll
          for (int b = 0; b < MB; ++b)
            wgmma_ra_n128<0>(acc[b], f[b], desc(xs + kk * 32, 16, 1024));
          wgmma_commit();
#pragma unroll
          for (int b = 0; b < MB; ++b) fence_acc(acc[b]);
          ++step;
        }
        prev = s;
        if (++s == C::kStages) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < MB; ++b) fence_acc(acc[b]);
      if (prev >= 0) release(prev);
      // acc[b][4j + p] (p < 2) is row 8j + 2q + p, column c; [4j + 2 + p]
      // column c + 1, c = n0 + wgi * BN / 2 + 64 b + 16 warp + 2 g. Lanes
      // g = 4h + e (e < 4) trade pieces so that each stores one row's 8
      // columns from c - 2 g + 8 h: 16 bytes.
      const int e = g & 3, h = g >> 2;
#pragma unroll
      for (int b = 0; b < MB; ++b) {
        const int col = n0 + wgi * (BN / 2) + 64 * b + 16 * warp + 8 * h;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          uint32_t v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = 2 * jj + (i >> 1), p = i & 1;
            v[i] = pack_bf16(acc[b][4 * j + p], acc[b][4 * j + 2 + p]);
          }
          transpose4<4>(v, e);
          const int row = m0 + 8 * (2 * jj + (e >> 1)) + 2 * q + (e & 1);
          if (col < a.N)
            __stcs(reinterpret_cast<uint4*>(a.out + int64_t(row) * a.N + col),
                   make_uint4(v[0], v[1], v[2], v[3]));
        }
      }
    }
    return;
  } else {
    float acc[C::kAcc];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * kBM, n0 = (t % tiles_n) * BN;
      const int m1 = min(m0 + kBM, a.M);
      GroupWalk walk(offs, kGather ? 0 : a.E, m0, m1);
      int g, lo = m0, hi = m1;
      bool more = kGather || walk.next(g, lo, hi);
      while (more) {
#pragma unroll
        for (int i = 0; i < C::kAcc; ++i) acc[i] = 0.f;
        int prev = 0;
        for (int ks = 0; ks < nk; ++ks) {
          mbar_wait(&full[s], ph);
          const uint32_t sa = smem_u32(stage(s));
          const uint32_t a0 = sa + wgi * (64 * 128), b0 = sa + C::kABytes;
          fence_acc(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk) {
            const uint64_t da = desc(a0 + kk * 32, 16, 1024);
            const uint64_t db =
                kTransB ? desc(b0 + kk * 32, 16, 1024)
                        : desc(b0 + kk * 2048, kBK * 128, 1024);
            wgmma<BN, 0, kTransB ? 0 : 1>(acc, da, db);
          }
          wgmma_commit();
          fence_acc(acc);
          wgmma_wait<1>();   // the previous stage's products have retired
          fence_acc(acc);
          if (ks > 0) release(prev);
          prev = s;
          if (++s == C::kStages) {
            s = 0;
            ph ^= 1;
          }
        }
        wgmma_wait<0>();
        fence_acc(acc);
        release(prev);
        // rows [lo, hi) of this pass, columns [n0, n0 + BN) ∩ [0, N): each
        // quad trades its pieces so that a lane stores 8 whole columns
        const int q = lane & 3;
        const int r0 = m0 + wgi * 64 + warp * 16 + (lane >> 2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h;
          const bool live = row >= lo && row < hi;
          bf16* p = a.out + int64_t(row) * a.N;
#pragma unroll
          for (int m = 0; m < BN / 32; ++m) {
            uint32_t v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              v[i] = pack_bf16(acc[4 * (4 * m + i) + 2 * h],
                               acc[4 * (4 * m + i) + 2 * h + 1]);
            transpose4<1>(v, q);
            const int col = n0 + 8 * (4 * m + q);
            if (live && col < a.N)
              __stcs(reinterpret_cast<uint4*>(p + col),
                     make_uint4(v[0], v[1], v[2], v[3]));
          }
        }
        more = !kGather && walk.next(g, lo, hi);
      }
      if (!kGather) {
        // rows at or past sum(gs) belong to no group: zeros, 16 bytes a store
        const int z0 = max(offs[a.E], m0);
        constexpr int kPieces = BN / 8;
        for (int e = tid - 128; e < (m1 - z0) * kPieces; e += 256) {
          const int row = z0 + e / kPieces, col = n0 + (e % kPieces) * 8;
          if (col < a.N)
            *reinterpret_cast<uint4*>(a.out + int64_t(row) * a.N + col) =
                make_uint4(0, 0, 0, 0);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// tgmm: out[g] = lhs[rows of g]^T @ rhs[rows of g]
// ---------------------------------------------------------------------------
struct TArgs {
  const int* gs;   // group sizes [E]
  void* out;       // [E, K, N], bf16 or f32
  int M, K, N, E;
};

// The reduction runs over the rows of group g, 64 a stage from offs[g]
// (TMA coordinates are per element, so a stage may start at any row). The
// A operand is lhs^T: a stage holds 64 rows of lhs [M, K] x 128 of its
// columns, as two TMA boxes of 64 columns (one a consumer warpgroup: its 64
// output rows), M-major for wgmma (transposed A). The B operand is rhs
// [M, N] by the N-major path of gmm's rhs, a 3-D map of extent 1 in its
// last dimension. Rows past M are TMA's zero fill; rows at or past
// offs[g + 1] in a group's last stage hold the next group's rows, and each
// consumer warpgroup zeroes them in its own A box (generic-proxy stores,
// then fence.proxy.async and a barrier of the warpgroup before its wgmma):
// the tile-padded layout of the fused dispatch never has them, the gmm
// form's raw group sizes do, and only in one stage a tile. Zeroing one
// operand leaves 0 x (the next group's finite rhs rows) in the sums.
//
// A bf16 output is staged in shared memory, 128 columns of a warpgroup's
// 64 rows at a time (swizzled as the TMA boxes of the output's map,
// conflict-free), and stored by TMA from one thread of each warpgroup, so
// the consumers go on to the next tile while the bytes drain. An f32
// output is stored from registers. The output is what holds tgmm back
// beside gmm: [E, K, N] is 738 MB at the MoE step's gate|up wgrad, 3x
// gmm's, and the same call with no stores took ~0.77 ms against ~1.0 with
// them (measured on an H100, PERF.md). Neither TMA stores, nor an
// evict-first L2 policy on them, nor clusters of two blocks multicasting
// the rhs tile (correct, but 1.7x slower) closed that gap.
template <int BN, typename OutT>
struct TCfg {
  using G = Cfg<BN, false, false, false>;   // gmm's stage shapes
  static constexpr int kABytes = G::kABytes, kAcc = G::kAcc;
  static constexpr int kLoadRegs = G::kLoadRegs, kMathRegs = G::kMathRegs;
  static constexpr bool kTmaOut = sizeof(OutT) == 2;
  static constexpr int kOutBytes = kTmaOut ? kBM * 128 * 2 : 0;
  static constexpr int kStageBytes = G::kStageBytes;
  // bf16 out: 4 (BN 256) or 6 stages beside it in 224 KB
  static constexpr int kStages =
      kTmaOut ? (229376 - kOutBytes) / kStageBytes : G::kStages;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kBars = 2 * kStages;
  static int smem_bytes(int E) {
    return kAlign + kRingBytes + kOutBytes + 8 * kBars + 4 * (E + 1);
  }
};

template <int BN, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
tgmm_sm90(const TArgs a, const __grid_constant__ CUtensorMap tmA,
          const __grid_constant__ CUtensorMap tmB,
          const __grid_constant__ CUtensorMap tmO) {
  using C = TCfg<BN, OutT>;
  extern __shared__ unsigned char dyn[];
  unsigned char* base = dyn + ((kAlign - (smem_u32(dyn) & (kAlign - 1))) &
                               (kAlign - 1));
  unsigned char* obuf = base + C::kRingBytes;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(base + C::kRingBytes + C::kOutBytes);
  uint64_t* empty = full + C::kStages;
  int* offs = reinterpret_cast<int*>(full + C::kBars);
  auto stage = [&](int s) { return base + s * C::kStageBytes; };
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid == 32) {
    int run = 0;
    offs[0] = 0;
    for (int e = 0; e < a.E; ++e) {
      run = min(run + a.gs[e], a.M);
      offs[e + 1] = run;
    }
  }
  __syncthreads();
  // tiles expert-major: all (K, N) tiles of group g, then g + 1, so the
  // ~132 tiles in flight read one group's rows from L2
  const int tiles_n = (a.N + BN - 1) / BN;
  const int per_g = ((a.K + kBM - 1) / kBM) * tiles_n;
  const int tiles = a.E * per_g;
  auto tile = [&](int t, int& g, int& k0, int& n0, int& lo, int& nk) {
    g = t / per_g;
    const int r = t % per_g;
    k0 = (r / tiles_n) * kBM;
    n0 = (r % tiles_n) * BN;
    lo = offs[g];
    nk = (offs[g + 1] - lo + kBK - 1) / kBK;
  };

  if (tid < 128) {
    // ---------------- producer: one thread issues every load ----------------
    regs_down<C::kLoadRegs>();
    if (tid != 0) return;
    int s = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int g, k0, n0, lo, nk;
      tile(t, g, k0, n0, lo, nk);
      // boxes wholly past K or N are not loaded: their rows and columns
      // are never stored
      const int a_boxes = min(2, (a.K - k0 + 63) / 64);
      const int boxes = b_boxes<BN, false>(n0, a.N);
      const uint32_t bytes = (a_boxes + boxes) * kBK * 128;
      for (int ks = 0; ks < nk; ++ks) {
        const int r0 = lo + ks * kBK;
        mbar_wait(&empty[s], ph ^ 1);
        mbar_arrive_tx(&full[s], bytes);
        for (int j = 0; j < a_boxes; ++j)
          tma_load_2d(stage(s) + j * (kBK * 128), &tmA, &full[s], k0 + 64 * j,
                      r0);
        load_b<BN, false>(stage(s) + C::kABytes, &tmB, &full[s], n0, r0, 0,
                          boxes);
        if (++s == C::kStages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  regs_up<C::kMathRegs>();
  const int wgi = tid / 128 - 1, lt = tid & 127;
  const int warp = lt >> 5, lane = tid & 31, q = lane & 3;
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  };
  int s = 0;
  uint32_t ph = 0;
  float acc[C::kAcc];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int g, k0, n0, lo, nk;
    tile(t, g, k0, n0, lo, nk);
#pragma unroll
    for (int i = 0; i < C::kAcc; ++i) acc[i] = 0.f;
    int prev = 0;
    for (int ks = 0; ks < nk; ++ks) {
      mbar_wait(&full[s], ph);
      unsigned char* st = stage(s);
      const int live = offs[g + 1] - (lo + ks * kBK);
      if (live < kBK) {
        // the next group's rows of this warpgroup's A box: zeros
        unsigned char* box = st + wgi * (kBK * 128);
        for (int e = lt; e < (kBK - live) * 8; e += 128)
          *reinterpret_cast<uint4*>(box + live * 128 + e * 16) =
              make_uint4(0, 0, 0, 0);
        fence_async_shared();
        named_sync(1 + wgi, 128);
      }
      const uint32_t sa = smem_u32(st);
      const uint32_t a0 = sa + wgi * (kBK * 128), b0 = sa + C::kABytes;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma<BN, 1, 1>(acc, desc(a0 + kk * 2048, kBK * 128, 1024),
                        desc(b0 + kk * 2048, kBK * 128, 1024));
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();   // the previous stage's products have retired
      fence_acc(acc);
      if (ks > 0) release(prev);
      prev = s;
      if (++s == C::kStages) {
        s = 0;
        ph ^= 1;
      }
    }
    if (nk > 0) {
      wgmma_wait<0>();
      fence_acc(acc);
      release(prev);
    }
    // rows [k0, k0 + 128) ∩ [0, K) of out[g], columns [n0, n0 + BN) ∩
    // [0, N); an empty group's tiles are zeros. Each quad trades its
    // pieces so that a lane holds 8 whole columns of a row (bf16) or lane
    // pairs trade so that it holds 4 (f32): 16 bytes a store.
    const int rw = warp * 16 + (lane >> 2);   // row in the warpgroup's 64
    if constexpr (C::kTmaOut) {
      // this warpgroup's 64 rows, 128 columns a round: two boxes of 64
      // rows x 128 bytes, 16-byte chunk c of row r at c ^ (r % 8); free
      // once the last round's stores have read them
      unsigned char* ob = obuf + wgi * 16384;
#pragma unroll
      for (int half = 0; half < BN / 128; ++half) {
        if (lt == 0) bulk_wait<0, true>();
        named_sync(1 + wgi, 128);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rw + 8 * h;
#pragma unroll
          for (int m = 4 * half; m < 4 * half + 4; ++m) {
            uint32_t v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              v[i] = pack_bf16(acc[4 * (4 * m + i) + 2 * h],
                               acc[4 * (4 * m + i) + 2 * h + 1]);
            transpose4<1>(v, q);
            const int c = 4 * (m - 4 * half) + q;   // 8-column chunk
            *reinterpret_cast<uint4*>(ob + (c >> 3) * 8192 + r * 128 +
                                      (((c & 7) ^ (r & 7)) << 4)) =
                make_uint4(v[0], v[1], v[2], v[3]);
          }
        }
        fence_async_shared();
        named_sync(1 + wgi, 128);
        const int c0 = n0 + 128 * half;
        if (lt == 0 && k0 + 64 * wgi < a.K && c0 < a.N) {
          tma_store_3d(&tmO, ob, c0, k0 + 64 * wgi, g);
          if (c0 + 64 < a.N)
            tma_store_3d(&tmO, ob + 8192, c0 + 64, k0 + 64 * wgi, g);
          bulk_commit();
        }
      }
    } else {
      OutT* out = static_cast<OutT*>(a.out) + int64_t(g) * a.K * a.N;
      const int odd = q & 1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = k0 + wgi * 64 + rw + 8 * h;
        OutT* p = out + int64_t(row) * a.N;
#pragma unroll
        for (int j = 0; j < BN / 8; j += 2) {
          const float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
          const float y0 = acc[4 * (j + 1) + 2 * h];
          const float y1 = acc[4 * (j + 1) + 2 * h + 1];
          // an even lane sends its chunk j + 1, an odd one its chunk j
          const float u0 = __shfl_xor_sync(kFullMask, odd ? x0 : y0, 1);
          const float u1 = __shfl_xor_sync(kFullMask, odd ? x1 : y1, 1);
          const float4 v = odd ? make_float4(u0, u1, y0, y1)
                               : make_float4(x0, x1, u0, u1);
          const int col = n0 + 8 * (j + odd) + 2 * (q - odd);
          if (row < a.K && col < a.N)
            __stcs(reinterpret_cast<float4*>(p + col), v);
        }
      }
    }
  }
  if constexpr (C::kTmaOut) {
    if (lt == 0) bulk_wait<0, false>();   // the stores are done
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps and the launches
// ---------------------------------------------------------------------------
// The kernel over args; lhs [M, K] bf16 (gmm; unused by B9) and rhs
// [E, K, N] (bf16 or int8) or [E, N, K] (kTransB), 16-byte aligned, K and
// N multiples of 8 (of 16 for an int8 rhs).
template <int BN, bool kGather, bool kTransB, bool kInt8B>
cudaError_t launch(const Args& a, const void* lhs, const void* rhs,
                   cudaStream_t stream) {
  using C = Cfg<BN, kGather, kTransB, kInt8B>;
  alignas(64) CUtensorMap tmA{}, tmB{};
  const cuuint64_t K = a.K, N = a.N, E = a.E;
  cudaError_t err;
  if (!kGather) {
    const cuuint64_t dims[2] = {K, cuuint64_t(a.M)}, strides[1] = {2 * K};
    const cuuint32_t box[2] = {kBK, kBM};
    err = encode(&tmA, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, lhs, dims, strides,
                 box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  if (kTransB) {
    const cuuint64_t dims[3] = {K, N, E}, strides[2] = {2 * K, 2 * K * N};
    const cuuint32_t box[3] = {kBK, BN, 1};
    err = encode(&tmB, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, rhs, dims, strides,
                 box, CU_TENSOR_MAP_SWIZZLE_128B);
  } else if (kInt8B) {
    const cuuint64_t dims[3] = {N, K, E}, strides[2] = {N, K * N};
    const cuuint32_t box[3] = {128, kBK, 1};
    err = encode(&tmB, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, rhs, dims, strides,
                 box, CU_TENSOR_MAP_SWIZZLE_128B);
  } else {
    const cuuint64_t dims[3] = {N, K, E}, strides[2] = {2 * N, 2 * K * N};
    const cuuint32_t box[3] = {64, kBK, 1};
    err = encode(&tmB, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, rhs, dims, strides,
                 box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err != cudaSuccess) return err;
  const int smem = C::smem_bytes(a.E);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = grouped_gemm_sm90<BN, kGather, kTransB, kInt8B>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = ((a.M + kBM - 1) / kBM) * ((a.N + BN - 1) / BN);
  kernel<<<std::min(tiles, sms), kThreads, smem, stream>>>(a, tmA, tmB);
  return cudaGetLastError();
}

// tgmm over args: lhs [M, K] (lhs^T's storage) and rhs [M, N] bf16, 16-byte
// aligned, K and N multiples of 8, M > 0; out [E, K, N] of OutT
template <int BN, typename OutT>
cudaError_t launch_tgmm(const TArgs& a, const void* lhs, const void* rhs,
                        cudaStream_t stream) {
  using C = TCfg<BN, OutT>;
  alignas(64) CUtensorMap tmA{}, tmB{}, tmO{};
  const cuuint64_t M = a.M, K = a.K, N = a.N;
  const cuuint64_t adims[2] = {K, M}, astrides[1] = {2 * K};
  const cuuint32_t abox[2] = {64, kBK};
  cudaError_t err = encode(&tmA, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, lhs,
                           adims, astrides, abox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const cuuint64_t bdims[3] = {N, M, 1}, bstrides[2] = {2 * N, 2 * N * M};
  const cuuint32_t bbox[3] = {64, kBK, 1};
  err = encode(&tmB, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, rhs, bdims, bstrides,
               bbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  if (C::kTmaOut) {
    const cuuint64_t odims[3] = {N, K, cuuint64_t(a.E)};
    const cuuint64_t ostrides[2] = {2 * N, 2 * N * K};
    const cuuint32_t obox[3] = {64, 64, 1};
    err = encode(&tmO, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, a.out, odims,
                 ostrides, obox, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  const int smem = C::smem_bytes(a.E);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = tgmm_sm90<BN, OutT>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = a.E * ((a.K + kBM - 1) / kBM) * ((a.N + BN - 1) / BN);
  kernel<<<std::min(tiles, sms), kThreads, smem, stream>>>(a, tmA, tmB, tmO);
  return cudaGetLastError();
}

// the tile width the wrapper picked (256 or 128) -> its instantiation
template <bool kGather, bool kTransB, bool kInt8B>
cudaError_t launch_bn(int bn, const Args& a, const void* lhs, const void* rhs,
                      cudaStream_t stream) {
  if (bn == 256)
    return launch<256, kGather, kTransB, kInt8B>(a, lhs, rhs, stream);
  if (bn == 128)
    return launch<128, kGather, kTransB, kInt8B>(a, lhs, rhs, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace sm90
}  // namespace ptt
