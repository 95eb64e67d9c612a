// FlashAttention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/kernels/pallas_attention.py
// `_fwd_kernel` (pallas_call :107, launched by `_fwd`, called through
// `flash_attention_fwd`).
//
// What bounds it on the H100: tensor-core FLOPs. At prefill and training
// widths (S in the hundreds to thousands, D = 128) attention does about
// S/2 operations per byte of Q/K/V, far above the card's ~295 operations
// per byte, so the floor is 2*B*Hq*S^2*D causal FLOPs over 989 TFLOP/s.
// Feeding the tensor cores at that rate takes wgmma, loads that no
// computing thread issues, and no block-wide barrier between K/V tiles.
//
// bf16 (serving and training; D = 64 or 128), FlashAttention-3's shape:
//   - A persistent grid, one block per SM, walks work items of 128 query
//     rows of one (batch, head), heaviest (causal) first: the query tiles
//     in reverse order, every (batch, head) of a tile before the next, so
//     the causal imbalance does not leave SMs idle at the end and the
//     query heads that share a kv head follow each other through L2.
//   - A block is two consumer warpgroups of 64 query rows each and a
//     producer warpgroup that gives most of its registers to them
//     (setmaxnreg) and keeps one thread issuing TMA loads: each item's Q
//     tile into one of two buffers, and K and V tiles of 128 rows into a
//     ring of 2 (D = 128: 2 x 32 + 2 x 64 KB of shared memory) or 4
//     stages that runs on across items, K and V each behind its own full
//     mbarrier (S = Q K^T starts while V is still landing). So an item's
//     loads run ahead while the consumers finish the one before.
//   - TMA reads q, k and v as stored, [B, S, H, D], through 4-D maps
//     (D, H, S, B) in 64-column boxes of 128-byte swizzled rows; rows past
//     S are TMA's zero fill, never the next batch's rows.
//   - S = Q K^T by wgmma m64n128k16, Q and K both K-major from shared
//     memory; the online softmax runs in registers in f32, with the scale
//     folded into exp2 and each row's sum kept per thread until the end.
//   - P, rounded to bf16 as the TPU kernel rounds it, is wgmma's register
//     A operand for O += P V: the score accumulator's column chunks 2i and
//     2i + 1 are the A fragment of reduction step i. V is the N-major B
//     operand.
//   - Causal: tiles above the diagonal are skipped and only tiles that
//     cross it (or the ragged end of S) are masked. Query head h reads kv
//     head h / (Hq/Hkv) (the repeat-interleave GQA convention of the JAX
//     kernel).
//   - The epilogue divides by the row sums, rounds to bf16 and stores 16
//     bytes a lane after a quad transpose; lse [B, Hq, S] is m + log(l) in
//     natural units, the convention flash_dq.cu and flash_dkv.cu read.
//   Not here: FlashAttention-3's overlap of a warpgroup's softmax with its
//   own next products. It keeps a second score tile live (~220 registers
//   a thread at D = 128), and ptxas holds every thread of a block of more
//   than 256 threads to 168 (setmaxnreg does not lift that): it spilled
//   and serialized the products, 1.6x slower; with 64-row K/V tiles it
//   fit but ran ~10% slower (measured on an H100, PERF.md). Two warpgroups
//   taking turns on the tensor cores (ping-pong) gave nothing measurable.
// f32 (CPU-parity checks): the products run on CUDA cores in full f32
// (FMA), since the tensor cores would round the inputs to tf32: one
// 256-thread block per (batch*head, 64 query rows), 64-row K/V tiles.
#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace ptt;
using sm90::bf16;

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA, a warp-specialised producer
// ---------------------------------------------------------------------------
constexpr int kQRows = 128;      // query rows of a block (2 warpgroups x 64)
constexpr int kKVRows = 128;     // rows of a K or V tile
constexpr int kWgThreads = 384;  // warpgroup 0 loads, 1 and 2 compute
constexpr int kLoadRegs = 24;    // 128 x 24 + 256 x 240 = 64,512 registers
constexpr int kMathRegs = 240;

template <int D>
struct Fa3 {
  static_assert(D == 64 || D == 128, "head_dim");
  static constexpr int kBoxes = D / 64;            // 64-column boxes a row
  static constexpr int kBoxBytes = kKVRows * 128;  // a box of 128 rows
  static constexpr int kQBytes = kBoxes * kQRows * 128;
  static constexpr int kKVBytes = kBoxes * kBoxBytes;   // a K or V tile
  // two Q buffers and 2 (D = 128: 2 x 32 + 2 x 64 KB) or 4 K/V stages
  static constexpr int kStages = D == 128 ? 2 : 4;
  static constexpr int kBars = 4 + 3 * kStages;   // Q full, empty; K, V; empty
  static constexpr int kSmem =
      sm90::kAlign + 2 * kQBytes + 2 * kStages * kKVBytes + 8 * kBars;
  static_assert(kSmem <= sm90::kMaxSmem, "shared memory");
};

// q [B, S, Hq, D], k/v [B, S, Hkv, D] (the maps), o [B, S, Hq, D], lse
// [B, Hq, S] f32; scale_log2 = scale * log2(e). A persistent grid: block
// b takes work items b, b + gridDim.x, ..., item w being query tile
// n_q - 1 - w / (B * Hq) of (batch, head) w % (B * Hq), so the heaviest
// (causal) tiles come first.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tmQ,
               const __grid_constant__ CUtensorMap tmK,
               const __grid_constant__ CUtensorMap tmV, bf16* __restrict__ o,
               float* __restrict__ lse, int B, int S, int Hq, int Hkv,
               int causal, float scale_log2) {
  using namespace ptt::sm90;
  using F = Fa3<D>;
  extern __shared__ unsigned char dyn[];
  unsigned char* base = dyn + ((kAlign - (smem_u32(dyn) & (kAlign - 1))) &
                               (kAlign - 1));
  auto qst = [&](int i) { return base + i * F::kQBytes; };
  auto kst = [&](int s) {
    return base + 2 * F::kQBytes + s * 2 * F::kKVBytes;
  };
  auto vst = [&](int s) { return kst(s) + F::kKVBytes; };
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      base + 2 * F::kQBytes + 2 * F::kStages * F::kKVBytes);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full_k = q_empty + 2;
  uint64_t* full_v = full_k + F::kStages;
  uint64_t* empty = full_v + F::kStages;
  const int tid = threadIdx.x;
  const int bh_count = B * Hq, n_q = (S + kQRows - 1) / kQRows;
  const int items = bh_count * n_q;
  // work item w: (batch, head, first query row, K/V tiles it reads)
  auto item = [&](int w, int& b, int& head, int& m0, int& n_tiles) {
    const int bh = w % bh_count;
    b = bh / Hq;
    head = bh % Hq;
    m0 = (n_q - 1 - w / bh_count) * kQRows;
    // causal: tiles starting past the item's last row are fully masked
    const int n_end = causal ? min(S, m0 + kQRows) : S;
    n_tiles = (n_end + kKVRows - 1) / kKVRows;
  };
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 8);   // one arrival a consumer warp
    }
    for (int s = 0; s < F::kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---------------- producer: one thread issues every load ----------------
    // The K/V ring runs on across items, and the Q tiles alternate
    // between two buffers, so an item's loads run ahead while the
    // consumers finish the one before.
    regs_down<kLoadRegs>();
    if (tid != 0) return;
    int s = 0;
    uint32_t ph = 0;
    for (int w = blockIdx.x, nth = 0; w < items; w += gridDim.x, ++nth) {
      int b, head, m0, n_tiles;
      item(w, b, head, m0, n_tiles);
      const int hk = head / (Hq / Hkv), qb = nth & 1;
      mbar_wait(&q_empty[qb], ((nth >> 1) & 1) ^ 1);
      mbar_arrive_tx(&q_full[qb], F::kQBytes);
      for (int j = 0; j < F::kBoxes; ++j)
        tma_load_4d(qst(qb) + j * (kQRows * 128), &tmQ, &q_full[qb], 64 * j,
                    head, m0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int n0 = it * kKVRows;
        mbar_wait(&empty[s], ph ^ 1);
        mbar_arrive_tx(&full_k[s], F::kKVBytes);
        for (int j = 0; j < F::kBoxes; ++j)
          tma_load_4d(kst(s) + j * F::kBoxBytes, &tmK, &full_k[s], 64 * j,
                      hk, n0, b);
        mbar_arrive_tx(&full_v[s], F::kKVBytes);
        for (int j = 0; j < F::kBoxes; ++j)
          tma_load_4d(vst(s) + j * F::kBoxBytes, &tmV, &full_v[s], 64 * j,
                      hk, n0, b);
        if (++s == F::kStages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  regs_up<kMathRegs>();
  const int wgi = tid / 128 - 1, lt = tid & 127;
  const int warp = lt >> 5, lane = tid & 31, q = lane & 3;
  auto arrive = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  int s = 0;
  uint32_t ph = 0;
  for (int w = blockIdx.x, nth = 0; w < items; w += gridDim.x, ++nth) {
    int b, head, m0, n_tiles;
    item(w, b, head, m0, n_tiles);
    const int qb = nth & 1;   // this block's nth item: Q buffer, phase
    const uint32_t qa = smem_u32(qst(qb)) + wgi * (64 * 128);
    // this thread's rows: r0 (accumulator entries 4j, 4j + 1) and r0 + 8
    // (4j + 2, 4j + 3); columns 8j + 2q + {0, 1} of chunk j
    const int r0 = m0 + wgi * 64 + warp * 16 + (lane >> 2);
    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    float m2[2] = {kNegInf, kNegInf};   // running max, scaled to log2 units
    float l[2] = {0.f, 0.f};            // this thread's part of the row sums
    mbar_wait(&q_full[qb], (nth >> 1) & 1);
    for (int it = 0; it < n_tiles; ++it) {
      const int n0 = it * kKVRows;
      float sc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.f;
      mbar_wait(&full_k[s], ph);
      const uint32_t kb = smem_u32(kst(s));
      fence_acc(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_n128<0, 0>(
            sc,
            desc(qa + (kk >> 2) * (kQRows * 128) + (kk & 3) * 32, 16, 1024),
            desc(kb + (kk >> 2) * F::kBoxBytes + (kk & 3) * 32, 16, 1024));
      wgmma_commit();
      fence_acc(sc);
      wgmma_wait<0>();
      fence_acc(sc);
      if (it == n_tiles - 1) arrive(&q_empty[qb]);   // Q read: reusable

      // mask the tiles that cross this warpgroup's diagonal or the end of S
      if ((causal && n0 + kKVRows - 1 > m0 + wgi * 64) || n0 + kKVRows > S) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = n0 + 8 * j + 2 * q + (e & 1);
            const int row = r0 + 8 * (e >> 1);
            if (col >= S || (causal && col > row)) sc[4 * j + e] = kNegInf;
          }
      }
      // online softmax in log2 units: p = 2^(s * scale_log2 - m)
      float mn[2], alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
        mx = group_max<4>(mx);
        mn[i] = fmaxf(m2[i], mx * scale_log2);
        alpha[i] = fast_exp2(m2[i] - mn[i]);
        m2[i] = mn[i];
      }
      // P rounded to bf16 as the A fragments of P V: chunks 2i, 2i + 1 of
      // the scores are reduction step i
      uint32_t pa[8][4];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p0 = fast_exp2(fmaf(sc[4 * j], scale_log2, -mn[0]));
        const float p1 = fast_exp2(fmaf(sc[4 * j + 1], scale_log2, -mn[0]));
        const float p2 = fast_exp2(fmaf(sc[4 * j + 2], scale_log2, -mn[1]));
        const float p3 = fast_exp2(fmaf(sc[4 * j + 3], scale_log2, -mn[1]));
        rs[0] += p0 + p1;
        rs[1] += p2 + p3;
        pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        oacc[4 * j] *= alpha[0];
        oacc[4 * j + 1] *= alpha[0];
        oacc[4 * j + 2] *= alpha[1];
        oacc[4 * j + 3] *= alpha[1];
      }

      // O += P V
      mbar_wait(&full_v[s], ph);
      const uint32_t vb = smem_u32(vst(s));
      fence_acc(oacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKVRows / 16; ++kk)
        wgmma_ra<D, 1>(oacc, pa[kk],
                       desc(vb + kk * 2048, F::kBoxBytes, 1024));
      wgmma_commit();
      fence_acc(oacc);
      wgmma_wait<0>();
      fence_acc(oacc);
      arrive(&empty[s]);   // K and V of stage s read
      if (++s == F::kStages) {
        s = 0;
        ph ^= 1;
      }
    }

    // out = O / l, 16 bytes a lane after a quad transpose; lse = m + log(l)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float sum = group_sum<4>(l[h]);
      const float inv = 1.f / sum;
      const int row = r0 + 8 * h;
      bf16* orow = o + ((int64_t(b) * S + row) * Hq + head) * D;
#pragma unroll
      for (int m = 0; m < D / 32; ++m) {
        uint32_t v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = pack_bf16(oacc[4 * (4 * m + i) + 2 * h] * inv,
                           oacc[4 * (4 * m + i) + 2 * h + 1] * inv);
        transpose4<1>(v, q);
        if (row < S)
          *reinterpret_cast<uint4*>(orow + 8 * (4 * m + q)) =
              make_uint4(v[0], v[1], v[2], v[3]);
      }
      if (q == 0 && row < S)
        lse[(int64_t(b) * Hq + head) * S + row] =
            (m2[h] + __log2f(sum)) * 0.69314718055994531f;
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kBM = 64;        // query rows per block
constexpr int kBN = 64;        // kv rows per tile
constexpr int kThreads = 256;  // 16 x 16: thread (ty, tx) owns rows ty+16i, cols tx+16j

template <int D>
constexpr int smem_floats() {
  return kBM * (D + 1) + kBN * (D + 1) + kBN * D + kBM * (kBN + 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, int Hq, int Hkv,
                     int causal, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // [kBM][D + 1]
  float* Ks = Qs + kBM * (D + 1);     // [kBN][D + 1] (padded: conflict-free column reads)
  float* Vs = Ks + kBN * (D + 1);     // [kBN][D]
  float* Ps = Vs + kBN * D;           // [kBM][kBN + 1]

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int m0 = blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  const int64_t q_step = int64_t(Hq) * D;     // elements between positions
  const int64_t kv_step = int64_t(Hkv) * D;
  const float* qb = q + (int64_t(b) * S * Hq + h) * D;
  const float* kb = k + (int64_t(b) * S * Hkv + hk) * D;
  const float* vb = v + (int64_t(b) * S * Hkv + hk) * D;

  for (int e = tid; e < kBM * D; e += kThreads) {
    const int r = e / D, d = e % D, s = m0 + r;
    Qs[r * (D + 1) + d] = s < S ? qb[s * q_step + d] : 0.f;
  }

  constexpr int DC = D / 16;   // output columns per thread
  float m_i[4], l_i[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // causal: tiles starting past the block's last row are fully masked
  const int n_end = causal ? min(S, m0 + kBM) : S;
  for (int n0 = 0; n0 < n_end; n0 += kBN) {
    __syncthreads();   // the previous tile's readers are done
    for (int e = tid; e < kBN * D; e += kThreads) {
      const int r = e / D, d = e % D, s = n0 + r;
      float kv_k = 0.f, kv_v = 0.f;
      if (s < S) {
        kv_k = kb[s * kv_step + d];
        kv_v = vb[s * kv_step + d];
      }
      Ks[r * (D + 1) + d] = kv_k;
      Vs[r * D + d] = kv_v;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

    // online softmax: a row's 64 columns live in the 16 lanes sharing ty
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx + 16 * j;
        const bool live = col < S && (!causal || col <= row);
        sc[i][j] = live ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = group_max<16>(mx);
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        Ps[(ty + 16 * i) * (kBN + 1) + tx + 16 * j] = p;
      }
      rs = group_sum<16>(rs);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBN; ++c) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (kBN + 1) + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) vv[cc] = Vs[c * D + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < DC; ++cc)
          acc[i][cc] = fmaf(pv[i], vv[cc], acc[i][cc]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= S) continue;
    const float inv = 1.f / l_i[i];
    float* orow = o + ((int64_t(b) * S + row) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = acc[i][c] * inv;
    if (tx == 0) lse[(int64_t(b) * Hq + h) * S + row] = m_i[i] + logf(l_i[i]);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int S, int Hq, int Hkv, int causal,
                        float scale, cudaStream_t stream) {
  using F = Fa3<D>;
  alignas(64) CUtensorMap tmQ{}, tmK{}, tmV{};
  const cuuint32_t box[4] = {64, 1, kQRows, 1};
  const cuuint64_t qdims[4] = {D, cuuint64_t(Hq), cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t qstr[3] = {2ull * D, 2ull * D * Hq, 2ull * D * Hq * S};
  const cuuint64_t kdims[4] = {D, cuuint64_t(Hkv), cuuint64_t(S),
                               cuuint64_t(B)};
  const cuuint64_t kstr[3] = {2ull * D, 2ull * D * Hkv, 2ull * D * Hkv * S};
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  cudaError_t err = sm90::encode(&tmQ, bf, 4, q, qdims, qstr, box, sw);
  if (err == cudaSuccess)
    err = sm90::encode(&tmK, bf, 4, k, kdims, kstr, box, sw);
  if (err == cudaSuccess)
    err = sm90::encode(&tmV, bf, 4, v, kdims, kstr, box, sw);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_sm90<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             F::kSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int items = B * Hq * ((S + kQRows - 1) / kQRows);
  flash_fwd_sm90<D><<<std::min(items, sms), kWgThreads, F::kSmem, stream>>>(
      tmQ, tmK, tmV, static_cast<bf16*>(o), lse, B, S, Hq, Hkv, causal,
      scale * sm90::kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int S, int Hq, int Hkv, int causal,
                       float scale, cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBM - 1) / kBM, B * Hq);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, Hq, Hkv,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. D must be 64 or 128 (the wrapper checks).
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int B, int S, int Hq,
                             int Hkv, int D, int dtype, int causal,
                             float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && D == 128)
    return launch_f32<128>(q, k, v, o, lse, B, S, Hq, Hkv, causal, scale, st);
  if (dtype == kF32 && D == 64)
    return launch_f32<64>(q, k, v, o, lse, B, S, Hq, Hkv, causal, scale, st);
  if (dtype == kBF16 && D == 128)
    return launch_bf16<128>(q, k, v, o, lse, B, S, Hq, Hkv, causal, scale, st);
  if (dtype == kBF16 && D == 64)
    return launch_bf16<64>(q, k, v, o, lse, B, S, Hq, Hkv, causal, scale, st);
  return cudaErrorInvalidValue;
}
