// FlashAttention-2 backward, dK and dV, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/kernels/pallas_attention.py
// `_dkv_kernel` (pallas_call :253, launched by `_bwd`, the backward of the
// `_flash` custom_vjp).
//
// What bounds it on the H100: tensor-core FLOPs. Each (query, key) pair
// takes four D-long products (S^T = K Q^T, dP^T = V dO^T, dV += P^T dO,
// dK += dS^T Q), so the floor is 4*B*Hq*S^2*D FLOPs when causal (twice
// that when not) over 989 TFLOP/s, far above the bytes moved at training
// widths. One 64-row K/V tile against a 64-row Q/dO tile does 128
// operations a byte of Q and dO, under the card's ~295: the Q/dO stream
// has to come from L2, not device memory, which the item order below sees
// to.
//
// A work item is 64 kv rows of one (batch, kv head). It walks the G =
// Hq/Hkv query heads of the group (query head h reads kv head h / G) and,
// for each, the query tiles from the causal diagonal to S, as the TPU
// kernel's grid (kv tile, group head, query tile) does. It recomputes P^T
// and dS^T = P^T (dP^T - Delta) scale from the forward's f32 LSE and the
// Delta that flash_dq.cu wrote (or the caller gave), and accumulates in
// f32 dV += round(P)^T dO and dK += round(dS)^T Q with the TPU kernel's
// roundings (P to dO's dtype, dS to Q's). dK and dV are written once, at
// Hkv heads: no atomics, so the result is deterministic and the same for
// any G.
//
// bf16 (the training path):
//   - A persistent grid, one block per SM, walks the work items heaviest
//     (causal) first: kv tile 0 of every (batch, kv head), then tile 1,
//     and so on, so the blocks of a round do about the same work and the
//     blocks on neighbouring tiles of one head read its Q and dO close
//     together in time, which L2 then serves.
//   - A block is one consumer warpgroup and one producer warp whose lane 0
//     issues TMA loads from 4-D maps over [B, S, H, D] (64-column boxes of
//     128-byte swizzled rows; rows past S are zero fill): the item's K and
//     V tiles once, and a ring of 4 (D = 128) or 8 stages of 64-row Q and
//     dO tiles with their LSE and Delta slices (1-D maps over [B*Hq*S],
//     any S: a box starts at the 16-byte-aligned element at or before the
//     slice and takes 4 more; it may run into the next head's rows, which
//     are masked by position), running on across items.
//   - S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16, K and V the
//     shared-memory A operands, Q and dO K-major B; P^T is computed while
//     dP^T is still in flight. P^T and dS^T, rounded to bf16, are wgmma's
//     register A operands of dV += P^T dO and dK += dS^T Q, with dO and Q
//     read N-major: a second descriptor of the same swizzled tile.
//   - Only the diagonal query tile (and the ragged end of S) is masked.
//   Registers: a consumer holds dK and dV (2 x D/2 f32) and S^T and dP^T
//   (32 each): ~192 at D = 128 before addresses and the A fragments (240
//   in all, no spill). ptxas holds a thread of a block of more than 256
//   threads to 168 (flash_fwd.cu), so two such warpgroups beside a
//   producer warp would spill; a 160-thread block (one warpgroup and one
//   warp) keeps up to 255, at the price of one warpgroup an SM: no second
//   warpgroup fills the tensor cores while this one computes P and dS.
//   Tried and dropped (H100, llama-2.6b step's shape, one call each):
//   two warpgroups of 64 kv rows (128-row items) in a 256-thread block
//   with thread 0 issuing the loads (254 registers, no spill) took 1.61 ms
//   against 1.40 (1.59 with two tiles of slack between the warpgroups):
//   the loading thread's waits hold them in step; a dV warpgroup and a dK
//   warpgroup beside a producer warp (both compute S^T; 168 registers)
//   took 2.07 against 1.38 (2.17 with the roles as a runtime branch, where
//   ptxas serialized the wgmma).
// f32 (CPU-parity checks): the products run on CUDA cores in full f32.
#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace ptt;
using sm90::bf16;

constexpr int kBN = 64;   // kv rows per block (f32) or work item (bf16)

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA, a warp-specialised producer
// ---------------------------------------------------------------------------
constexpr int kQRows = 64;       // rows of a Q or dO tile
constexpr int kWgThreads = 160;  // warps 0-3 compute, warp 4 loads

template <int D>
struct Dkv {
  static_assert(D == 64 || D == 128, "head_dim");
  static constexpr int kBoxes = D / 64;          // 64-column boxes a row
  static constexpr int kBox = 64 * 128;          // a box of 64 rows
  static constexpr int kTile = kBoxes * kBox;    // a K, V, Q or dO tile
  // LSE, then Delta: a 1-D TMA box starts 16-byte aligned, so a slice is
  // loaded from the aligned element at or before it, 4 more than a tile
  static constexpr int kStatBox = kQRows + 4;
  static constexpr int kStatSlot = 384;          // bytes, 128-aligned
  static constexpr int kStats = 2 * kStatSlot;
  static constexpr int kStages = D == 128 ? 4 : 8;
  static constexpr int kBars = 2 + 2 * kStages;  // K/V full, empty; stages
  static constexpr int kSmem = sm90::kAlign + 2 * kTile +
                               kStages * (2 * kTile + kStats) + 8 * kBars;
  static_assert(kSmem <= sm90::kMaxSmem, "shared memory");
};

// q/dout [B, S, Hq, D] and k/v [B, S, Hkv, D] (maps), lse and delta
// [B*Hq*S] f32 (1-D maps), dk/dv [B, S, Hkv, D]. A persistent grid: block
// b takes work items b, b + gridDim.x, ...; item w is kv tile
// w / (B * Hkv) of (batch, kv head) w % (B * Hkv).
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dkv_sm90(const __grid_constant__ CUtensorMap tmQ,
               const __grid_constant__ CUtensorMap tmDO,
               const __grid_constant__ CUtensorMap tmK,
               const __grid_constant__ CUtensorMap tmV,
               const __grid_constant__ CUtensorMap tmL,
               const __grid_constant__ CUtensorMap tmD,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int S,
               int Hq, int Hkv, int causal, float scale) {
  using namespace ptt::sm90;
  using F = Dkv<D>;
  extern __shared__ unsigned char dyn[];
  unsigned char* base = dyn + ((kAlign - (smem_u32(dyn) & (kAlign - 1))) &
                               (kAlign - 1));
  unsigned char* kv = base;                       // K, then V
  auto qst = [&](int s) { return base + (2 + 2 * s) * F::kTile; };  // Q, dO
  auto stats = [&](int s) {
    return reinterpret_cast<float*>(base + (2 + 2 * F::kStages) * F::kTile +
                                    s * F::kStats);
  };
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(
      base + (2 + 2 * F::kStages) * F::kTile + F::kStages * F::kStats);
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* full = kv_empty + 1;
  uint64_t* empty = full + F::kStages;
  const int tid = threadIdx.x;
  const int G = Hq / Hkv, n_kv = (S + kBN - 1) / kBN;
  const int items = B * Hkv * n_kv;
  // work item w: (batch, kv head, first kv row, first query row, query
  // tiles per group head)
  auto item = [&](int w, int& b, int& hk, int& n0, int& m_start, int& nq) {
    const int bh = w % (B * Hkv);
    b = bh / Hkv;
    hk = bh % Hkv;
    n0 = w / (B * Hkv) * kBN;
    // causal: query tiles ending before the item's first kv row add nothing
    m_start = causal ? n0 : 0;
    nq = (S - m_start + kQRows - 1) / kQRows;
  };
  if (tid == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 4);   // one arrival a consumer warp
    for (int s = 0; s < F::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    // ---------------- producer: one thread issues every load ----------------
    if (tid != 128) return;
    int s = 0;
    uint32_t ph = 0;
    for (int w = blockIdx.x, nth = 0; w < items; w += gridDim.x, ++nth) {
      int b, hk, n0, m_start, nq;
      item(w, b, hk, n0, m_start, nq);
      mbar_wait(kv_empty, (nth & 1) ^ 1);
      mbar_arrive_tx(kv_full, 2 * F::kTile);
      for (int j = 0; j < F::kBoxes; ++j) {
        tma_load_4d(kv + j * F::kBox, &tmK, kv_full, 64 * j, hk, n0, b);
        tma_load_4d(kv + F::kTile + j * F::kBox, &tmV, kv_full, 64 * j, hk,
                    n0, b);
      }
      for (int t = 0; t < G * nq; ++t) {
        const int hq = hk * G + t / nq, m0 = m_start + (t % nq) * kQRows;
        mbar_wait(&empty[s], ph ^ 1);
        mbar_arrive_tx(&full[s], 2 * F::kTile + 2 * F::kStatBox * 4);
        for (int j = 0; j < F::kBoxes; ++j) {
          tma_load_4d(qst(s) + j * F::kBox, &tmQ, &full[s], 64 * j, hq, m0,
                      b);
          tma_load_4d(qst(s) + F::kTile + j * F::kBox, &tmDO, &full[s],
                      64 * j, hq, m0, b);
        }
        const int stat = ((b * Hq + hq) * S + m0) & ~3;
        tma_load_1d(stats(s), &tmL, &full[s], stat);
        tma_load_1d(stats(s) + F::kStatSlot / 4, &tmD, &full[s], stat);
        if (++s == F::kStages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---------------- consumer warpgroup ----------------
  const int warp = tid >> 5, lane = tid & 31, q = lane & 3;
  const float sl2 = scale * kLog2e;
  auto arrive = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  const uint32_t ka = smem_u32(kv), va = ka + F::kTile;
  int s = 0;
  uint32_t ph = 0;
  for (int w = blockIdx.x, nth = 0; w < items; w += gridDim.x, ++nth) {
    int b, hk, n0, m_start, nq;
    item(w, b, hk, n0, m_start, nq);
    // this thread's kv rows: r0 (accumulator entries 4j, 4j + 1) and
    // r0 + 8 (4j + 2, 4j + 3); query columns 8j + 2q + {0, 1} of chunk j
    const int r0 = n0 + warp * 16 + (lane >> 2);
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    mbar_wait(kv_full, nth & 1);
    for (int t = 0; t < G * nq; ++t) {
      const int hq = hk * G + t / nq, m0 = m_start + (t % nq) * kQRows;
      mbar_wait(&full[s], ph);
      const uint32_t qa = smem_u32(qst(s)), oa = qa + F::kTile;
      // the slices of this tile's rows, past the aligned start
      const float* lse_s = stats(s) + (((b * Hq + hq) * S + m0) & 3);
      const float* del_s = lse_s + F::kStatSlot / 4;
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      fence_acc(sc);
      fence_acc(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_n64<0, 0>(
            sc, desc(ka + (kk >> 2) * F::kBox + (kk & 3) * 32, 16, 1024),
            desc(qa + (kk >> 2) * F::kBox + (kk & 3) * 32, 16, 1024));
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_n64<0, 0>(
            dp, desc(va + (kk >> 2) * F::kBox + (kk & 3) * 32, 16, 1024),
            desc(oa + (kk >> 2) * F::kBox + (kk & 3) * 32, 16, 1024));
      wgmma_commit();
      fence_acc(sc);
      wgmma_wait<1>();   // S^T landed; dP^T still in flight
      fence_acc(sc);

      // P^T = 2^(s * scale * log2(e) - lse * log2(e)), masked across the
      // diagonal (query before key) and past S
      const bool edge = (causal && m0 < n0 + kBN) || m0 + kQRows > S;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = fast_exp2(fmaf(sc[4 * j + e], sl2,
                                   -lse_s[8 * j + 2 * q + (e & 1)] * kLog2e));
          if (edge) {
            const int col = m0 + 8 * j + 2 * q + (e & 1);
            const int row = r0 + 8 * (e >> 1);
            if (col >= S || (causal && col < row)) p = 0.f;
          }
          sc[4 * j + e] = p;
        }
      }
      fence_acc(dp);
      wgmma_wait<0>();
      fence_acc(dp);

      // dS^T = P^T (dP^T - Delta) scale; P^T and dS^T rounded to bf16 as
      // the A fragments of dV and dK: chunks 2i, 2i + 1 are reduction step i
      uint32_t pa[4][4], dsa[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[e] = sc[4 * j + e] *
                  (dp[4 * j + e] - del_s[8 * j + 2 * q + (e & 1)]) * scale;
        pa[j >> 1][(j & 1) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
        dsa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
        dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dV += P^T dO and dK += dS^T Q, dO and Q N-major
      fence_acc(dva);
      fence_acc(dka);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk)
        wgmma_ra<D, 1>(dva, pa[kk], desc(oa + kk * 2048, F::kBox, 1024));
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk)
        wgmma_ra<D, 1>(dka, dsa[kk], desc(qa + kk * 2048, F::kBox, 1024));
      wgmma_commit();
      fence_acc(dva);
      fence_acc(dka);
      wgmma_wait<0>();
      fence_acc(dva);
      fence_acc(dka);
      arrive(&empty[s]);   // Q, dO, LSE and Delta of stage s read
      if (++s == F::kStages) {
        s = 0;
        ph ^= 1;
      }
    }
    arrive(kv_empty);   // K and V read: the next item's may land

    // dK and dV in bf16, 16 bytes a lane after a quad transpose
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      const int64_t off = ((int64_t(b) * S + row) * Hkv + hk) * D;
#pragma unroll
      for (int m = 0; m < D / 32; ++m) {
        uint32_t vk[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          vk[i] = pack_bf16(dka[4 * (4 * m + i) + 2 * h],
                            dka[4 * (4 * m + i) + 2 * h + 1]);
          vv[i] = pack_bf16(dva[4 * (4 * m + i) + 2 * h],
                            dva[4 * (4 * m + i) + 2 * h + 1]);
        }
        transpose4<1>(vk, q);
        transpose4<1>(vv, q);
        if (row < S) {
          *reinterpret_cast<uint4*>(dk + off + 8 * (4 * m + q)) =
              make_uint4(vk[0], vk[1], vk[2], vk[3]);
          *reinterpret_cast<uint4*>(dv + off + 8 * (4 * m + q)) =
              make_uint4(vv[0], vv[1], vv[2], vv[3]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;  // 16 x 16: thread (ty, tx) owns kv rows ty+16i, query cols tx+16j
constexpr int kBM = 64;        // query rows per tile

template <int D>
constexpr int smem_floats() {
  // K, V, Q, dO; P^T, dS^T; LSE, Delta
  return 4 * 64 * (D + 1) + 2 * kBN * (kBM + 1) + 2 * kBM;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int S, int Hq, int Hkv,
                     int causal, float scale) {
  constexpr int P = D + 1;             // padded row: conflict-free column reads
  constexpr int PT = kBM + 1;
  extern __shared__ float smem[];
  float* Ks = smem;                    // [kBN][P]
  float* Vs = Ks + kBN * P;            // [kBN][P]
  float* Qs = Vs + kBN * P;            // [kBM][P]
  float* dOs = Qs + kBM * P;           // [kBM][P]
  float* Ps = dOs + kBM * P;           // [kBN][PT]: P^T
  float* dSs = Ps + kBN * PT;          // [kBN][PT]: dS^T
  float* lse_s = dSs + kBN * PT;       // [kBM]
  float* del_s = lse_s + kBM;          // [kBM]

  const int bh = blockIdx.y;
  const int b = bh / Hkv, hk = bh % Hkv;
  const int G = Hq / Hkv;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  const int64_t q_step = int64_t(Hq) * D;
  const int64_t kv_step = int64_t(Hkv) * D;
  const int64_t kv_off = (int64_t(b) * S * Hkv + hk) * D;

  for (int e = tid; e < kBN * D; e += kThreads) {
    const int r = e / D, d = e % D, s = n0 + r;
    const bool live = s < S;
    Ks[r * P + d] = live ? k[kv_off + s * kv_step + d] : 0.f;
    Vs[r * P + d] = live ? v[kv_off + s * kv_step + d] : 0.f;
  }

  constexpr int DC = D / 16;   // dK/dV columns per thread
  float dka[4][DC], dva[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[i][c] = dva[i][c] = 0.f;

  const int m_start = causal ? n0 : 0;
  for (int gi = 0; gi < G; ++gi) {
    const int hq = hk * G + gi;
    const int64_t q_off = (int64_t(b) * S * Hq + hq) * D;
    const int64_t stat = (int64_t(b) * Hq + hq) * S;
    for (int m0 = m_start; m0 < S; m0 += kBM) {
      __syncthreads();   // the previous tile's readers are done
      for (int e = tid; e < kBM * D; e += kThreads) {
        const int r = e / D, d = e % D, s = m0 + r;
        const bool live = s < S;
        Qs[r * P + d] = live ? q[q_off + s * q_step + d] : 0.f;
        dOs[r * P + d] = live ? dout[q_off + s * q_step + d] : 0.f;
      }
      if (tid < kBM) {
        const bool live = m0 + tid < S;
        lse_s[tid] = live ? lse[stat + m0 + tid] : 0.f;
        del_s[tid] = live ? delta[stat + m0 + tid] : 0.f;
      }
      __syncthreads();

      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(ty + 16 * i) * P + d];
          vv[i] = Vs[(ty + 16 * i) * P + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = Qs[(tx + 16 * j) * P + d];
          dov[j] = dOs[(tx + 16 * j) * P + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], dov[j], dpt[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = n0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = tx + 16 * j, qry = m0 + qc;
          const bool live = qry < S && key < S && (!causal || key <= qry);
          const float p = live ? expf(st[i][j] * scale - lse_s[qc]) : 0.f;
          Ps[(ty + 16 * i) * PT + qc] = p;
          dSs[(ty + 16 * i) * PT + qc] = p * (dpt[i][j] - del_s[qc]) * scale;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < kBM; ++c) {
        float pv[4], dsv[4], dov[DC], qv[DC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[(ty + 16 * i) * PT + c];
          dsv[i] = dSs[(ty + 16 * i) * PT + c];
        }
#pragma unroll
        for (int cc = 0; cc < DC; ++cc) {
          dov[cc] = dOs[c * P + tx + 16 * cc];
          qv[cc] = Qs[c * P + tx + 16 * cc];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int cc = 0; cc < DC; ++cc) {
            dva[i][cc] = fmaf(pv[i], dov[cc], dva[i][cc]);
            dka[i][cc] = fmaf(dsv[i], qv[cc], dka[i][cc]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = n0 + ty + 16 * i;
    if (row >= S) continue;
    const int64_t off = kv_off + row * kv_step;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[off + tx + 16 * c] = dka[i][c];
      dv[off + tx + 16 * c] = dva[i][c];
    }
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta,
                        void* dk, void* dv, int B, int S, int Hq, int Hkv,
                        int causal, float scale, cudaStream_t stream) {
  using F = Dkv<D>;
  alignas(64) CUtensorMap tmQ{}, tmDO{}, tmK{}, tmV{}, tmL{}, tmD{};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint64_t qdims[4] = {D, cuuint64_t(Hq), cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t qstr[3] = {2ull * D, 2ull * D * Hq, 2ull * D * Hq * S};
  const cuuint64_t kdims[4] = {D, cuuint64_t(Hkv), cuuint64_t(S),
                               cuuint64_t(B)};
  const cuuint64_t kstr[3] = {2ull * D, 2ull * D * Hkv, 2ull * D * Hkv * S};
  const cuuint64_t sdims[1] = {cuuint64_t(B) * Hq * S};
  const cuuint32_t sbox[1] = {F::kStatBox};
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const auto none = CU_TENSOR_MAP_SWIZZLE_NONE;
  cudaError_t err = sm90::encode(&tmQ, bf, 4, q, qdims, qstr, box, sw);
  if (err == cudaSuccess)
    err = sm90::encode(&tmDO, bf, 4, dout, qdims, qstr, box, sw);
  if (err == cudaSuccess)
    err = sm90::encode(&tmK, bf, 4, k, kdims, kstr, box, sw);
  if (err == cudaSuccess)
    err = sm90::encode(&tmV, bf, 4, v, kdims, kstr, box, sw);
  if (err == cudaSuccess)
    err = sm90::encode(&tmL, f32, 1, lse, sdims, sdims, sbox, none);
  if (err == cudaSuccess)
    err = sm90::encode(&tmD, f32, 1, delta, sdims, sdims, sbox, none);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_dkv_sm90<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             F::kSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_kv = (S + kBN - 1) / kBN;
  const int grid = std::min(B * Hkv * n_kv, sms);
  flash_dkv_sm90<D><<<grid, kWgThreads, F::kSmem, stream>>>(
      tmQ, tmDO, tmK, tmV, tmL, tmD, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), B, S, Hq, Hkv, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int S, int Hq, int Hkv,
                       int causal, float scale, cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBN - 1) / kBN, B * Hkv);
  flash_dkv_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), S, Hq, Hkv,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. D must be 64 or 128 (the wrapper checks).
extern "C" int ptt_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv, int B,
                             int S, int Hq, int Hkv, int D, int dtype,
                             int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && D == 128)
    return launch_f32<128>(q, k, v, dout, lse, delta, dk, dv, B, S, Hq, Hkv,
                           causal, scale, st);
  if (dtype == kF32 && D == 64)
    return launch_f32<64>(q, k, v, dout, lse, delta, dk, dv, B, S, Hq, Hkv,
                          causal, scale, st);
  if (dtype == kBF16 && D == 128)
    return launch_bf16<128>(q, k, v, dout, lse, delta, dk, dv, B, S, Hq, Hkv,
                            causal, scale, st);
  if (dtype == kBF16 && D == 64)
    return launch_bf16<64>(q, k, v, dout, lse, delta, dk, dv, B, S, Hq, Hkv,
                           causal, scale, st);
  return cudaErrorInvalidValue;
}
