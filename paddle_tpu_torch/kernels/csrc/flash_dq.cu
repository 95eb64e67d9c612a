// FlashAttention-2 backward, dQ, for Hopper (sm_90a), with Delta folded in.
//
// Replaces the TPU kernel paddle_tpu/kernels/pallas_attention.py
// `_dq_kernel` (pallas_call :232, launched by `_bwd`, the backward of the
// `_flash` custom_vjp), and the reduction Delta = rowsum(O * dO) that
// `_bwd` computes before it.
//
// What bounds it on the H100: tensor-core FLOPs. Each (query, key) pair
// takes three D-long products (S = Q K^T, dP = dO V^T, dQ += dS K), so the
// floor is 3*B*Hq*S^2*D FLOPs when causal (twice that when not) over
// 989 TFLOP/s; at training widths (S = 2048, D = 128) that is far above
// the bytes of Q, K, V, O, dO, LSE and Delta over 3.35 TB/s. Feeding the
// tensor cores takes wgmma, loads no computing thread issues, and no
// block-wide barrier between K/V tiles.
//
// Each query row recomputes P = exp(S*scale - LSE) from the forward's f32
// LSE and dS = P*(dP - Delta)*scale, rounds dS to bf16 where the TPU
// kernel rounds it, and accumulates dQ += dS K in f32. dQ is written once,
// in q's dtype: no atomics, so the result is deterministic. Query head h
// reads kv head h / (Hq/Hkv) (the JAX kernel's repeat-interleave GQA).
//
// When the caller passes `out` (flash_attention_bwd on the card), a warp
// of the block computes each work item's Delta in f32 from its rows of O
// and dO, one item ahead of the warpgroups that use it, and writes it to
// a [B, Hq, S] f32 buffer that flash_dkv.cu then reads: the backward needs
// no separate pass over O and dO. Without `out` that warp stages the given
// Delta.
//
// bf16 (the training path), FlashAttention-3's shape for a dQ-only kernel:
//   - A persistent grid, one block per SM, walks work items of 128 query
//     rows of one (batch, head), heaviest (causal) first: the query tiles
//     in reverse order, every (batch, head) of a tile before the next, so
//     the blocks of a round do about the same work and the query heads
//     that share a kv head follow each other through L2 (B1's order).
//   - A block is two consumer warpgroups of 64 query rows each, a Delta
//     warp (above; in shared memory, two buffers) and one producer warp
//     whose lane 0 issues every TMA load: the item's Q and
//     dO into one of two buffers (the next item's load runs while the
//     consumers finish this one), and 64-row K and V tiles into a ring of
//     3 (D = 128) or 6 stages that runs on across items, K and V each
//     behind its own full mbarrier. TMA reads [B, S, H, D] as stored
//     through 4-D maps in 64-column boxes of 128-byte swizzled rows; rows
//     past S are TMA's zero fill.
//   - S = Q K^T and dP = dO V^T are wgmma m64n64k16 with both operands in
//     shared memory (Q, dO and K, V all K-major); P is computed while dP
//     is still in flight. dS, rounded to bf16, is wgmma's register A
//     operand of dQ += dS K, with the same K tile read N-major (a second
//     descriptor of the same swizzled bytes, as B1 reads V).
//   - Causal: K/V tiles past the item's last row are never loaded; only
//     tiles that cross a warpgroup's diagonal (or the ragged end of S) are
//     masked, and a warpgroup skips the products of a tile that lies
//     wholly above its rows.
//   Registers: ptxas holds a thread of a block of more than 256 threads to
//   168 (flash_fwd.cu). A consumer keeps dQ (D/2 f32), S and dP (32 each
//   over a 64-row K/V tile) and dS's 16 A registers: it just fits (168
//   and 52 bytes of spill at D = 128). 128-row K/V tiles would not.
//   Tried and dropped (H100, llama-2.6b step's shape, one call): two
//   consumer warpgroups with thread 0 issuing the loads instead of a
//   producer warp (256 threads, 202 registers, no spill) took 1.022 ms
//   against 0.944: the loading thread waits for the other warpgroup's
//   release, which holds the two warpgroups in step.
// f32 (CPU-parity checks): the products run on CUDA cores in full f32, one
// 256-thread block per (batch*head, 64-row query tile), 64-row K/V tiles;
// Delta is folded in the same way.
#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace ptt;
using sm90::bf16;

constexpr int kBM = 64;   // f32: query rows per block
constexpr int kBN = 64;   // f32: kv rows per tile

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA, a warp-specialised producer
// ---------------------------------------------------------------------------
constexpr int kQRows = 128;      // query rows of a work item (2 x 64)
constexpr int kKVRows = 64;      // rows of a K or V tile
constexpr int kWgThreads = 320;  // warps 0-7 compute, 8 loads, 9 Delta

template <int D>
struct Dq {
  static_assert(D == 64 || D == 128, "head_dim");
  static constexpr int kBoxes = D / 64;             // 64-column boxes a row
  static constexpr int kQBytes = kBoxes * kQRows * 128;   // Q or dO
  static constexpr int kKVBox = kKVRows * 128;      // a box of a K/V tile
  static constexpr int kKVBytes = kBoxes * kKVBox;  // a K or V tile
  // two (Q, dO) buffers and 3 (D = 128: 4 x 32 + 3 x 32 KB) or 6 stages
  static constexpr int kStages = D == 128 ? 3 : 6;
  // Q full, empty; Delta full; K, V; empty
  static constexpr int kBars = 6 + 3 * kStages;
  static constexpr int kSmem = sm90::kAlign + 4 * kQBytes +
                               2 * kStages * kKVBytes + 2 * kQRows * 4 +
                               8 * kBars;
  static_assert(kSmem <= sm90::kMaxSmem, "shared memory");
};

// sum of the products of two rows of 8 bf16, in f32
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]), fy = __bfloat1622float2(y[i]);
    s = fmaf(fx.x, fy.x, s);
    s = fmaf(fx.y, fy.y, s);
  }
  return s;
}

// q/dout/out/dq [B, S, Hq, D] (q, dout as maps; dout and out also as
// pointers for Delta), k/v [B, S, Hkv, D] (maps), lse and delta [B, Hq, S]
// f32; `out` null: read delta, else compute and write it. A persistent
// grid: block b takes work items b, b + gridDim.x, ...; item w is query
// tile n_q - 1 - w / (B * Hq) of (batch, head) w % (B * Hq).
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dq_sm90(const __grid_constant__ CUtensorMap tmQ,
              const __grid_constant__ CUtensorMap tmDO,
              const __grid_constant__ CUtensorMap tmK,
              const __grid_constant__ CUtensorMap tmV,
              const bf16* __restrict__ dout, const bf16* __restrict__ out,
              const float* __restrict__ lse, float* __restrict__ delta,
              bf16* __restrict__ dq, int B, int S, int Hq, int Hkv, int causal,
              float scale) {
  using namespace ptt::sm90;
  using F = Dq<D>;
  extern __shared__ unsigned char dyn[];
  unsigned char* base = dyn + ((kAlign - (smem_u32(dyn) & (kAlign - 1))) &
                               (kAlign - 1));
  auto qst = [&](int i) { return base + i * 2 * F::kQBytes; };  // Q, dO
  auto kst = [&](int s) {
    return base + 4 * F::kQBytes + s * 2 * F::kKVBytes;
  };
  auto vst = [&](int s) { return kst(s) + F::kKVBytes; };
  // the items' Delta rows, two buffers as Q's
  float* dlt = reinterpret_cast<float*>(base + 4 * F::kQBytes +
                                        2 * F::kStages * F::kKVBytes);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(dlt + 2 * kQRows);
  uint64_t* q_empty = q_full + 2;
  uint64_t* d_full = q_empty + 2;
  uint64_t* full_k = d_full + 2;
  uint64_t* full_v = full_k + F::kStages;
  uint64_t* empty = full_v + F::kStages;
  const int tid = threadIdx.x;
  const int G = Hq / Hkv, n_q = (S + kQRows - 1) / kQRows;
  const int items = B * Hq * n_q;
  // work item w: (batch, head, first query row, K/V tiles it reads)
  auto item = [&](int w, int& b, int& head, int& m0, int& n_tiles) {
    const int bh = w % (B * Hq);
    b = bh / Hq;
    head = bh % Hq;
    m0 = (n_q - 1 - w / (B * Hq)) * kQRows;
    // causal: tiles starting past the item's last row are fully masked
    const int n_end = causal ? min(S, m0 + kQRows) : S;
    n_tiles = (n_end + kKVRows - 1) / kKVRows;
  };
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 8);   // one arrival a consumer warp
      mbar_init(&d_full[i], 32);   // every lane of the Delta warp
    }
    for (int s = 0; s < F::kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 288) {
    // ---------------- Delta: one item ahead of the consumers ----------------
    // Each lane takes rows lane + 32i of the item: Delta = rowsum(O * dO)
    // from O and dO in f32 (written out too), or the given Delta, into
    // the item's buffer once the item two back has left it.
    const int lane = tid & 31;
    for (int w = blockIdx.x, nth = 0; w < items; w += gridDim.x, ++nth) {
      int b, head, m0, n_tiles;
      item(w, b, head, m0, n_tiles);
      const int qb = nth & 1;
      mbar_wait(&q_empty[qb], ((nth >> 1) & 1) ^ 1);
      for (int r = lane; r < kQRows; r += 32) {
        const int row = m0 + r;
        float v = 0.f;
        if (row < S) {
          const int64_t stat = (int64_t(b) * Hq + head) * S + row;
          if (out != nullptr) {
            const int64_t off = ((int64_t(b) * S + row) * Hq + head) * D;
            const uint4* po = reinterpret_cast<const uint4*>(out + off);
            const uint4* pd = reinterpret_cast<const uint4*>(dout + off);
#pragma unroll
            for (int c = 0; c < D / 8; ++c) v += dot8(po[c], pd[c]);
            delta[stat] = v;
          } else {
            v = delta[stat];
          }
        }
        dlt[qb * kQRows + r] = v;
      }
      mbar_arrive(&d_full[qb]);
    }
    return;
  }
  if (tid >= 256) {
    // ---------------- producer: one thread issues every load ----------------
    if (tid != 256) return;
    int s = 0;
    uint32_t ph = 0;
    for (int w = blockIdx.x, nth = 0; w < items; w += gridDim.x, ++nth) {
      int b, head, m0, n_tiles;
      item(w, b, head, m0, n_tiles);
      const int hk = head / G, qb = nth & 1;
      mbar_wait(&q_empty[qb], ((nth >> 1) & 1) ^ 1);
      mbar_arrive_tx(&q_full[qb], 2 * F::kQBytes);
      for (int j = 0; j < F::kBoxes; ++j) {
        tma_load_4d(qst(qb) + j * (kQRows * 128), &tmQ, &q_full[qb], 64 * j,
                    head, m0, b);
        tma_load_4d(qst(qb) + F::kQBytes + j * (kQRows * 128), &tmDO,
                    &q_full[qb], 64 * j, head, m0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int n0 = it * kKVRows;
        mbar_wait(&empty[s], ph ^ 1);
        mbar_arrive_tx(&full_k[s], F::kKVBytes);
        for (int j = 0; j < F::kBoxes; ++j)
          tma_load_4d(kst(s) + j * F::kKVBox, &tmK, &full_k[s], 64 * j, hk,
                      n0, b);
        mbar_arrive_tx(&full_v[s], F::kKVBytes);
        for (int j = 0; j < F::kBoxes; ++j)
          tma_load_4d(vst(s) + j * F::kKVBox, &tmV, &full_v[s], 64 * j, hk,
                      n0, b);
        if (++s == F::kStages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  const int wgi = tid / 128, lt = tid & 127;
  const int warp = lt >> 5, lane = tid & 31, q = lane & 3;
  const float sl2 = scale * kLog2e;
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
    const uint32_t da = qa + F::kQBytes;
    // this thread's rows: r0 (accumulator entries 4j, 4j + 1) and r0 + 8
    // (4j + 2, 4j + 3); columns 8j + 2q + {0, 1} of chunk j
    const int diag = m0 + wgi * 64;    // the warpgroup's first row
    const int r0 = diag + warp * 16 + (lane >> 2);
    float lse2[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      lse2[h] = row < S ? lse[(int64_t(b) * Hq + head) * S + row] * kLog2e
                        : 0.f;
    }
    mbar_wait(&d_full[qb], (nth >> 1) & 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) dl[h] = dlt[qb * kQRows + r0 + 8 * h - m0];
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(&q_full[qb], (nth >> 1) & 1);
    for (int it = 0; it < n_tiles; ++it) {
      const int n0 = it * kKVRows;
      mbar_wait(&full_k[s], ph);
      mbar_wait(&full_v[s], ph);
      // causal: a tile wholly above this warpgroup's rows adds nothing
      if (!causal || n0 <= diag + 63) {
        const uint32_t kb = smem_u32(kst(s)), vb = smem_u32(vst(s));
        float sc[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
        fence_acc(sc);
        fence_acc(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_n64<0, 0>(
              sc,
              desc(qa + (kk >> 2) * (kQRows * 128) + (kk & 3) * 32, 16, 1024),
              desc(kb + (kk >> 2) * F::kKVBox + (kk & 3) * 32, 16, 1024));
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_n64<0, 0>(
              dp,
              desc(da + (kk >> 2) * (kQRows * 128) + (kk & 3) * 32, 16, 1024),
              desc(vb + (kk >> 2) * F::kKVBox + (kk & 3) * 32, 16, 1024));
        wgmma_commit();
        fence_acc(sc);
        wgmma_wait<1>();   // S landed; dP still in flight
        fence_acc(sc);

        // P = 2^(s * scale * log2(e) - lse * log2(e)), masked across the
        // diagonal and past S
        const bool edge =
            (causal && n0 + kKVRows - 1 > diag) || n0 + kKVRows > S;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = fast_exp2(fmaf(sc[4 * j + e], sl2, -lse2[e >> 1]));
            if (edge) {
              const int col = n0 + 8 * j + 2 * q + (e & 1);
              const int row = r0 + 8 * (e >> 1);
              if (col >= S || (causal && col > row)) p = 0.f;
            }
            sc[4 * j + e] = p;
          }
        fence_acc(dp);
        wgmma_wait<0>();
        fence_acc(dp);

        // dS = P (dP - Delta) scale, rounded to bf16 as the A fragments of
        // dS K: chunks 2i, 2i + 1 are reduction step i
        uint32_t dsa[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[e] = sc[4 * j + e] * (dp[4 * j + e] - dl[e >> 1]) * scale;
          dsa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
          dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }

        // dQ += dS K, K N-major
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKVRows / 16; ++kk)
          wgmma_ra<D, 1>(acc, dsa[kk], desc(kb + kk * 2048, F::kKVBox, 1024));
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<0>();
        fence_acc(acc);
      }
      arrive(&empty[s]);   // K and V of stage s read
      if (++s == F::kStages) {
        s = 0;
        ph ^= 1;
      }
    }
    arrive(&q_empty[qb]);   // Q and dO read: the buffer is free

    // dQ in bf16, 16 bytes a lane after a quad transpose
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      bf16* drow = dq + ((int64_t(b) * S + row) * Hq + head) * D;
#pragma unroll
      for (int m = 0; m < D / 32; ++m) {
        uint32_t v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = pack_bf16(acc[4 * (4 * m + i) + 2 * h],
                           acc[4 * (4 * m + i) + 2 * h + 1]);
        transpose4<1>(v, q);
        if (row < S)
          *reinterpret_cast<uint4*>(drow + 8 * (4 * m + q)) =
              make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;  // 16 x 16: thread (ty, tx) owns rows ty+16i, cols tx+16j

template <int D>
constexpr int smem_floats() {
  return 4 * 64 * (D + 1) + kBM * (kBN + 1);   // Q, dO, K, V; dS
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ out,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    float* __restrict__ dq, int S, int Hq, int Hkv,
                    int causal, float scale) {
  constexpr int P = D + 1;             // padded row: conflict-free column reads
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kBM][P]
  float* dOs = Qs + kBM * P;           // [kBM][P]
  float* Ks = dOs + kBM * P;           // [kBN][P]
  float* Vs = Ks + kBN * P;            // [kBN][P]
  float* dSs = Vs + kBN * P;           // [kBM][kBN + 1]

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int m0 = blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  const int64_t q_step = int64_t(Hq) * D;
  const int64_t kv_step = int64_t(Hkv) * D;
  const int64_t q_off = (int64_t(b) * S * Hq + h) * D;
  const float* kb = k + (int64_t(b) * S * Hkv + hk) * D;
  const float* vb = v + (int64_t(b) * S * Hkv + hk) * D;

  for (int e = tid; e < kBM * D; e += kThreads) {
    const int r = e / D, d = e % D, s = m0 + r;
    const bool live = s < S;
    Qs[r * P + d] = live ? q[q_off + s * q_step + d] : 0.f;
    dOs[r * P + d] = live ? dout[q_off + s * q_step + d] : 0.f;
  }

  // Delta = rowsum(O * dO): computed here and written out when `out` is
  // given (a row's 16 lanes sum its columns tx + 16c), else read
  const int64_t stat = (int64_t(b) * Hq + h) * S;
  float lse_r[4], del_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    lse_r[i] = row < S ? lse[stat + row] : 0.f;
    if (out != nullptr) {
      float sum = 0.f;
      if (row < S)
        for (int d = tx; d < D; d += 16)
          sum = fmaf(out[q_off + row * q_step + d],
                     dout[q_off + row * q_step + d], sum);
      del_r[i] = group_sum<16>(sum);
      if (tx == 0 && row < S) delta[stat + row] = del_r[i];
    } else {
      del_r[i] = row < S ? delta[stat + row] : 0.f;
    }
  }

  constexpr int DC = D / 16;   // dQ columns per thread
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const int n_end = causal ? min(S, m0 + kBM) : S;
  for (int n0 = 0; n0 < n_end; n0 += kBN) {
    __syncthreads();   // the previous tile's readers are done
    for (int e = tid; e < kBN * D; e += kThreads) {
      const int r = e / D, d = e % D, s = n0 + r;
      const bool live = s < S;
      Ks[r * P + d] = live ? kb[s * kv_step + d] : 0.f;
      Vs[r * P + d] = live ? vb[s * kv_step + d] : 0.f;
    }
    __syncthreads();

    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * P + d];
        dov[i] = dOs[(ty + 16 * i) * P + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * P + d];
        vv[j] = Vs[(tx + 16 * j) * P + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx + 16 * j;
        const bool live = col < S && (!causal || col <= row);
        const float p = live ? expf(sc[i][j] * scale - lse_r[i]) : 0.f;
        dSs[(ty + 16 * i) * (kBN + 1) + tx + 16 * j] =
            p * (dp[i][j] - del_r[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBN; ++c) {
      float dsv[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty + 16 * i) * (kBN + 1) + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) kv[cc] = Ks[c * P + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < DC; ++cc)
          acc[i][cc] = fmaf(dsv[i], kv[cc], acc[i][cc]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= S) continue;
    float* drow = dq + q_off + row * q_step;
#pragma unroll
    for (int c = 0; c < DC; ++c) drow[tx + 16 * c] = acc[i][c];
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* dout, const void* out, const float* lse,
                        float* delta, void* dq, int B, int S, int Hq, int Hkv,
                        int causal, float scale, cudaStream_t stream) {
  using F = Dq<D>;
  alignas(64) CUtensorMap tmQ{}, tmDO{}, tmK{}, tmV{};
  const cuuint32_t qbox[4] = {64, 1, kQRows, 1};
  const cuuint32_t kbox[4] = {64, 1, kKVRows, 1};
  const cuuint64_t qdims[4] = {D, cuuint64_t(Hq), cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t qstr[3] = {2ull * D, 2ull * D * Hq, 2ull * D * Hq * S};
  const cuuint64_t kdims[4] = {D, cuuint64_t(Hkv), cuuint64_t(S),
                               cuuint64_t(B)};
  const cuuint64_t kstr[3] = {2ull * D, 2ull * D * Hkv, 2ull * D * Hkv * S};
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  cudaError_t err = sm90::encode(&tmQ, bf, 4, q, qdims, qstr, qbox, sw);
  if (err == cudaSuccess)
    err = sm90::encode(&tmDO, bf, 4, dout, qdims, qstr, qbox, sw);
  if (err == cudaSuccess)
    err = sm90::encode(&tmK, bf, 4, k, kdims, kstr, kbox, sw);
  if (err == cudaSuccess)
    err = sm90::encode(&tmV, bf, 4, v, kdims, kstr, kbox, sw);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_dq_sm90<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             F::kSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_q = (S + kQRows - 1) / kQRows;
  const int grid = std::min(B * Hq * n_q, sms);
  flash_dq_sm90<D><<<grid, kWgThreads, F::kSmem, stream>>>(
      tmQ, tmDO, tmK, tmV, static_cast<const bf16*>(dout),
      static_cast<const bf16*>(out), lse, delta, static_cast<bf16*>(dq), B,
      S, Hq, Hkv, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* dout, const void* out, const float* lse,
                       float* delta, void* dq, int B, int S, int Hq, int Hkv,
                       int causal, float scale, cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBM - 1) / kBM, B * Hq);
  flash_dq_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(out), lse, delta, static_cast<float*>(dq), S,
      Hq, Hkv, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. D must be 64 or 128 (the wrapper checks).
// `out` null: delta is read; else Delta = rowsum(out * dout) is computed
// and written to delta.
extern "C" int ptt_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* out,
                            const float* lse, float* delta, void* dq, int B,
                            int S, int Hq, int Hkv, int D, int dtype,
                            int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && D == 128)
    return launch_f32<128>(q, k, v, dout, out, lse, delta, dq, B, S, Hq, Hkv,
                           causal, scale, st);
  if (dtype == kF32 && D == 64)
    return launch_f32<64>(q, k, v, dout, out, lse, delta, dq, B, S, Hq, Hkv,
                          causal, scale, st);
  if (dtype == kBF16 && D == 128)
    return launch_bf16<128>(q, k, v, dout, out, lse, delta, dq, B, S, Hq,
                            Hkv, causal, scale, st);
  if (dtype == kBF16 && D == 64)
    return launch_bf16<64>(q, k, v, dout, out, lse, delta, dq, B, S, Hq, Hkv,
                           causal, scale, st);
  return cudaErrorInvalidValue;
}
