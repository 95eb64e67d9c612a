// FlashAttention-2 backward, dK and dV, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/kernels/pallas_attention.py
// `_dkv_kernel` (launched by `_bwd`, the backward of the `_flash`
// custom_vjp).
//
// What bounds it on the H100: tensor-core FLOPs. Each (query, key) pair
// takes four D-long products (S^T = K Q^T, dP^T = V dO^T, dV += P^T dO,
// dK += dS^T Q), so the floor is 4*B*Hq*S^2*D FLOPs when causal (twice
// that when not) over 989 TFLOP/s, far above the bytes moved at training
// widths.
//
// One thread block per (batch*kv head, 64-row kv tile). Inside, it loops
// over the G = Hq/Hkv query heads of the group (query head h reads kv head
// h / G) and, for each, over the query tiles from the causal diagonal down
// to S (the ragged tail is masked here), just as the TPU kernel's grid
// (kv tile, group head, query tile) does. It recomputes P^T and
// dS^T = P^T (dP^T - Delta) scale from the forward's f32 LSE and the
// wrapper's Delta = rowsum(O*dO), and accumulates in f32
// dV += round(P)^T dO and dK += round(dS)^T Q with the TPU kernel's
// roundings (P to dO's dtype, dS to Q's). dK and dV are written once, at
// Hkv heads: no atomics, so the result is deterministic and the same for
// any G.
//
// - bf16 (the training path): four warps, each owning 16 kv rows, run the
//   four products with mma.sync m16n8k16 (bf16 in, f32 accumulate). K and
//   V stay in shared memory for the whole block; 32-row Q and dO tiles
//   (with their LSE and Delta) arrive by cp.async, double-buffered. P^T and
//   dS^T become A fragments in registers; Q's and dO's B fragments come
//   from ldmatrix.trans. A 32-row query tile keeps the f32 accumulators
//   (dK and dV: 2*D/2 registers a thread) and the scores in registers.
// - f32 (CPU-parity checks): the products run on CUDA cores in full f32.
//
// A later PR should move the products onto wgmma with TMA-fed Q/dO tiles
// in a deeper ring, and split the query range of long sequences over more
// blocks (132 SMs want more than B*Hkv*S/64 blocks at short S).
#include <cstdint>

#include "common.cuh"

namespace {

using namespace ptt;

constexpr int kBN = 64;   // kv rows per block

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int kMmaThreads = 128;   // 4 warps x 16 kv rows
constexpr int kBQ = 32;            // query rows per tile

template <int D>
struct MmaLayout {
  static constexpr int kStride = D + 8;      // bf16 a row: +16 B, no conflicts
  static constexpr int kKV = kBN * kStride;  // the K or V tile
  static constexpr int kQT = kBQ * kStride;  // one Q or dO tile
  // K, V, 2 stages x (Q, dO) in bf16, then 2 stages x (LSE, Delta) in f32
  static constexpr int kStatsOffset = (2 * kKV + 4 * kQT) * 2;   // bytes
  static constexpr int kSmem = kStatsOffset + 4 * kBQ * 4;
};

// q/dout [B, S, Hq, D], k/v/dk/dv [B, S, Hkv, D] (all contiguous), lse and
// delta [B, Hq, S] f32.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int S, int Hq, int Hkv,
                      int causal, float scale) {
  using Lay = MmaLayout<D>;
  constexpr int KS = D / 16;     // k-steps of K Q^T and V dO^T
  constexpr int NT = kBQ / 8;    // 8-query n-tiles of the scores
  constexpr int PS = kBQ / 16;   // k-steps of P^T dO and dS^T Q
  constexpr int DT = D / 8;      // 8-column n-tiles of dK and dV
  constexpr int kVecs = D / 8;   // 16-byte copies a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + Lay::kKV;
  __nv_bfloat16* qts = vs + Lay::kKV;      // stage s: Q, then dO
  float* stats = reinterpret_cast<float*>(smem_raw + Lay::kStatsOffset);
  // stage s: LSE at stats + 2*s*kBQ, Delta after it

  const int bh = blockIdx.y;
  const int b = bh / Hkv, hk = bh % Hkv;
  const int G = Hq / Hkv;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;   // fragment row, column pair
  const int wr = warp * 16;                  // the warp's first kv row
  const int k0 = n0 + wr + g, k1 = k0 + 8;   // this thread's kv rows

  const int64_t q_step = int64_t(Hq) * D;    // elements between positions
  const int64_t kv_step = int64_t(Hkv) * D;
  const int64_t kv_off = (int64_t(b) * S * Hkv + hk) * D;

  // K and V rows [n0, n0 + 64) (zero past S) join the first Q/dO group
#pragma unroll
  for (int e = tid; e < kBN * kVecs; e += kMmaThreads) {
    const int r = e / kVecs, c = (e % kVecs) * 8;
    const bool live = n0 + r < S;
    const int64_t off = live ? kv_off + (n0 + r) * kv_step + c : 0;
    cp_async16(ks + r * Lay::kStride + c, k + off, live);
    cp_async16(vs + r * Lay::kStride + c, v + off, live);
  }

  // causal: query tiles ending before the block's first kv row are fully
  // masked (kBN is a multiple of kBQ, so the first live tile starts at n0)
  const int m_start = causal ? n0 : 0;
  const int nq = (S - m_start + kBQ - 1) / kBQ;   // query tiles per head
  const int n_iters = G * nq;

  // copies of query tile t (group head t / nq) into stage `buf`
  auto stage = [&](int t, int buf) {
    const int hq = hk * G + t / nq;
    const int m0 = m_start + (t % nq) * kBQ;
    const int64_t q_off = (int64_t(b) * S * Hq + hq) * D;
    __nv_bfloat16* qt = qts + 2 * buf * Lay::kQT;
    __nv_bfloat16* dot = qt + Lay::kQT;
#pragma unroll
    for (int e = tid; e < kBQ * kVecs; e += kMmaThreads) {
      const int r = e / kVecs, c = (e % kVecs) * 8;
      const bool live = m0 + r < S;
      const int64_t off = live ? q_off + (m0 + r) * q_step + c : 0;
      cp_async16(qt + r * Lay::kStride + c, q + off, live);
      cp_async16(dot + r * Lay::kStride + c, dout + off, live);
    }
    cp_async_commit();
    // LSE and Delta by plain loads: visible after the barrier that follows
    // the wait for this stage
    if (tid < 2 * kBQ) {
      const int r = tid % kBQ;
      const float* src = tid < kBQ ? lse : delta;
      stats[2 * buf * kBQ + tid] =
          m0 + r < S ? src[(int64_t(b) * Hq + hq) * S + m0 + r] : 0.f;
    }
  };

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[dt][j] = dva[dt][j] = 0.f;

  stage(0, 0);
  for (int it = 0; it < n_iters; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_iters) {
      stage(it + 1, buf ^ 1);
      cp_async_wait<1>();      // tile it landed; the next is in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();           // tile it visible to every warp
    const int m0 = m_start + (it % nq) * kBQ;
    const __nv_bfloat16* qt = qts + 2 * buf * Lay::kQT;
    const __nv_bfloat16* dot = qt + Lay::kQT;
    const float* lse_s = stats + 2 * buf * kBQ;
    const float* del_s = lse_s + kBQ;

    // S^T and dP^T of this warp's 16 kv rows against the tile's 32 queries
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[nt][j] = dpt[nt][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      load_a_frag(ka, ks, Lay::kStride, wr, kk * 16, g, tig);
      load_a_frag(va, vs, Lay::kStride, wr, kk * 16, g, tig);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int off = (nt * 8 + g) * Lay::kStride + kk * 16 + tig * 2;
        mma_bf16(st[nt], ka, ld_u32(qt + off), ld_u32(qt + off + 8));
        mma_bf16(dpt[nt], va, ld_u32(dot + off), ld_u32(dot + off + 8));
      }
    }

    // P^T and dS^T, rounded to bf16 as the A fragments of the next products
    uint32_t pa[PS][4], dsa[PS][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = nt * 8 + tig * 2 + (j & 1);
        const int qry = m0 + qc;
        const int key = j < 2 ? k0 : k1;
        const bool live = qry < S && key < S && (!causal || key <= qry);
        p[j] = live ? expf(st[nt][j] * scale - lse_s[qc]) : 0.f;
        ds[j] = p[j] * (dpt[nt][j] - del_s[qc]) * scale;
      }
      pa[nt >> 1][(nt & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      dsa[nt >> 1][(nt & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < PS; ++kk) {
      mma_rows_times_tile<DT>(dva, pa[kk], dot, Lay::kStride, kk * 16, lane);
      mma_rows_times_tile<DT>(dka, dsa[kk], qt, Lay::kStride, kk * 16, lane);
    }
    __syncthreads();           // stage buf is free for tile it+2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? k1 : k0;
    if (row >= S) continue;
    const int64_t off = kv_off + row * kv_step;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + dt * 8 + tig * 2) =
          __floats2bfloat162_rn(dka[dt][2 * i], dka[dt][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + dt * 8 + tig * 2) =
          __floats2bfloat162_rn(dva[dt][2 * i], dva[dt][2 * i + 1]);
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
  constexpr int smem = MmaLayout<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBN - 1) / kBN, B * Hkv);
  flash_dkv_bf16_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, Hq,
      Hkv, causal, scale);
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
