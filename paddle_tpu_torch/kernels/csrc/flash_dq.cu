// FlashAttention-2 backward, dQ, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/kernels/pallas_attention.py
// `_dq_kernel` (launched by `_bwd`, the backward of the `_flash`
// custom_vjp).
//
// What bounds it on the H100: tensor-core FLOPs. Each (query, key) pair
// takes three D-long products (S = Q K^T, dP = dO V^T, dQ += dS K), so the
// floor is 3*B*Hq*S^2*D FLOPs when causal (twice that when not) over
// 989 TFLOP/s; at training widths (S = 2048, D = 128) that is far above
// the bytes of Q, K, V, dO, LSE and Delta over 3.35 TB/s.
//
// One thread block per (batch*head, 64-row query tile) walks the K/V
// tiles up to the causal diagonal (the ragged tail past S is masked here,
// so any S works) with query head h reading kv head h / (Hq/Hkv). For each
// tile it recomputes P = exp(S*scale - LSE) from the forward's f32 LSE,
// dP = dO V^T, and dS = P*(dP - Delta)*scale with Delta = rowsum(O*dO)
// from the wrapper, rounds dS to K's dtype where the TPU kernel rounds it,
// and accumulates dQ += dS K in f32. dQ is written once, in q's dtype.
//
// - bf16 (the training path): four warps, each owning 16 query rows, run
//   the three products on the tensor cores with mma.sync m16n8k16 (bf16 in,
//   f32 accumulate). The Q and dO tiles sit in shared memory (rows padded
//   by 16 bytes: conflict-free fragment reads), K/V tiles arrive by 16-byte
//   cp.async copies, double-buffered; dS becomes the A fragments of dS K in
//   registers and K's B fragments come from ldmatrix.trans.
// - f32 (CPU-parity checks): the products run on CUDA cores in full f32.
//
// A later PR should hold Q and dO in registers, move the products onto
// wgmma with TMA-fed K/V tiles, and fold the Delta reduction in here.
#include <cstdint>

#include "common.cuh"

namespace {

using namespace ptt;

constexpr int kBM = 64;   // query rows per block
constexpr int kBN = 64;   // kv rows per tile

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int kMmaThreads = 128;   // 4 warps x 16 query rows

template <int D>
struct MmaLayout {
  static constexpr int kStride = D + 8;      // bf16 a row: +16 B, no conflicts
  static constexpr int kTile = 64 * kStride;
  // Q, dO, then 2 stages x (K, V); bytes
  static constexpr int kSmem = 6 * kTile * 2;
};

// q/dout/dq [B, S, Hq, D], k/v [B, S, Hkv, D] (all contiguous), lse and
// delta [B, Hq, S] f32.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq, int S, int Hq, int Hkv,
                     int causal, float scale) {
  using Lay = MmaLayout<D>;
  constexpr int KS = D / 16;     // k-steps of Q K^T and dO V^T
  constexpr int NT = kBN / 8;    // 8-key n-tiles of the scores
  constexpr int PS = kBN / 16;   // k-steps of dS K
  constexpr int DT = D / 8;      // 8-column n-tiles of dQ
  constexpr int kVecs = D / 8;   // 16-byte copies a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + Lay::kTile;
  __nv_bfloat16* kvs = dos + Lay::kTile;   // stage s: K, then V

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int m0 = blockIdx.x * kBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;   // fragment row, column pair
  const int wr = warp * 16;                  // the warp's first tile row
  const int r0 = m0 + wr + g, r1 = r0 + 8;   // this thread's rows

  const int64_t q_step = int64_t(Hq) * D;    // elements between positions
  const int64_t kv_step = int64_t(Hkv) * D;
  const int64_t q_off = (int64_t(b) * S * Hq + h) * D;
  const __nv_bfloat16* kb = k + (int64_t(b) * S * Hkv + hk) * D;
  const __nv_bfloat16* vb = v + (int64_t(b) * S * Hkv + hk) * D;

  // the query tile's Q and dO rows (zero past S) join the first K/V group
#pragma unroll
  for (int e = tid; e < kBM * kVecs; e += kMmaThreads) {
    const int r = e / kVecs, c = (e % kVecs) * 8;
    const bool live = m0 + r < S;
    const int64_t off = live ? q_off + (m0 + r) * q_step + c : 0;
    cp_async16(qs + r * Lay::kStride + c, q + off, live);
    cp_async16(dos + r * Lay::kStride + c, dout + off, live);
  }

  // copies of kv rows [n0, n0 + 64) into stage `buf`; rows past S are zero
  auto stage = [&](int n0, int buf) {
    __nv_bfloat16* ks = kvs + 2 * buf * Lay::kTile;
    __nv_bfloat16* vs = ks + Lay::kTile;
#pragma unroll
    for (int e = tid; e < kBN * kVecs; e += kMmaThreads) {
      const int r = e / kVecs, c = (e % kVecs) * 8;
      const bool live = n0 + r < S;
      const int64_t off = live ? (n0 + r) * kv_step + c : 0;
      cp_async16(ks + r * Lay::kStride + c, kb + off, live);
      cp_async16(vs + r * Lay::kStride + c, vb + off, live);
    }
    cp_async_commit();
  };

  // causal: tiles starting past the block's last row are fully masked
  const int n_end = causal ? min(S, m0 + kBM) : S;
  const int n_tiles = (n_end + kBN - 1) / kBN;
  stage(0, 0);

  const int64_t stat = (int64_t(b) * Hq + h) * S;
  const float lse_r[2] = {r0 < S ? lse[stat + r0] : 0.f,
                          r1 < S ? lse[stat + r1] : 0.f};
  const float del_r[2] = {r0 < S ? delta[stat + r0] : 0.f,
                          r1 < S ? delta[stat + r1] : 0.f};

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[dt][j] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int n0 = it * kBN;
    if (it + 1 < n_tiles) {
      stage(n0 + kBN, (it + 1) & 1);
      cp_async_wait<1>();      // tile it landed; the next is in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();           // tile it visible to every warp
    const __nv_bfloat16* ks = kvs + 2 * (it & 1) * Lay::kTile;
    const __nv_bfloat16* vs = ks + Lay::kTile;

    // scores and dP of this warp's 16 rows against the tile's 64 keys
    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[nt][j] = dp[nt][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], da[4];
      load_a_frag(qa, qs, Lay::kStride, wr, kk * 16, g, tig);
      load_a_frag(da, dos, Lay::kStride, wr, kk * 16, g, tig);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int off = (nt * 8 + g) * Lay::kStride + kk * 16 + tig * 2;
        mma_bf16(sc[nt], qa, ld_u32(ks + off), ld_u32(ks + off + 8));
        mma_bf16(dp[nt], da, ld_u32(vs + off), ld_u32(vs + off + 8));
      }
    }

    // dS = P (dP - Delta) scale, rounded to bf16 as the A fragments of dS K
    uint32_t dsa[PS][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + nt * 8 + tig * 2 + (j & 1);
        const int row = j < 2 ? r0 : r1;
        const bool live = col < S && (!causal || col <= row);
        const float p = live ? expf(sc[nt][j] * scale - lse_r[j >> 1]) : 0.f;
        ds[j] = p * (dp[nt][j] - del_r[j >> 1]) * scale;
      }
      dsa[nt >> 1][(nt & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < PS; ++kk)
      mma_rows_times_tile<DT>(acc, dsa[kk], ks, Lay::kStride, kk * 16, lane);
    __syncthreads();           // stage it&1 is free for tile it+2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? r1 : r0;
    if (row >= S) continue;
    __nv_bfloat16* drow = dq + q_off + row * q_step;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(drow + dt * 8 + tig * 2) =
          __floats2bfloat162_rn(acc[dt][2 * i], acc[dt][2 * i + 1]);
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
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int S, int Hq, int Hkv, int causal, float scale) {
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

  const int64_t stat = (int64_t(b) * Hq + h) * S;
  float lse_r[4], del_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    lse_r[i] = row < S ? lse[stat + row] : 0.f;
    del_r[i] = row < S ? delta[stat + row] : 0.f;
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
                        const void* dout, const float* lse, const float* delta,
                        void* dq, int B, int S, int Hq, int Hkv, int causal,
                        float scale, cudaStream_t stream) {
  constexpr int smem = MmaLayout<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBM - 1) / kBM, B * Hq);
  flash_dq_bf16_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dq), S, Hq, Hkv, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dq, int B, int S, int Hq, int Hkv, int causal,
                       float scale, cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBM - 1) / kBM, B * Hq);
  flash_dq_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), S, Hq, Hkv, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. D must be 64 or 128 (the wrapper checks).
extern "C" int ptt_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int B, int S, int Hq,
                            int Hkv, int D, int dtype, int causal, float scale,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && D == 128)
    return launch_f32<128>(q, k, v, dout, lse, delta, dq, B, S, Hq, Hkv,
                           causal, scale, st);
  if (dtype == kF32 && D == 64)
    return launch_f32<64>(q, k, v, dout, lse, delta, dq, B, S, Hq, Hkv,
                          causal, scale, st);
  if (dtype == kBF16 && D == 128)
    return launch_bf16<128>(q, k, v, dout, lse, delta, dq, B, S, Hq, Hkv,
                            causal, scale, st);
  if (dtype == kBF16 && D == 64)
    return launch_bf16<64>(q, k, v, dout, lse, delta, dq, B, S, Hq, Hkv,
                           causal, scale, st);
  return cudaErrorInvalidValue;
}
