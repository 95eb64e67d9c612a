// FlashAttention-2 forward for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/kernels/pallas_attention.py
// `_fwd_kernel` (launched by `_fwd`, called through `flash_attention_fwd`).
//
// What bounds it on the H100: tensor-core FLOPs. At prefill widths
// (S in the hundreds to thousands, D = 128) attention does about S/2
// operations per byte of Q/K/V, far above the card's ~295 operations per
// byte, so the floor is 2*B*Hq*S^2*D causal FLOPs over 989 TFLOP/s.
//
// Both kernels here take one thread block per (batch*head, 64-row query
// tile) and loop over 64-row K/V tiles staged in shared memory, keeping
// the scores, the running max and sum, and the output accumulator in f32
// registers. Tiles above the causal diagonal are skipped, the ragged tail
// (S not a multiple of 64) is masked here, and query head h reads kv head
// h / (Hq/Hkv) (the repeat-interleave GQA convention of the JAX kernel).
// Probabilities are rounded to the input dtype before the PV product, as
// the TPU kernel does.
//
// - bf16 (the serving path): four warps, each owning 16 query rows, run
//   both products on the tensor cores with mma.sync m16n8k16 (bf16 in,
//   f32 accumulate). Q stays in registers as A fragments; K/V tiles
//   arrive by 16-byte cp.async copies, double-buffered, into rows padded
//   by 16 bytes (conflict-free fragment reads); the score accumulators
//   become the PV product's A fragments in registers, and V's B
//   fragments come from ldmatrix.trans.
// - f32 (CPU-parity checks): the products run on CUDA cores in full f32
//   (FMA), since the tensor cores would round the inputs to tf32.
//
// A later PR should move the bf16 products onto wgmma with TMA-fed K/V
// tiles in a deeper ring and warp-specialized producers and consumers
// (FlashAttention-3's shape).
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
  static constexpr int kStride = D + 8;   // bf16 a smem row: +16 B, no conflicts
  static constexpr int kTile = kBN * kStride;
  static constexpr int kSmem = 2 * 2 * kTile * 2;   // 2 stages x (K, V), bytes
};

// q [B, S, Hq, D], k/v [B, S, Hkv, D], o [B, S, Hq, D] (all contiguous),
// lse [B, Hq, S] f32.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int S, int Hq, int Hkv, int causal, float scale) {
  using Lay = MmaLayout<D>;
  constexpr int KS = D / 16;     // k-steps of Q K^T
  constexpr int NT = kBN / 8;    // 8-key n-tiles of the scores
  constexpr int PS = kBN / 16;   // k-steps of P V
  constexpr int DT = D / 8;      // 8-column n-tiles of the output
  constexpr int kVecs = D / 8;   // 16-byte copies a K/V row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int m0 = blockIdx.x * kBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;   // fragment row, column pair
  const int r0 = m0 + warp * 16 + g, r1 = r0 + 8;   // this thread's rows

  const int64_t q_step = int64_t(Hq) * D;    // elements between positions
  const int64_t kv_step = int64_t(Hkv) * D;
  const __nv_bfloat16* qb = q + (int64_t(b) * S * Hq + h) * D;
  const __nv_bfloat16* kb = k + (int64_t(b) * S * Hkv + hk) * D;
  const __nv_bfloat16* vb = v + (int64_t(b) * S * Hkv + hk) * D;

  // copies of kv rows [n0, n0 + 64) into stage `buf`; rows past S are zero
  auto stage = [&](int n0, int buf) {
    __nv_bfloat16* ks = smem + 2 * buf * Lay::kTile;
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

  // Q as A fragments: a0 (r0, c), a1 (r1, c), a2 (r0, c+8), a3 (r1, c+8)
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + tig * 2;
    qa[ks][0] = r0 < S ? ld_u32(qb + r0 * q_step + c) : 0u;
    qa[ks][1] = r1 < S ? ld_u32(qb + r1 * q_step + c) : 0u;
    qa[ks][2] = r0 < S ? ld_u32(qb + r0 * q_step + c + 8) : 0u;
    qa[ks][3] = r1 < S ? ld_u32(qb + r1 * q_step + c + 8) : 0u;
  }

  float oacc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int j = 0; j < 4; ++j) oacc[dt][j] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int n0 = it * kBN;
    if (it + 1 < n_tiles) {
      stage(n0 + kBN, (it + 1) & 1);
      cp_async_wait<1>();      // tile it landed; the next is in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();           // tile it visible to every warp
    const __nv_bfloat16* ks = smem + 2 * (it & 1) * Lay::kTile;
    const __nv_bfloat16* vs = ks + Lay::kTile;

    // scores of this warp's 16 rows against the tile's 64 keys; n-tile nt
    // holds (r0, keys nt*8 + 2*tig + {0,1}) in [0..1] and r1 in [2..3]
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[nt][j] = 0.f;
#pragma unroll
    for (int ks_ = 0; ks_ < KS; ++ks_)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kr = ks + (nt * 8 + g) * Lay::kStride
                                  + ks_ * 16 + tig * 2;
        mma_bf16(sc[nt], qa[ks_], ld_u32(kr), ld_u32(kr + 8));
      }

    // online softmax over the tile; a row's 64 keys live in its quad
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + nt * 8 + tig * 2 + (j & 1);
        const int row = j < 2 ? r0 : r1;
        const bool live = col < S && (!causal || col <= row);
        sc[nt][j] = live ? sc[nt][j] * scale : kNegInf;
        mx[j >> 1] = fmaxf(mx[j >> 1], sc[nt][j]);
      }
    float alpha[2], m_new[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = group_max<4>(mx[i]);
      m_new[i] = fmaxf(m_r[i], mx[i]);
      alpha[i] = expf(m_r[i] - m_new[i]);
    }
    // P as the A fragments of P V: key k-step kk takes n-tiles 2kk, 2kk+1
    uint32_t pa[PS][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p0 = expf(sc[nt][0] - m_new[0]);
      const float p1 = expf(sc[nt][1] - m_new[0]);
      const float p2 = expf(sc[nt][2] - m_new[1]);
      const float p3 = expf(sc[nt][3] - m_new[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pa[nt >> 1][(nt & 1) * 2] = pack_bf16(p0, p1);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_r[i] = l_r[i] * alpha[i] + group_sum<4>(rs[i]);
      m_r[i] = m_new[i];
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      oacc[dt][0] *= alpha[0];
      oacc[dt][1] *= alpha[0];
      oacc[dt][2] *= alpha[1];
      oacc[dt][3] *= alpha[1];
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < PS; ++kk)
      mma_rows_times_tile<DT>(oacc, pa[kk], vs, Lay::kStride, kk * 16, lane);
    __syncthreads();           // stage it&1 is free for tile it+2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? r1 : r0;
    if (row >= S) continue;
    const float inv = 1.f / l_r[i];
    __nv_bfloat16* orow = o + ((int64_t(b) * S + row) * Hq + h) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + tig * 2) =
          __floats2bfloat162_rn(oacc[dt][2 * i] * inv,
                                oacc[dt][2 * i + 1] * inv);
    if (tig == 0) lse[(int64_t(b) * Hq + h) * S + row] = m_r[i] + logf(l_r[i]);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
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
  constexpr int smem = MmaLayout<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBM - 1) / kBM, B * Hq);
  flash_fwd_bf16_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      S, Hq, Hkv, causal, scale);
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
