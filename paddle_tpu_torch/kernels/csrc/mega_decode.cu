// The persistent decode megakernel's C entry points (B5): the kernel is
// in mega_decode.cuh, its instantiations in mega_decode_<dtype>[_w8].cu
// (one step) and mega_decode_multi_<dtype>[_w8].cu (the multi-step form).
// The weights' tensor maps are encoded once per weight tree (keyed by the
// data pointers and shapes) and passed to every launch by value.
#include <algorithm>
#include <cstring>
#include <mutex>

#include "mega_decode.cuh"

using namespace ptt;
using namespace ptt::mega;

namespace {

CUtensorMapDataType map_type(int es) {
  return es == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
         : es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// [L, K, M] of es-byte elements, read in boxes of one 128-byte row of M
// by kRows rows of K (128-byte swizzle)
cudaError_t encode_mmajor(CUtensorMap* map, const void* p, int es, int L,
                          int K, int M) {
  const cuuint64_t dims[3] = {cuuint64_t(M), cuuint64_t(K), cuuint64_t(L)};
  const cuuint64_t strides[2] = {cuuint64_t(M) * es,
                                 cuuint64_t(K) * cuuint64_t(M) * es};
  const cuuint32_t box[3] = {cuuint32_t(128 / es), cuuint32_t(kRows), 1};
  return sm90::encode(map, map_type(es), 3, p, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
}

// embed [V, h] as the tied head: boxes of 64 vocabulary rows by 128
// bytes of h
cudaError_t encode_kmajor(CUtensorMap* map, const void* p, int es, int V,
                          int h) {
  const cuuint64_t dims[3] = {cuuint64_t(h), cuuint64_t(V), 1};
  const cuuint64_t strides[2] = {cuuint64_t(h) * es,
                                 cuuint64_t(V) * cuuint64_t(h) * es};
  const cuuint32_t box[3] = {cuuint32_t(128 / es), 64, 1};
  return sm90::encode(map, map_type(es), 3, p, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
}

// what the maps of one weight tree depend on
struct MapKey {
  const void* ptr[8];
  int dims[10];
};

struct MapEntry {
  MapKey key;
  Maps maps;
};

constexpr int kMapCache = 8;
std::mutex map_mutex;
MapEntry map_cache[kMapCache];
int map_used = 0, map_next = 0;

// the maps of a's weights (and, for `multi`, of its head): from the
// cache, or encoded and cached
cudaError_t weight_maps(const Args& a, int D, int dtype, int w_int8,
                        bool multi, Maps* out) {
  const int es_t = dtype == kF32 ? 4 : 2, es_w = w_int8 ? 1 : es_t;
  const int Mq = a.Hkv * a.G * D, Mkv = a.Hkv * D;
  const void* head = !multi ? nullptr
                     : a.head_mode == kHeadTied ? a.embed
                                                : a.head;
  MapKey key;
  std::memset(&key, 0, sizeof(key));
  const void* ptrs[8] = {a.wq, a.wk, a.wv, a.wo, a.w_gate, a.w_up, a.w_down,
                         head};
  const int dims[10] = {a.L, a.h, a.F, Mq, Mkv, multi ? a.V : 0, dtype,
                        w_int8, multi ? a.head_mode : -1, multi};
  std::memcpy(key.ptr, ptrs, sizeof(ptrs));
  std::memcpy(key.dims, dims, sizeof(dims));
  std::lock_guard<std::mutex> lock(map_mutex);
  for (int i = 0; i < map_used; ++i)
    if (std::memcmp(&map_cache[i].key, &key, sizeof(key)) == 0) {
      *out = map_cache[i].maps;
      return cudaSuccess;
    }
  Maps m;
  std::memset(&m, 0, sizeof(m));
  const int K[7] = {a.h, a.h, a.h, Mq, a.h, a.h, a.F};
  const int M[7] = {Mq, Mkv, Mkv, a.h, a.F, a.F, a.h};
  for (int i = 0; i < 7; ++i) {
    const cudaError_t err = encode_mmajor(&m.m[i], ptrs[i], es_w, a.L, K[i],
                                          M[i]);
    if (err != cudaSuccess) return err;
  }
  if (multi) {
    const cudaError_t err =
        a.head_mode == kHeadTied
            ? encode_kmajor(&m.m[7], a.embed, es_t, a.V, a.h)
            : encode_mmajor(&m.m[7], a.head,
                            a.head_mode == kHeadInt8 ? 1 : es_t, 1, a.h, a.V);
    if (err != cudaSuccess) return err;
  }
  map_cache[map_next].key = key;
  map_cache[map_next].maps = m;
  map_next = (map_next + 1) % kMapCache;
  if (map_used < kMapCache) ++map_used;
  *out = m;
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (x, the norms, the rings and dense weights and
// pools all of it); w_int8: the seven matrices are int8 [L, K, M] with
// bf16 [L, M] column scales s_wq .. s_w_down (else those are unused);
// kv_int8: the pools are int8 with f32 [L, NB, BS, Hkv] scale pools
// ks_pool/vs_pool (else unused). D 64 or 128; 1 <= N <= 8 rows;
// 1 <= G <= 8; h and F multiples of 32 (the wrapper checks; anything else
// returns cudaErrorInvalidValue). Every tensor is contiguous; x, the
// rings and the scratch are written. `part` holds 512 x 8 floats for
// each block of the grid (one an SM) and the walks' partials; `count`
// (the barrier, a flag a block, a flag a walk part: kWalkFlags +
// N * Hkv * 8 ints) is zero on entry.
extern "C" int ptt_mega_decode(
    const void* attn_norm, const void* mlp_norm, const void* wq,
    const void* wk, const void* wv, const void* wo, const void* w_gate,
    const void* w_up, const void* w_down, const void* s_wq,
    const void* s_wk, const void* s_wv, const void* s_wo,
    const void* s_w_gate, const void* s_w_up, const void* s_w_down,
    const float* freq, const int* table, const int* walk_lens,
    const int* lens, const void* k_pool, const void* v_pool,
    const float* ks_pool, const float* vs_pool, void* ring_k, void* ring_v,
    void* x, void* qkv, void* att, void* gu, float* part, int* count, int L,
    int N, int h, int F, int Hkv, int G, int D, int NB, int BS, int MB,
    int S, int t, int dtype, int w_int8, int kv_int8, float eps,
    float scale, void* stream) {
  if (G < 1 || G > walk::kMaxGroup || h % 32 || F % 32 || t < 0 || t >= S
      || h > 128 * kMaxTiles)
    return cudaErrorInvalidValue;
  if ((kv_int8 && (ks_pool == nullptr || vs_pool == nullptr))
      || (w_int8 && (!s_wq || !s_wk || !s_wv || !s_wo || !s_w_gate
                     || !s_w_up || !s_w_down)))
    return cudaErrorInvalidValue;
  const Args a{attn_norm, mlp_norm, wq, wk, wv, wo, w_gate, w_up, w_down,
               freq, table, walk_lens, lens, k_pool, v_pool, ks_pool,
               vs_pool, {s_wq, s_wk, s_wv, s_wo, s_w_gate, s_w_up, s_w_down},
               ring_k, ring_v, x, qkv, att, gu, part, count, L, N, h, F, Hkv,
               G, NB, BS, MB, S, t, eps, scale, kv_int8 != 0};
  if (dtype != kF32 && dtype != kBF16) return cudaErrorInvalidValue;
  Maps m;
  const cudaError_t err = weight_maps(a, D, dtype, w_int8, false, &m);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return w_int8 ? launch_f32_w8(a, m, D, N, st) : launch_f32(a, m, D, N, st);
  return w_int8 ? launch_bf16_w8(a, m, D, N, st) : launch_bf16(a, m, D, N, st);
}

// The multi-step form: n_steps greedy decode steps of every layer in one
// launch (ring rows t = 0 .. n_steps - 1, S >= n_steps), each ending in
// the final norm, the head's argmax and the rows' bookkeeping. The layer
// arguments are ptt_mega_decode's (t is 0 and unused); besides: the final
// norm [h], embed [V, h] (the model dtype: the next input rows and, with
// head_mode 1, the tied head), head [h, V] (head_mode 0: the model dtype;
// 2: int8 with bf16 [V] column scales head_scale; 1: unused), active and
// eos [N] (eos -1: none), state [4, N] int32 (last, lens, done, budget;
// lens is also the RoPE position, done zero on entry), emitted
// [n_steps, N] int32, and hmax/hidx scratch [hcap, N] for up to hcap
// blocks. V must be a multiple of 32 for a column head and h at most
// 4096 (the wrapper checks).
extern "C" int ptt_mega_decode_loop(
    const void* attn_norm, const void* mlp_norm, const void* wq,
    const void* wk, const void* wv, const void* wo, const void* w_gate,
    const void* w_up, const void* w_down, const void* s_wq,
    const void* s_wk, const void* s_wv, const void* s_wo,
    const void* s_w_gate, const void* s_w_up, const void* s_w_down,
    const float* freq, const int* table, const int* walk_lens,
    const void* k_pool, const void* v_pool, const float* ks_pool,
    const float* vs_pool, void* ring_k, void* ring_v, void* x, void* qkv,
    void* att, void* gu, float* part, int* count, const void* final_norm,
    const void* embed, const void* head, const void* head_scale,
    const int* active, const int* eos, int* state, int* emitted,
    float* hmax, int* hidx, int L, int N, int h, int F, int Hkv, int G,
    int D, int NB, int BS, int MB, int S, int n_steps, int V, int head_mode,
    int hcap, int dtype, int w_int8, int kv_int8, float eps, float scale,
    void* stream) {
  if (G < 1 || G > walk::kMaxGroup || h % 32 || F % 32 || n_steps < 1
      || n_steps > S || h > 4096 || V < 1 || head_mode < kHeadDense
      || head_mode > kHeadInt8
      || (head_mode != kHeadTied && (V % 32 || head == nullptr))
      || (head_mode == kHeadInt8 && head_scale == nullptr))
    return cudaErrorInvalidValue;
  if ((kv_int8 && (ks_pool == nullptr || vs_pool == nullptr))
      || (w_int8 && (!s_wq || !s_wk || !s_wv || !s_wo || !s_w_gate
                     || !s_w_up || !s_w_down)))
    return cudaErrorInvalidValue;
  Args a{attn_norm, mlp_norm, wq, wk, wv, wo, w_gate, w_up, w_down,
         freq, table, walk_lens, state + N, k_pool, v_pool, ks_pool,
         vs_pool, {s_wq, s_wk, s_wv, s_wo, s_w_gate, s_w_up, s_w_down},
         ring_k, ring_v, x, qkv, att, gu, part, count, L, N, h, F, Hkv,
         G, NB, BS, MB, S, 0, eps, scale, kv_int8 != 0};
  a.final_norm = final_norm;
  a.embed = embed;
  a.head = head;
  a.head_scale = head_scale;
  a.active = active;
  a.eos = eos;
  a.state = state;
  a.emitted = emitted;
  a.hmax = hmax;
  a.hidx = hidx;
  a.head_mode = head_mode;
  a.V = V;
  a.n_steps = n_steps;
  a.hcap = hcap;
  if (dtype != kF32 && dtype != kBF16) return cudaErrorInvalidValue;
  Maps m;
  const cudaError_t err = weight_maps(a, D, dtype, w_int8, true, &m);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return w_int8 ? launch_multi_f32_w8(a, m, D, N, st)
                  : launch_multi_f32(a, m, D, N, st);
  return w_int8 ? launch_multi_bf16_w8(a, m, D, N, st)
                : launch_multi_bf16(a, m, D, N, st);
}

// blocks of the kernel an SM holds at once for dtype, D and N rows with
// dense (w_int8 = 0) or int8 weights (the grid is this times the SM
// count), or minus a CUDA error code
extern "C" int ptt_mega_decode_blocks_per_sm(int dtype, int D, int N,
                                             int w_int8) {
  int per_sm = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kF32)
    err = w_int8 ? occupancy_f32_w8(D, N, &per_sm)
                 : occupancy_f32(D, N, &per_sm);
  else if (dtype == kBF16)
    err = w_int8 ? occupancy_bf16_w8(D, N, &per_sm)
                 : occupancy_bf16(D, N, &per_sm);
  return err == cudaSuccess ? per_sm : -int(err);
}

// The static schedule the kernel runs on a grid of n_blocks blocks, from
// the code its producer and consumers run (make_sched): for q/k/v, wo,
// gate/up, down and (head_mode >= 0, a HeadMode) the multi-step form's
// head, out[5 * 4] holds each phase's tiles, units a tile, units and the
// most units one block takes (zeros for a head with head_mode < 0).
// dtype and w_int8 as for ptt_mega_decode; returns 0 or
// cudaErrorInvalidValue.
extern "C" int ptt_mega_decode_schedule(int dtype, int w_int8, int h, int F,
                                        int Hkv, int G, int D, int V,
                                        int head_mode, int n_blocks,
                                        long long* out) {
  if ((dtype != kF32 && dtype != kBF16) || n_blocks < 1 || h < 1 || F < 1
      || Hkv < 1 || G < 1 || D < 1 || head_mode > kHeadInt8
      || (head_mode >= 0 && V < 1))
    return cudaErrorInvalidValue;
  Args a;
  std::memset(&a, 0, sizeof(a));
  a.h = h;
  a.F = F;
  a.Hkv = Hkv;
  a.G = G;
  a.V = V;
  a.head_mode = head_mode;
  const int kinds[5] = {kQkv, kWo, kGu, kDown, kHead};
  for (int i = 0; i < 5; ++i) {
    long long* o = out + 4 * i;
    o[0] = o[1] = o[2] = o[3] = 0;
    if (kinds[i] == kHead && head_mode < 0) continue;
    const Sched p =
        dtype == kF32 ? (w_int8 ? make_sched<float, int8_t>(kinds[i], a, D)
                                : make_sched<float, float>(kinds[i], a, D))
                      : (w_int8 ? make_sched<bf16, int8_t>(kinds[i], a, D)
                                : make_sched<bf16, bf16>(kinds[i], a, D));
    o[0] = p.ntiles;
    o[1] = p.upt;
    o[2] = p.U;
    for (int b = 0; b < n_blocks; ++b)
      o[3] = std::max(o[3], p.lo(b + 1, n_blocks) - p.lo(b, n_blocks));
  }
  return 0;
}
