// The persistent decode megakernel's C entry points (B5): the kernel is
// in mega_decode.cuh, its instantiations in mega_decode_<dtype>[_w8].cu
// (one step) and mega_decode_multi_<dtype>[_w8].cu (the multi-step form).
#include "mega_decode.cuh"

using namespace ptt;
using namespace ptt::mega;

// dtype: 0 = f32, 1 = bf16 (x, the norms, the rings and dense weights and
// pools all of it); w_int8: the seven matrices are int8 [L, K, M] with
// bf16 [L, M] column scales s_wq .. s_w_down (else those are unused);
// kv_int8: the pools are int8 with f32 [L, NB, BS, Hkv] scale pools
// ks_pool/vs_pool (else unused). D 64 or 128; 1 <= N <= 8 rows;
// 1 <= G <= 8; h and F multiples of 32 (the wrapper checks; anything else
// returns cudaErrorInvalidValue). Every tensor is contiguous; x, the
// rings and the scratch are written, and `count` is zero on entry and on
// return.
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
  if (G < 1 || G > walk::kMaxGroup || h % kTileCols || F % kTileCols
      || t < 0 || t >= S)
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return w_int8 ? launch_f32_w8(a, D, N, st) : launch_f32(a, D, N, st);
  if (dtype == kBF16)
    return w_int8 ? launch_bf16_w8(a, D, N, st) : launch_bf16(a, D, N, st);
  return cudaErrorInvalidValue;
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
// blocks. V must be a multiple of 32 for a column head and h at most the
// GEMVs' 4096 staged rows (the wrapper checks).
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
  if (G < 1 || G > walk::kMaxGroup || h % kTileCols || F % kTileCols
      || n_steps < 1 || n_steps > S || h > kChunkRows || V < 1
      || head_mode < kHeadDense || head_mode > kHeadInt8
      || (head_mode != kHeadTied && (V % kTileCols || head == nullptr))
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return w_int8 ? launch_multi_f32_w8(a, D, N, st)
                  : launch_multi_f32(a, D, N, st);
  if (dtype == kBF16)
    return w_int8 ? launch_multi_bf16_w8(a, D, N, st)
                  : launch_multi_bf16(a, D, N, st);
  return cudaErrorInvalidValue;
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
