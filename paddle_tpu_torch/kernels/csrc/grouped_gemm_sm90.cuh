// Hopper (sm_90a) grouped-GEMM machinery shared by gather_gmm.cu (B9, bf16
// and int8 rhs) and gmm.cu (B10's gmm, plain and transpose_rhs): one
// persistent, warp-specialised kernel template built on wgmma, TMA and
// mbarrier stages. It replaces the tiles of the TPU kernels
// paddle_tpu/kernels/moe_fused.py `gather_gmm` (pallas_call :266) and jax's
// megablox `gmm`, which paddle_tpu/kernels/moe_dispatch.py calls from
// `_gmm_tuned` (:434) and `_gmm_tuned_bwd` (:445).
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

#include <cuda.h>   // CUtensorMap; the encoder is fetched from the driver

#include "common.cuh"

namespace ptt {
namespace sm90 {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;        // output rows of a tile (2 warpgroups x 64)
constexpr int kBK = 64;         // reduction depth of a stage (128-byte rows)
constexpr int kThreads = 384;   // warpgroup 0 loads, 1 and 2 compute
constexpr int kAlign = 1024;    // a 128-byte swizzle atom: 8 rows x 128 bytes
constexpr int kMaxSmem = 232448;

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
// PTX: shared addresses, mbarriers, copies, fences, register split
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed; a wait that never
// ends (a fault in the stage protocol) traps, so the launch fails instead of
// holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done, tries = 0;
  do {
    if (++tries == (1u << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// order generic-proxy shared writes before async-proxy reads (wgmma, TMA)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// four (two) 8 x 8 b16 matrices from shared memory, transposed: lane t
// gives the row address t % 8 of matrix t / 8 and receives in r[i] the
// elements (rows 2*(t%4) and 2*(t%4)+1, column t/4) of matrix i
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

template <int kRegs>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
// A shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
// K-major (8-row groups of 128-byte rows): stride 1024, leading unused.
// N-major (64-column atoms of 8-row groups): stride 1024 between the groups
// of 8 reduction rows, leading the distance between 64-column atoms.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lead,
                                         uint32_t stride) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lead >> 4) << 16) |
         (uint64_t(stride >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// keep the compiler from moving accumulator accesses across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16, K-major, descriptor da) * B (16 x n, descriptor db;
// kTransB = 1: B stored N-major), bf16 in, f32 sums. Thread t of the
// warpgroup holds, for each 8-column chunk j, d[4j..4j+1] (row 16*(t/32) +
// (t%32)/4, columns 8j + 2*(t%4) + {0, 1}) and d[4j+2..4j+3] (8 rows down).
template <int kTransB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

template <int BN, int kTransB>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (BN == 256)
    wgmma_n256<kTransB>(d, da, db);
  else
    wgmma_n128<kTransB>(d, da, db);
}

// d[64] += A (64 x 16, bf16 fragments in registers: a[0..3] hold rows
// r and r + 8 (r = 16*(t/32) + (t%32)/4), reduction pairs 2*(t%4) and
// 2*(t%4) + 8) * B (16 x 128, K-major, descriptor db), f32 sums
__device__ __forceinline__ void wgmma_ra_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// tiles
// ---------------------------------------------------------------------------
// A 4 x 4 transpose across four lanes (lane = base + stride * t, t < 4) in
// two butterfly steps: lane t's v[i] becomes lane i's v[t]. The epilogues
// use it to trade 4-byte pieces of four rows (or chunks) for 16 contiguous
// bytes of one.
template <int kStride>
__device__ __forceinline__ void transpose4(uint32_t (&v)[4], int t) {
#pragma unroll
  for (int b = 1; b <= 2; b <<= 1) {
    const bool up = t & b;
#pragma unroll
    for (int i0 = 0; i0 < 4; ++i0) {
      if (i0 & b) continue;
      const int i1 = i0 | b;
      const uint32_t got =
          __shfl_xor_sync(kFullMask, up ? v[i0] : v[i1], b * kStride);
      if (up)
        v[i0] = got;
      else
        v[i1] = got;
    }
  }
}

// Two int8 values of w -> bf16x2, exactly: bytes 0 and 2 (kOdd false) or 1
// and 3 (kOdd true), the first in the low half. The low 7 bits of a byte
// become the mantissa of 128 + l, and subtracting 128 (sign bit clear) or
// 256 (set) gives the value; both are small integers, exact in bf16.
template <bool kOdd>
__device__ __forceinline__ uint32_t widen2(uint32_t w) {
  const uint32_t b = kOdd ? w >> 8 : w;
  const uint32_t lo = (b & 0x007F007Fu) | 0x43004300u;
  const uint32_t off = (b & 0x00800080u) | 0x43004300u;
  using B2 = __nv_bfloat162;
  const B2 r = __hsub2(*reinterpret_cast<const B2*>(&lo),
                       *reinterpret_cast<const B2*>(&off));
  return *reinterpret_cast<const uint32_t*>(&r);
}

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
            wgmma_ra_n128(acc[b], f[b], desc(xs + kk * 32, 16, 1024));
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
            wgmma<BN, kTransB ? 0 : 1>(acc, da, db);
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
// host: tensor maps and the launch
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded (no -lcuda)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a tiled map of a row-major tensor: dims innermost first, byte strides of
// dims 1.., zero fill outside it
inline cudaError_t encode(CUtensorMap* map, CUtensorMapDataType type, int rank,
                          const void* ptr, const cuuint64_t* dims,
                          const cuuint64_t* strides, const cuuint32_t* box,
                          CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res =
      fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

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
