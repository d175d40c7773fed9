// Hand-written Hopper (sm_90a) kernels for the serving path's attention:
// flash prefill and paged decode. Plain C entry points, loaded with ctypes
// by repro_torch/kernels/build.py; each returns the first CUDA error of
// its launches (0 when they were accepted). Inputs are float32 (dtype 0)
// or bfloat16 (dtype 1). The plain PyTorch versions live beside the
// wrappers in repro_torch/kernels/flash_attention.py.
//
// ---------------------------------------------------------------------------
// flash_attention_fwd replaces `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py (pallas_call at :116).
//   Bound on an H100: operations. A 128-row q tile against a 64-row K tile
//   costs 128*64*Dh*2 FLOP for S and as much for P.V against (128+2*64)*Dh
//   input elements, far above the card's ~295 FLOP/byte ridge; the prefix-
//   extend prefill of B=2, T=1024, S=1088, H=64, Dh=128 needs 3.9e10 FLOP, 39
//   us at 989 TFLOP/s.
//   Design (bf16, every head dim 16..256): one CTA per (128-row q tile, q
//   head, batch row), three warpgroups: two consumers, then the producer. The
//   producer gives up its registers (setmaxnreg) and one thread issues TMA
//   loads (cp.async.bulk.tensor, 4-D maps over [B, rows, heads, Dh] so KV head
//   h // G is read in place) of the Q tile once and of K and V tiles into a
//   two-stage ring, each stage with full barriers for K and V and an empty
//   barrier (mbarrier). The consumers take registers (setmaxnreg) and own 64 q
//   rows each. Per K tile: S = Q.K^T on the tensor cores (wgmma, both operands
//   in shared memory), the online softmax in registers on the accumulator's
//   own fragment (row max and sum over a quad of lanes), then P cast to bf16
//   in registers and fed to wgmma as its A operand for O += P.V, with V read
//   MN-major (transposed) from shared memory. The score tile never leaves
//   registers. ptxas compiles a 384-thread block to 168 registers a thread and
//   serialises the wgmma chain when S and O do not fit beside each other, so
//   the K tile is 128 rows at Dh <= 64, 64 at Dh 128 and 32 at Dh 256 (where O
//   alone takes 128 registers and the chain stays serialised). Tiles are cut
//   into 64-column chunks under the 128-byte swizzle (64B / 32B swizzle at Dh
//   32 / 16) that both TMA and the wgmma descriptors use. The causal frontier
//   and the window's lower edge (both offset by q_offset) bound the K tiles a
//   CTA loads; a consumer skips tiles wholly masked for its rows, and only
//   tiles that straddle the diagonal, the window edge or S pay for the mask.
//   TMA zero-fills rows past T and S. P is rounded to bf16 before P.V, as the
//   JAX reference path (`_chunked_attention`) does; the TPU kernel kept P in
//   fp32.
//   fp32 inputs keep a CUDA-core kernel (fp32 products and softmax): TF32
//   wgmma would not meet the fp32 cases' tolerance. This is a dispatch by
//   dtype; serving runs bf16.
//
// paged_decode_fwd replaces `_paged_decode_kernel` / `paged_decode_attention`
// in src/repro/kernels/flash_attention.py (pallas_call at :224).
//   Bound on an H100: bytes. Each K/V row is read once for G query heads
//   (4*G FLOP per element, far below the ridge): B=4 slots at ~990 rows,
//   KV=8, Dh=128 in bf16 read 16.1 MB, 4.8 us at 3.35 TB/s.
//   Design (split-K): the TPU ran the page axis as a sequential grid
//   dimension with the online softmax in VMEM scratch (:141-174). Here
//   pass 1 runs a grid of (KV head, slot, split): each split owns a run of
//   the slot's logical pages (the wrapper's planner picks the split count
//   so that small batches still fill the SMs), and each of its 8 warps
//   takes 16 rows at a time. A warp issues all of its rows' K and V loads
//   (16-byte vectors) before it computes. In bf16 it works on the tensor
//   cores (mma.sync m16n8k16): S = K.q^T for 8 query heads of the group at
//   once, an online softmax per head on S's accumulator fragment, and
//   O^T += V^T.P^T with P rounded to bf16 (as the plain version does) and
//   V transposed in registers (movmatrix). fp32 inputs keep the CUDA-core
//   form of the same loop (one lane pair per row, P in fp32). The CTA
//   merges its warps in fixed order into an fp32 partial (m, l, acc[G,
//   Dh]) in a workspace. Pass 2 merges a slot's partials in fixed split
//   order (no atomics: two calls give the same bits), its weights computed
//   once in shared memory so that the partials' reads are independent
//   loads. A split wholly past pos writes m = NEG_INF, l = 0 and no acc;
//   the merge gives it weight 0 and never reads its acc. With one split
//   pass 1 writes the output itself. Free slots point at trash page 0,
//   which is read like any page; its garbage stays in their own rows, and
//   a masked row's V is zeroed before the product.
// ---------------------------------------------------------------------------
#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;  // the TPU kernels' mask value
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// set a kernel's dynamic shared memory limit once per instantiation
template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes, bool* done) {
  if (*done || bytes <= 48 * 1024) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *done = true;
  return err;
}

// ------------------------------------------- Hopper primitives (inline PTX)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// returns once the barrier's phase of this parity has completed; a wait
// that never ends (a ring fault) traps, so the launch fails instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// one TMA box of a 4-D map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pins registers that an asynchronous wgmma reads or writes to this point
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor for a tile whose rows are CW bf16
// elements (CW*2 bytes) under the matching swizzle (128B at CW 64, 64B at
// 32, 32B at 16), 8-row groups CW*16 bytes apart (the stride byte offset).
// `lbo` is the leading byte offset: unused for K-major operands, the
// distance between CW-column chunks for the MN-major V operand.
template <int CW>
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo) {
  constexpr uint64_t layout = CW == 64 ? 1 : CW == 32 ? 2 : 3;
  constexpr uint32_t sbo = 8 * CW * 2;
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------- wgmma (m64nNk16, bf16 -> fp32)
// D[64x32] (+)= A[64x16] . B[16x32]; A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da,
                                             uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accum));
}

// D[64x64] (+)= A[64x16] . B[16x64]; A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31])
      : "l"(da), "l"(db), "r"(accum));
}

// D[64x128] (+)= A[64x16] . B[16x128]; A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                             uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accum));
}

// D[64x16] += A[64x16] . B[16x16]; A from registers, B MN-major in
// shared memory (transposed)
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64x32] += A[64x16] . B[16x32]; A from registers, B MN-major in
// shared memory (transposed)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64x64] += A[64x16] . B[16x64]; A from registers, B MN-major in
// shared memory (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64x128] += A[64x16] . B[16x128]; A from registers, B MN-major in
// shared memory (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64x256] += A[64x16] . B[16x256]; A from registers, B MN-major in
// shared memory (transposed)
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, "
      "%115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
      "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
      "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
      "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
      "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
      "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
      "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
      "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
      "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
      "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
      "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------- flash prefill, bf16, wgmma
constexpr int FW_BQ = 128;       // q rows per CTA: 64 per consumer warpgroup
constexpr int FW_THREADS = 384;  // 2 consumer warpgroups + 1 producer
constexpr int FW_STAGES = 2;     // K/V ring depth

template <int DH>
struct WgTile {
  // k rows per tile: S (BK/2 floats a thread) beside O (DH/2) within the
  // 168 registers a consumer gets at compile time
  static constexpr int BK = DH <= 64 ? 128 : DH <= 128 ? 64 : 32;
  static constexpr int CW = DH < 64 ? DH : 64;     // columns per chunk
  static constexpr int NCH = DH / CW;              // chunks per row
  static constexpr int Q_BYTES = FW_BQ * DH * 2;
  static constexpr int KV_BYTES = BK * DH * 2;  // one K or V tile
  // 1 KB of slack to align the swizzled tiles, then the barriers
  static constexpr size_t smem_bytes =
      1024 + Q_BYTES + 2 * FW_STAGES * KV_BYTES + 64;
};

// S += Q.K^T over one K tile: NCH chunks of CW/16 k-steps each
template <int DH>
__device__ __forceinline__ void score_tile(float* s, uint32_t q_addr,
                                           uint32_t k_addr) {
  using W = WgTile<DH>;
  constexpr int CW = W::CW;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int c = kk / (CW / 16), w = kk % (CW / 16);
    const uint64_t da = make_desc<CW>(q_addr + c * FW_BQ * CW * 2 + w * 32, 16);
    const uint64_t db = make_desc<CW>(k_addr + c * W::BK * CW * 2 + w * 32, 16);
    if constexpr (W::BK == 128) wgmma_ss_n128(s, da, db, kk > 0);
    if constexpr (W::BK == 64) wgmma_ss_n64(s, da, db, kk > 0);
    if constexpr (W::BK == 32) wgmma_ss_n32(s, da, db, kk > 0);
  }
}

// O += P.V over one V tile: BK/16 k-steps, P in registers
template <int DH>
__device__ __forceinline__ void pv_tile(float* o, uint32_t (*pa)[4],
                                        uint32_t v_addr) {
  using W = WgTile<DH>;
  constexpr int CW = W::CW;
#pragma unroll
  for (int kk = 0; kk < W::BK / 16; ++kk) {
    const uint64_t db =
        make_desc<CW>(v_addr + kk * 16 * CW * 2, W::BK * CW * 2);
    if constexpr (DH == 16) wgmma_rs_n16(o, pa[kk], db);
    if constexpr (DH == 32) wgmma_rs_n32(o, pa[kk], db);
    if constexpr (DH == 64) wgmma_rs_n64(o, pa[kk], db);
    if constexpr (DH == 128) wgmma_rs_n128(o, pa[kk], db);
    if constexpr (DH == 256) wgmma_rs_n256(o, pa[kk], db);
  }
}

template <int DH>
__global__ void __launch_bounds__(FW_THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, int Tq, int S, int H,
                   int KV, int causal, int window, int q_offset,
                   float scale_log2) {
  using W = WgTile<DH>;
  constexpr int BK = W::BK, CW = W::CW, NCH = W::NCH;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;  // swizzle atoms are 1 KB
  const uint32_t sk = sq + W::Q_BYTES;        // stage s at + s * KV_BYTES
  const uint32_t sv = sk + FW_STAGES * W::KV_BYTES;
  const uint32_t bars = sv + FW_STAGES * W::KV_BYTES;
  // barriers: Q, then per stage full-K, full-V and empty
  const uint32_t bar_q = bars, bar_k0 = bars + 8;
  const uint32_t bar_v0 = bar_k0 + 8 * FW_STAGES;
  const uint32_t bar_e0 = bar_v0 + 8 * FW_STAGES;

  const int tid = threadIdx.x, wg = tid / 128;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FW_BQ;  // long rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  // K tiles this CTA needs: causal frontier and window edge, both offset
  // by q_offset (absolute position of q row 0)
  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + min(q0 + FW_BQ, Tq) - 1;
  const int k_end = causal ? min(S, qpos_hi + 1) : S;
  const int k_begin = window > 0 ? max(0, qpos_lo - window + 1) : 0;
  const int kt0 = k_begin / BK;
  const int n_tiles = max(0, (k_end + BK - 1) / BK - kt0);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(bar_k0 + 8 * s, 1);
      mbar_init(bar_v0 + 8 * s, 1);
      mbar_init(bar_e0 + 8 * s, 256);  // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256) {
      mbar_expect_tx(bar_q, W::Q_BYTES);
      for (int c = 0; c < NCH; ++c)
        tma_load_4d(sq + c * FW_BQ * CW * 2, &tq, bar_q, c * CW, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % FW_STAGES, ph = (it / FW_STAGES) & 1;
        const int k0 = (kt0 + it) * BK;
        mbar_wait(bar_e0 + 8 * st, ph ^ 1);  // round 0 passes at once
        mbar_expect_tx(bar_k0 + 8 * st, W::KV_BYTES);
        for (int c = 0; c < NCH; ++c)
          tma_load_4d(sk + st * W::KV_BYTES + c * BK * CW * 2, &tk,
                      bar_k0 + 8 * st, c * CW, kvh, k0, b);
        mbar_expect_tx(bar_v0 + 8 * st, W::KV_BYTES);
        for (int c = 0; c < NCH; ++c)
          tma_load_4d(sv + st * W::KV_BYTES + c * BK * CW * 2, &tv,
                      bar_v0 + 8 * st, c * CW, kvh, k0, b);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg, t = tid % 128, warp = t / 32, lane = t % 32;
    const int r0 = q0 + 64 * cw + 16 * warp + lane / 4;  // rows r0, r0 + 8
    const int wq0 = q0 + 64 * cw;                        // this WG's rows
    const bool has_rows = wq0 < Tq;
    const int wpos_lo = q_offset + wq0;
    const int wpos_hi = q_offset + min(wq0 + 64, Tq) - 1;
    const uint32_t q_addr = sq + 64 * cw * CW * 2;

    float acc[DH / 2];  // O fragment: DH/8 column groups x 4
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    mbar_wait(bar_q, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % FW_STAGES, ph = (it / FW_STAGES) & 1;
      const int k0 = (kt0 + it) * BK;
      const bool active = has_rows && !(causal && k0 > wpos_hi) &&
                          !(window > 0 && k0 + BK - 1 <= wpos_lo - window);
      uint32_t pa[BK / 16][4];
      mbar_wait(bar_k0 + 8 * st, ph);
      if (active) {
        float s[BK / 2];
        fence_regs<BK / 2>(s);
        wgmma_fence();
        score_tile<DH>(s, q_addr, sk + st * W::KV_BYTES);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<BK / 2>(s);
        const bool need_mask =
            k0 + BK > S || (causal && k0 + BK - 1 > wpos_lo) ||
            (window > 0 && k0 <= wpos_hi - window);
        if (need_mask) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            const int j = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
            const int qp = q_offset + r0 + ((i & 2) ? 8 : 0);
            const bool ok = j < S && (!causal || j <= qp) &&
                            (window <= 0 || j > qp - window);
            if (!ok) s[i] = -INFINITY;
          }
        }
        // online softmax on the fragment: entries 4j+{0,1} are row r0,
        // 4j+{2,3} row r0+8; a row's 4 owners are one quad of lanes
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        float alpha[2], mb[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[r] = exp2f((m[r] - mx[r]) * scale_log2);
          mb[r] = mx[r] * scale_log2;
          m[r] = mx[r];
          l[r] *= alpha[r];  // a thread-local partial row sum
        }
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int r = (i >> 1) & 1;
          s[i] = exp2f(fmaf(s[i], scale_log2, -mb[r]));
          l[r] += s[i];
        }
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        // the S fragment of k-step kk is the A fragment of P.V's k-step
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
          pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
      }
      mbar_wait(bar_v0 + 8 * st, ph);
      if (active) {
        fence_regs<DH / 2>(acc);
        fence_regs<BK / 4>(&pa[0][0]);
        wgmma_fence();
        pv_tile<DH>(acc, pa, sv + st * W::KV_BYTES);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<DH / 2>(acc);
      }
      mbar_arrive(bar_e0 + 8 * st);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= Tq) continue;
      __nv_bfloat16* dst =
          o + (((int64_t)b * Tq + row) * H + h) * DH + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(acc[4 * j + 2 * r] * l[r], acc[4 * j + 2 * r + 1] * l[r]);
    }
  }
}

// cuTensorMapEncodeTiled looked up through the CUDA runtime, so the
// library needs no link against libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 [B, rows, heads, DH] tensor as a 4-D TMA map whose box is one
// CW-column chunk of `box_rows` rows of one head
template <int DH>
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B,
              int rows, int heads, int box_rows) {
  constexpr int CW = WgTile<DH>::CW;
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)DH * 2,
                                 (cuuint64_t)heads * DH * 2,
                                 (cuuint64_t)rows * heads * DH * 2};
  const cuuint32_t box[4] = {(cuuint32_t)CW, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = CW == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CW == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
cudaError_t launch_flash_wgmma(const void* q, const void* k, const void* v,
                               void* o, int B, int Tq, int S, int H, int KV,
                               int causal, int window, int q_offset,
                               float scale, cudaStream_t stream) {
  static bool smem_set = false;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!make_map<DH>(enc, &mq, q, B, Tq, H, FW_BQ) ||
      !make_map<DH>(enc, &mk, k, B, S, KV, WgTile<DH>::BK) ||
      !make_map<DH>(enc, &mv, v, B, S, KV, WgTile<DH>::BK))
    return cudaErrorInvalidValue;
  const size_t smem = WgTile<DH>::smem_bytes;
  cudaError_t err = allow_smem(flash_wgmma_kernel<DH>, smem, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + FW_BQ - 1) / FW_BQ, H, B);
  flash_wgmma_kernel<DH><<<grid, FW_THREADS, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), Tq, S, H, KV, causal,
      window, q_offset, scale * LOG2E);
  return cudaGetLastError();
}

// ------------------------------------------- flash prefill, fp32, CUDA cores
constexpr int BQ = 64;              // q rows per block
constexpr int FLASH_THREADS = 256;  // 16 x 16: ty owns 4 rows, tx columns

template <int DH>
struct FlashTile {
  static constexpr int BK = DH <= 128 ? 64 : 32;  // k rows per tile
  static constexpr int LD = DH + 1;   // padded rows: column walks hit
                                      // distinct banks
  static constexpr int LDP = BK + 1;
  static constexpr size_t smem_bytes =
      sizeof(float) * (size_t)(BQ * LD + BK * LD + BQ * LDP);
};

template <typename T, int DH>
__global__ void __launch_bounds__(FLASH_THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Tq, int S,
                 int H, int KV, int causal, int window, int q_offset,
                 float scale) {
  using Tile = FlashTile<DH>;
  constexpr int BK = Tile::BK, LD = Tile::LD, LDP = Tile::LDP;
  constexpr int CK = BK / 16;  // score columns per thread
  constexpr int CD = DH / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;            // [BQ][LD]  q * scale
  float* sKV = sQ + BQ * LD;   // [BK][LD]  K tile, then V tile
  float* sP = sKV + BK * LD;   // [BQ][LDP] probabilities of this tile

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);

  for (int i = tid; i < BQ * DH; i += FLASH_THREADS) {
    const int r = i / DH, d = i % DH, t = q0 + r;
    sQ[r * LD + d] =
        t < Tq ? to_f(q[(((int64_t)b * Tq + t) * H + h) * DH + d]) * scale
               : 0.f;
  }

  float m[4], l[4], acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  // keys this tile can see: causal frontier and window edge, both offset
  // by q_offset (absolute position of q row 0)
  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + min(q0 + BQ, Tq) - 1;
  const int k_end = causal ? min(S, qpos_hi + 1) : S;
  const int k_begin = window > 0 ? max(0, qpos_lo - window + 1) : 0;
  const int kt_end = (k_end + BK - 1) / BK;

  for (int kt = k_begin / BK; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's V reads are done
    for (int i = tid; i < BK * DH; i += FLASH_THREADS) {
      const int r = i / DH, d = i % DH, j = k0 + r;
      sKV[r * LD + d] =
          j < S ? to_f(k[(((int64_t)b * S + j) * KV + kvh) * DH + d]) : 0.f;
    }
    __syncthreads();

    float s[4][CK];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CK; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[CK];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int c = 0; c < CK; ++c) kv[c] = sKV[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CK; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

    // masked online softmax; a row's 16 column threads sit in one half
    // warp, so xor shuffles over lanes 1..8 reduce it
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qpos = q_offset + q0 + r;
      bool ok[CK];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int j = k0 + tx + 16 * c;
        ok[c] = j < S && q0 + r < Tq && (!causal || j <= qpos) &&
                (window <= 0 || j > qpos - window);
        if (ok[c]) mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float p = ok[c] ? expf(s[i][c] - m_new) : 0.f;
        sP[r * LDP + tx + 16 * c] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // K reads done, P written

    for (int i = tid; i < BK * DH; i += FLASH_THREADS) {
      const int r = i / DH, d = i % DH, j = k0 + r;
      sKV[r * LD + d] =
          j < S ? to_f(v[(((int64_t)b * S + j) * KV + kvh) * DH + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * LDP + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const float vv = sKV[j * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= Tq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CD; ++c)
      o[(((int64_t)b * Tq + t) * H + h) * DH + tx + 16 * c] =
          from_f<T>(acc[i][c] * inv);
  }
}

template <typename T, int DH>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o,
                         int B, int Tq, int S, int H, int KV, int causal,
                         int window, int q_offset, float scale,
                         cudaStream_t stream) {
  static bool smem_set = false;
  const size_t smem = FlashTile<DH>::smem_bytes;  // above the 48 KB default
  cudaError_t err = allow_smem(flash_fwd_kernel<T, DH>, smem, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DH><<<grid, FLASH_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Tq, S, H, KV, causal,
      window, q_offset, scale);
  return cudaGetLastError();
}

// dtype x head dim dispatch of flash prefill: bf16 on the tensor cores,
// fp32 on the CUDA cores
cudaError_t dispatch_flash(int dtype, int Dh, const void* q, const void* k,
                           const void* v, void* o, int B, int Tq, int S,
                           int H, int KV, int causal, int window,
                           int q_offset, float scale, cudaStream_t stream) {
#define FLASH_CASE(D)                                                        \
  case D:                                                                    \
    return dtype == 1                                                        \
               ? launch_flash_wgmma<D>(q, k, v, o, B, Tq, S, H, KV, causal,  \
                                       window, q_offset, scale, stream)      \
               : launch_flash<float, D>(q, k, v, o, B, Tq, S, H, KV, causal, \
                                        window, q_offset, scale, stream);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (Dh) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

// ------------------------------------------------------ paged decode, split-K
constexpr int DEC_WARPS = 8;
constexpr int DEC_THREADS = 32 * DEC_WARPS;
constexpr int DEC_ROWS = 16;  // rows a warp takes per pass: a lane pair each

template <int BYTES> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<2> { using type = unsigned short; };

// N contiguous elements of T read with the widest loads that fit
template <typename T, int N>
struct Frag {
  static constexpr int BYTES = N * (int)sizeof(T);
  static constexpr int WB = BYTES > 16 ? 16 : BYTES;
  using W = typename Word<WB>::type;
  W w[BYTES / WB];
  __device__ __forceinline__ void load(const T* p) {
    const W* src = reinterpret_cast<const W*>(p);
#pragma unroll
    for (int i = 0; i < BYTES / WB; ++i) w[i] = __ldg(src + i);
  }
  __device__ __forceinline__ float get(int i) const {
    return to_f(reinterpret_cast<const T*>(w)[i]);
  }
};

// pass 1's shared memory in floats: q (two padded half rows a head, so
// the halves a lane pair reads sit in other banks), probabilities, the
// warps' running max and sum, and their accumulators
__host__ __device__ constexpr int dec_qld(int DH) { return DH / 2 + 4; }
constexpr size_t dec_smem_bytes(int DH, int GC) {
  return sizeof(float) *
         ((size_t)GC * 2 * dec_qld(DH) + (size_t)DEC_WARPS * DEC_ROWS * GC +
          2 * (size_t)DEC_WARPS * GC + (size_t)DEC_WARPS * GC * DH);
}

// Pass 1 on the CUDA cores (fp32 inputs). grid (KV head, slot, split); GC
// query heads of the group at a time. ws_acc [B, KV, splits, G, DH] and ws_ml [B, KV, splits, G, 2]
// take the partials; with one split the output is written directly.
template <typename T, int DH, int GC>
__global__ void __launch_bounds__(DEC_THREADS, 2)
paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                          const T* __restrict__ vp,
                          const int32_t* __restrict__ page_table,
                          const int32_t* __restrict__ pos, T* __restrict__ o,
                          float* __restrict__ ws_acc,
                          float* __restrict__ ws_ml, int H, int KV, int ps,
                          int P, int pages_per_split, int rolling,
                          float scale_log2) {
  constexpr int QLD = dec_qld(DH);
  constexpr int HC = DH / 2;                    // columns a lane scores
  constexpr int CPL = DH >= 32 ? DH / 32 : 1;   // value columns a lane sums
  constexpr int VL = DH / CPL;                  // lanes holding values
  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int nsplit = gridDim.z, G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = lane & 1, rl = lane >> 1;
  extern __shared__ float dsm[];
  float* sQ = dsm;                           // [GC][2][QLD] q*scale*log2e
  float* sP = sQ + GC * 2 * QLD;             // [warp][row][GC]
  float* sM = sP + DEC_WARPS * DEC_ROWS * GC;  // [warp][GC] max, log2 units
  float* sL = sM + DEC_WARPS * GC;           // [warp][GC] running sum
  float* sAcc = sL + DEC_WARPS * GC;         // [warp][GC][DH]

  const int p = pos[b];
  const int cap = P * ps;
  // rows 0..p hold positions <= p until the slot wraps (rolling) or
  // saturates (linear); after that every page does
  const int n_pages = p < cap ? p / ps + 1 : P;
  const int pg0 = split * pages_per_split;
  const int pg1 = min(pg0 + pages_per_split, n_pages);
  const int64_t ws_row = ((int64_t)(b * KV + kvh) * nsplit + split) * G;
  if (pg1 <= pg0) {  // wholly past pos: weight 0 in the merge
    for (int g = tid; g < G; g += DEC_THREADS) {
      ws_ml[2 * (ws_row + g)] = NEG_INF;
      ws_ml[2 * (ws_row + g) + 1] = 0.f;
    }
    return;
  }
  const int row0 = pg0 * ps, nrows = (pg1 - pg0) * ps;
  const int npass = (nrows + DEC_ROWS - 1) / DEC_ROWS;

  for (int g0 = 0; g0 < G; g0 += GC) {
    for (int i = tid; i < GC * DH; i += DEC_THREADS) {
      const int g = i / DH, d = i % DH;
      sQ[g * 2 * QLD + (d / HC) * QLD + d % HC] =
          g0 + g < G
              ? to_f(q[((int64_t)b * H + kvh * G + g0 + g) * DH + d]) *
                    scale_log2
              : 0.f;
    }
    __syncthreads();
    float m[GC], l[GC], acc[GC][CPL];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[g][c] = 0.f;
    }

    for (int pass = warp; pass < npass; pass += DEC_WARPS) {
      const int r = pass * DEC_ROWS + rl;  // this lane pair's row
      const int row = row0 + r;            // logical row of the slot
      bool ok = false;
      int64_t base = 0;  // rows past the split read page 0, masked
      if (r < nrows) {
        const int64_t pid = page_table[(int64_t)b * P + row / ps];
        base = ((pid * ps + row % ps) * KV + kvh) * DH;
        // rolling: the latest position p' <= p with p' % cap == row
        const int spos = rolling ? p - (((p - row) % cap) + cap) % cap : row;
        ok = spos >= 0 && spos <= p;
      }
      // every load of the pass is in flight before any arithmetic
      Frag<T, HC> kf;
      kf.load(kp + base + half * HC);
      Frag<T, CPL> vf[DEC_ROWS];
#pragma unroll
      for (int rr = 0; rr < DEC_ROWS; ++rr) {
        const int64_t rb = __shfl_sync(0xffffffffu, base, 2 * rr);
        if (lane < VL) vf[rr].load(vp + rb + lane * CPL);
      }
      const unsigned okmask = __ballot_sync(0xffffffffu, ok);

      float s[GC];
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float4* qv =
            reinterpret_cast<const float4*>(sQ + (g * 2 + half) * QLD);
        float acc_s = 0.f;
#pragma unroll
        for (int i = 0; i < HC / 4; ++i) {
          const float4 qq = qv[i];
          acc_s = fmaf(qq.x, kf.get(4 * i), acc_s);
          acc_s = fmaf(qq.y, kf.get(4 * i + 1), acc_s);
          acc_s = fmaf(qq.z, kf.get(4 * i + 2), acc_s);
          acc_s = fmaf(qq.w, kf.get(4 * i + 3), acc_s);
        }
        acc_s += __shfl_xor_sync(0xffffffffu, acc_s, 1);
        s[g] = ok ? acc_s : -INFINITY;
      }
      // online softmax over the pass's 16 rows (lanes of one half)
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float mx = s[g];
#pragma unroll
        for (int off = 2; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[g], mx);
        const float alpha = exp2f(m[g] - m_new);
        const float pe = exp2f(s[g] - m_new);  // masked rows: exp2(-inf)
        float sum = pe;
#pragma unroll
        for (int off = 2; off < 32; off <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l[g] = l[g] * alpha + sum;
        m[g] = m_new;
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[g][c] *= alpha;
        if (half == 0) sP[(warp * DEC_ROWS + rl) * GC + g] = pe;
      }
      __syncwarp();
      if (lane < VL) {
#pragma unroll
        for (int rr = 0; rr < DEC_ROWS; ++rr) {
          if (!((okmask >> (2 * rr)) & 1u)) continue;  // masked: p = 0
#pragma unroll
          for (int g = 0; g < GC; ++g) {
            const float pr = sP[(warp * DEC_ROWS + rr) * GC + g];
#pragma unroll
            for (int c = 0; c < CPL; ++c)
              acc[g][c] = fmaf(pr, vf[rr].get(c), acc[g][c]);
          }
        }
      }
      __syncwarp();
    }

    // merge the warps in fixed order
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (lane == 0) {
        sM[warp * GC + g] = m[g];
        sL[warp * GC + g] = l[g];
      }
      if (lane < VL) {
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          sAcc[(warp * GC + g) * DH + lane * CPL + c] = acc[g][c];
      }
    }
    __syncthreads();
    for (int i = tid; i < GC * DH; i += DEC_THREADS) {
      const int g = i / DH, d = i % DH;
      if (g0 + g >= G) continue;
      float M = NEG_INF;
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) M = fmaxf(M, sM[w * GC + g]);
      float Ls = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) {
        const float f = exp2f(sM[w * GC + g] - M);
        Ls = fmaf(f, sL[w * GC + g], Ls);
        A = fmaf(f, sAcc[(w * GC + g) * DH + d], A);
      }
      if (nsplit == 1) {
        o[((int64_t)b * H + kvh * G + g0 + g) * DH + d] =
            from_f<T>(A / fmaxf(Ls, 1e-30f));
      } else {
        const int64_t wr = ws_row + g0 + g;
        ws_acc[wr * DH + d] = A;
        if (d == 0) {
          ws_ml[2 * wr] = M;
          ws_ml[2 * wr + 1] = Ls;
        }
      }
    }
    __syncthreads();  // sQ and sAcc are reused by the next head chunk
  }
}

// Pass 1 for bf16 on the tensor cores (mma.sync m16n8k16, fp32
// accumulate). grid (KV head, slot, split) as above; a warp takes 16 rows
// at a time and 8 query heads of the group at a time:
//   S[row][head] = K . q^T: A = K (16 rows x k16), B = q^T (k16 x 8 heads).
//     The k order inside the product is free, so lane (g, c) holds the
//     contiguous slice [c*DH/4, (c+1)*DH/4) of rows g and g+8 and of q's
//     head g, read with 16-byte loads straight into A and B fragments.
//   online softmax per head on S's accumulator fragment (a column of 16
//     rows: shuffles over the 8 lanes of equal c).
//   O^T[d][head] += V^T . P^T: A = V^T (16 d x k16 rows), B = P^T. V rows
//     are read 16 bytes at a time and cut into 8x8 blocks that movmatrix
//     transposes in registers, which permutes the d index of O^T (undone
//     when O^T goes to shared memory); P, rounded to bf16 as the plain
//     version does, is S's fragment transposed the same way.
// The CTA then merges its warps in fixed order as the CUDA-core kernel.
__device__ __forceinline__ void dec_mma(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// the 8x8 b16 matrix whose row lane/4, columns 2*(lane%4) and +1, this
// lane holds -> the same fragment of its transpose
__device__ __forceinline__ uint32_t dec_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}
// N bf16 at p (8-byte aligned; 16-byte for N >= 8) into N/2 words
template <int N>
__device__ __forceinline__ void load_words(uint32_t (&w)[N / 2],
                                           const __nv_bfloat16* p) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = x.x;
      w[4 * i + 1] = x.y;
      w[4 * i + 2] = x.z;
      w[4 * i + 3] = x.w;
    }
  } else {
    static_assert(N == 4, "4 or a multiple of 8 elements");
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = x.x;
    w[1] = x.y;
  }
}

constexpr size_t dec_mma_smem_bytes(int DH) {
  return sizeof(float) *
         (2 * (size_t)DEC_WARPS * 8 + (size_t)DEC_WARPS * 8 * DH);
}

template <int DH>
__global__ void __launch_bounds__(DEC_THREADS, DH >= 256 ? 1 : 2)
paged_decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ kp,
                        const __nv_bfloat16* __restrict__ vp,
                        const int32_t* __restrict__ page_table,
                        const int32_t* __restrict__ pos,
                        __nv_bfloat16* __restrict__ o,
                        float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                        int H, int KV, int ps, int P, int pages_per_split,
                        int rolling, float scale_log2) {
  constexpr int KQ = DH / 4;                    // k a lane holds per row
  constexpr int NCH = DH / 16;                  // k16 steps of S
  constexpr int VW = DH / 4 < 8 ? DH / 4 : 8;   // V elements per load
  constexpr int NG = DH / (4 * VW);             // V column groups
  constexpr int MT = VW / 4;                    // m16 tiles of O^T a group
  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int nsplit = gridDim.z, G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  extern __shared__ float dsm[];
  float* sM = dsm;                     // [warp][8] max, log2 units
  float* sL = sM + DEC_WARPS * 8;      // [warp][8] running sum
  float* sAcc = sL + DEC_WARPS * 8;    // [warp][8][DH]

  const int p = pos[b];
  const int cap = P * ps;
  const int n_pages = p < cap ? p / ps + 1 : P;
  const int pg0 = split * pages_per_split;
  const int pg1 = min(pg0 + pages_per_split, n_pages);
  const int64_t ws_row = ((int64_t)(b * KV + kvh) * nsplit + split) * G;
  if (pg1 <= pg0) {  // wholly past pos: weight 0 in the merge
    for (int h = tid; h < G; h += DEC_THREADS) {
      ws_ml[2 * (ws_row + h)] = NEG_INF;
      ws_ml[2 * (ws_row + h) + 1] = 0.f;
    }
    return;
  }
  const int row0 = pg0 * ps, nrows = (pg1 - pg0) * ps;
  const int nblk = (nrows + 15) / 16;

  for (int g0 = 0; g0 < G; g0 += 8) {
    uint32_t qw[KQ / 2];  // B of S: head g0 + g, k slice c (0 past G)
    if (g0 + g < G) {
      load_words<KQ>(qw,
                     q + ((int64_t)b * H + kvh * G + g0 + g) * DH + c * KQ);
    } else {
#pragma unroll
      for (int i = 0; i < KQ / 2; ++i) qw[i] = 0u;
    }
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float acc[NG * MT][4];
#pragma unroll
    for (int t = 0; t < NG * MT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

    for (int blk = warp; blk < nblk; blk += DEC_WARPS) {
      int64_t base[2];  // rows g and g + 8; rows past the split read page 0
      bool ok[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = blk * 16 + g + 8 * h;
        base[h] = 0;
        ok[h] = false;
        if (r < nrows) {
          const int row = row0 + r;
          const int64_t pid = page_table[(int64_t)b * P + row / ps];
          base[h] = ((pid * ps + row % ps) * KV + kvh) * DH;
          // rolling: the latest position p' <= p with p' % cap == row
          const int spos =
              rolling ? p - (((p - row) % cap) + cap) % cap : row;
          ok[h] = spos >= 0 && spos <= p;
        }
      }
      // every load of the block is in flight before any arithmetic
      uint32_t kw[2][KQ / 2], vw[2][NG][VW / 2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        load_words<KQ>(kw[h], kp + base[h] + c * KQ);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int grp = 0; grp < NG; ++grp)
          load_words<VW>(vw[h][grp], vp + base[h] + grp * 4 * VW + c * VW);
      // a masked row's V may hold anything (stale or trash rows): zero it,
      // since its P = 0 times a NaN would still be a NaN in the product
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (!ok[h])
#pragma unroll
          for (int grp = 0; grp < NG; ++grp)
#pragma unroll
            for (int i = 0; i < VW / 2; ++i) vw[h][grp][i] = 0u;

      float sc[4] = {0.f, 0.f, 0.f, 0.f};  // (row g | g+8) x (head 2c, 2c+1)
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const uint32_t a[4] = {kw[0][2 * j], kw[1][2 * j], kw[0][2 * j + 1],
                               kw[1][2 * j + 1]};
        dec_mma(sc, a, qw[2 * j], qw[2 * j + 1]);
      }
      float pr[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // head 2c + e
        const float x0 = ok[0] ? sc[e] * scale_log2 : -INFINITY;
        const float x1 = ok[1] ? sc[2 + e] * scale_log2 : -INFINITY;
        float mx = fmaxf(x0, x1);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[e], mx);
        const float alpha = exp2f(m[e] - m_new);
        pr[e] = exp2f(x0 - m_new);  // masked rows: exp2(-inf) = 0
        pr[2 + e] = exp2f(x1 - m_new);
        float sum = pr[e] + pr[2 + e];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l[e] = l[e] * alpha + sum;
        m[e] = m_new;
#pragma unroll
        for (int t = 0; t < NG * MT; ++t) {
          acc[t][e] *= alpha;
          acc[t][2 + e] *= alpha;
        }
      }
      // B of O^T: P^T, rows 0-7 and 8-15
      const uint32_t pb0 = dec_trans(pack_bf16(pr[0], pr[1]));
      const uint32_t pb1 = dec_trans(pack_bf16(pr[2], pr[3]));
#pragma unroll
      for (int grp = 0; grp < NG; ++grp)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int i = 2 * mt;
          const uint32_t a[4] = {
              dec_trans(vw[0][grp][i]), dec_trans(vw[0][grp][i + 1]),
              dec_trans(vw[1][grp][i]), dec_trans(vw[1][grp][i + 1])};
          dec_mma(acc[grp * MT + mt], a, pb0, pb1);
        }
    }

    // O^T's fragment: row g of 8x8 block i of group grp is d = grp*4*VW +
    // (g/2)*VW + 2i + g%2 (blocks 2mt and 2mt+1 make m-tile mt)
    if (g == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sM[warp * 8 + 2 * c + e] = m[e];
        sL[warp * 8 + 2 * c + e] = l[e];
      }
    }
#pragma unroll
    for (int grp = 0; grp < NG; ++grp)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int d = grp * 4 * VW + (g >> 1) * VW + 4 * mt + (g & 1);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float* row = sAcc + (warp * 8 + 2 * c + e) * DH;
          row[d] = acc[grp * MT + mt][e];
          row[d + 2] = acc[grp * MT + mt][2 + e];
        }
      }
    __syncthreads();
    for (int i = tid; i < 8 * DH; i += DEC_THREADS) {
      const int hh = i / DH, d = i % DH;
      if (g0 + hh >= G) continue;
      float M = NEG_INF;
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) M = fmaxf(M, sM[w * 8 + hh]);
      float Ls = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) {
        const float f = exp2f(sM[w * 8 + hh] - M);
        Ls = fmaf(f, sL[w * 8 + hh], Ls);
        A = fmaf(f, sAcc[(w * 8 + hh) * DH + d], A);
      }
      if (nsplit == 1) {
        o[((int64_t)b * H + kvh * G + g0 + hh) * DH + d] =
            __float2bfloat16(A / fmaxf(Ls, 1e-30f));
      } else {
        const int64_t wr = ws_row + g0 + hh;
        ws_acc[wr * DH + d] = A;
        if (d == 0) {
          ws_ml[2 * wr] = M;
          ws_ml[2 * wr + 1] = Ls;
        }
      }
    }
    __syncthreads();  // sM, sL and sAcc are reused by the next head chunk
  }
}

// Pass 2. One block per (slot, q head): the slot's partials in split
// order. Every split's (m, l) is read at once into shared memory and
// turned into a weight there, so the acc reads of all splits are
// independent loads; splits with l = 0 (empty) get weight 0 and their acc
// is not read. Shared memory: 3 * nsplit floats.
template <typename T>
__global__ void paged_decode_merge_kernel(const float* __restrict__ ws_acc,
                                          const float* __restrict__ ws_ml,
                                          T* __restrict__ o, int H, int KV,
                                          int Dh, int nsplit) {
  extern __shared__ float smerge[];
  float* sm = smerge;               // [nsplit] running max, log2 units
  float* sl = sm + nsplit;          // [nsplit] running sum, 0 if empty
  float* sw = sl + nsplit;          // [nsplit] weight exp2(m - M)
  const int b = blockIdx.x / H, h = blockIdx.x % H, G = H / KV;
  const int64_t row0 = (int64_t)(b * KV + h / G) * nsplit * G + h % G;
  for (int s = threadIdx.x; s < nsplit; s += blockDim.x) {
    const int64_t r = row0 + (int64_t)s * G;
    const float l = ws_ml[2 * r + 1];
    sl[s] = l > 0.f ? l : 0.f;
    sm[s] = l > 0.f ? ws_ml[2 * r] : NEG_INF;
  }
  __syncthreads();
  float M = NEG_INF;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, sm[s]);
  for (int s = threadIdx.x; s < nsplit; s += blockDim.x)
    sw[s] = exp2f(sm[s] - M);
  __syncthreads();
  float Ls = 0.f;
  for (int s = 0; s < nsplit; ++s)
    if (sl[s] > 0.f) Ls = fmaf(sw[s], sl[s], Ls);
  for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
    float A = 0.f;
#pragma unroll 8
    for (int s = 0; s < nsplit; ++s)
      if (sl[s] > 0.f)
        A = fmaf(sw[s], ws_acc[(row0 + (int64_t)s * G) * Dh + d], A);
    o[((int64_t)b * H + h) * Dh + d] = from_f<T>(A / fmaxf(Ls, 1e-30f));
  }
}

int group_chunk(int G) { return G <= 1 ? 1 : G <= 4 ? 4 : 8; }

template <typename T, int DH, int GC>
cudaError_t launch_decode(const void* q, const void* kp, const void* vp,
                          const void* page_table, const void* pos, void* o,
                          void* ws_acc, void* ws_ml, int B, int H, int KV,
                          int ps, int P, int nsplit, int pages_per_split,
                          int rolling, float scale, cudaStream_t stream) {
  const dim3 grid(KV, B, nsplit);
  cudaError_t err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    static bool smem_set = false;  // bf16: tensor cores, every G
    const size_t smem = dec_mma_smem_bytes(DH);
    err = allow_smem(paged_decode_mma_kernel<DH>, smem, &smem_set);
    if (err != cudaSuccess) return err;
    paged_decode_mma_kernel<DH><<<grid, DEC_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp),
        static_cast<const T*>(vp), static_cast<const int32_t*>(page_table),
        static_cast<const int32_t*>(pos), static_cast<T*>(o),
        static_cast<float*>(ws_acc), static_cast<float*>(ws_ml), H, KV, ps,
        P, pages_per_split, rolling, scale * LOG2E);
  } else {
    static bool smem_set = false;  // fp32: CUDA cores
    const size_t smem = dec_smem_bytes(DH, GC);
    err = allow_smem(paged_decode_split_kernel<T, DH, GC>, smem, &smem_set);
    if (err != cudaSuccess) return err;
    paged_decode_split_kernel<T, DH, GC><<<grid, DEC_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp),
        static_cast<const T*>(vp), static_cast<const int32_t*>(page_table),
        static_cast<const int32_t*>(pos), static_cast<T*>(o),
        static_cast<float*>(ws_acc), static_cast<float*>(ws_ml), H, KV, ps,
        P, pages_per_split, rolling, scale * LOG2E);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  paged_decode_merge_kernel<T><<<B * H, DH < 128 ? DH : 128,
                                 3 * nsplit * sizeof(float), stream>>>(
      static_cast<const float*>(ws_acc), static_cast<const float*>(ws_ml),
      static_cast<T*>(o), H, KV, DH, nsplit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_decode(int Dh, int G, const void* q, const void* kp,
                            const void* vp, const void* page_table,
                            const void* pos, void* o, void* ws_acc,
                            void* ws_ml, int B, int H, int KV, int ps, int P,
                            int nsplit, int pages_per_split, int rolling,
                            float scale, cudaStream_t stream) {
#define DECODE_GC(D, C)                                                      \
  case C:                                                                    \
    return launch_decode<T, D, C>(q, kp, vp, page_table, pos, o, ws_acc,     \
                                  ws_ml, B, H, KV, ps, P, nsplit,            \
                                  pages_per_split, rolling, scale, stream);
#define DECODE_CASE(D)             \
  case D:                          \
    switch (group_chunk(G)) {      \
      DECODE_GC(D, 1)              \
      DECODE_GC(D, 4)              \
      DECODE_GC(D, 8)              \
      default:                     \
        return cudaErrorInvalidValue; \
    }
  switch (Dh) {
    DECODE_CASE(16)
    DECODE_CASE(32)
    DECODE_CASE(64)
    DECODE_CASE(128)
    DECODE_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef DECODE_CASE
#undef DECODE_GC
}

}  // namespace

extern "C" {

// q [B,T,H,Dh], k/v [B,S,KV,Dh], o [B,T,H,Dh]; all contiguous, one dtype;
// bf16 pointers 16-byte aligned (TMA).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int T, int S, int H, int KV, int Dh,
                        int causal, int window, int q_offset, float scale,
                        int dtype, void* stream) {
  return (int)dispatch_flash(dtype, Dh, q, k, v, o, B, T, S, H, KV, causal,
                             window, q_offset, scale,
                             static_cast<cudaStream_t>(stream));
}

// q [B,H,Dh], k/v pages [NP,ps,KV,Dh], page_table int32 [B,P],
// pos int32 [B], o [B,H,Dh]; all contiguous. With nsplit > 1, ws_acc
// fp32 [B,KV,nsplit,G,Dh] and ws_ml fp32 [B,KV,nsplit,G,2] hold the
// partials (unused, may be null, with one split).
int paged_decode_fwd(const void* q, const void* k_pages, const void* v_pages,
                     const void* page_table, const void* pos, void* o,
                     void* ws_acc, void* ws_ml, int B, int H, int KV, int Dh,
                     int ps, int P, int nsplit, int pages_per_split,
                     int rolling, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
  cudaError_t err =
      dtype == 0 ? dispatch_decode<float>(
                       Dh, G, q, k_pages, v_pages, page_table, pos, o, ws_acc,
                       ws_ml, B, H, KV, ps, P, nsplit, pages_per_split,
                       rolling, scale, st)
      : dtype == 1
          ? dispatch_decode<__nv_bfloat16>(
                Dh, G, q, k_pages, v_pages, page_table, pos, o, ws_acc, ws_ml,
                B, H, KV, ps, P, nsplit, pages_per_split, rolling, scale, st)
          : cudaErrorInvalidValue;
  return (int)err;
}

// shared memory a pass-1 decode block needs (the wrapper refuses > 227 KB)
size_t paged_decode_smem_bytes(int G, int Dh) {
  // the larger of the two pass-1 forms' (fp32 CUDA cores, bf16 mma)
  const size_t a = dec_smem_bytes(Dh, group_chunk(G));
  const size_t b = dec_mma_smem_bytes(Dh);
  return a > b ? a : b;
}

}  // extern "C"
