// Hand-written Hopper (sm_90a) kernels for the Adasum combine of the
// training step: per-block dot triples and the per-block scale-add. Plain
// C entry points, loaded with ctypes by repro_torch/kernels/build.py; each
// returns cudaGetLastError() after its launch. Operands are float32 (dtype
// 0) or bfloat16 (dtype 1); all arithmetic is fp32. The plain PyTorch
// versions live beside the wrappers in repro_torch/kernels/adasum.py.
//
// Operands are `rows` pairs of rows of L elements: row r of a starts at
// a + r*stride and row r of b at b + r*stride. A fused bucket buffer
// [2p, L] gives a = buf, b = buf + L, stride = 2L, so a tree level reads
// its lane pairs in place (the reference gathers each half into a copy,
// combine.py:274-276, which would double the level's traffic). Kernel
// blocks run row-major: block (r, c) covers elements [c*be, (c+1)*be) of
// row r, be = block_elems, a multiple of 256 that divides L.
//
// ---------------------------------------------------------------------------
// adasum_block_dots replaces `_dots_kernel` / `block_dots` in
// src/repro/kernels/adasum_dots.py (pallas_call at :77).
//   Bound on an H100: bytes. 6 FLOP per element pair against 2*itemsize
//   bytes read, far below the ~295 FLOP/byte ridge: reading both operands
//   once is the whole cost. The gemma-7b embedding bucket (786.4 M fp32
//   elements per operand) reads 6.29 GB, 1.88 ms at 3.35 TB/s.
//   Design: one thread block of 256 threads per kernel block (grid x =
//   block, grid y = row). Each thread reads 16 bytes of each operand per
//   load (4 fp32 or 8 bf16), accumulates [a.b, a.a, b.b] in fp32
//   registers, then the block reduces by warp shuffles and a shared-memory
//   pass over the 8 warps, and thread 0 writes the block's triple. No
//   atomics: the summation order is fixed, so two runs give bitwise-equal
//   triples (the per-segment sum over blocks is an order-fixed pass in
//   PyTorch). The TPU kernel's (rows, 128) lane view has no counterpart.
//
// adasum_block_combine replaces `_combine_kernel` / `block_combine` in
// src/repro/kernels/adasum_combine.py (pallas_call at :48).
//   Bound on an H100: bytes. Reads 2n and writes n elements (3 FLOP per
//   element): the embedding bucket moves 9.44 GB, 2.82 ms at 3.35 TB/s.
//   Design: an elementwise grid-stride pass; each thread takes one 16-byte
//   vector of a and of b (a vector never crosses a kernel block), reads
//   its block's two fp32 scalars, computes s1*a + s2*b in fp32 and casts
//   once to the operand dtype (round to nearest even), as the TPU kernel
//   does. The output is a contiguous [rows, L] buffer: the next level's
//   input.
// ---------------------------------------------------------------------------
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GRANULE = 256;  // block_elems granule (the wrapper checks it)

// 16-byte vectors: 4 fp32 or 8 bf16 elements
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const uint4& u, float* x) {
    x[0] = __uint_as_float(u.x);
    x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z);
    x[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 store(const float* x) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                      __float_as_uint(x[2]), __float_as_uint(x[3]));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const uint4& u, float* x) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      x[2 * k] = f.x;
      x[2 * k + 1] = f.y;
    }
  }
  __device__ __forceinline__ static uint4 store(const float* x) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
    return u;
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
    block_dots_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      float* __restrict__ out, int64_t stride,
                      int block_elems) {
  constexpr int N = Vec<T>::N;
  const int nblk = gridDim.x;
  const int64_t row = blockIdx.y;
  const int64_t base = row * stride + (int64_t)blockIdx.x * block_elems;
  const uint4* av = reinterpret_cast<const uint4*>(a + base);
  const uint4* bv = reinterpret_cast<const uint4*>(b + base);
  const int nvec = block_elems / N;
  float ab = 0.f, aa = 0.f, bb = 0.f;
  for (int i = threadIdx.x; i < nvec; i += THREADS) {
    float x[N], y[N];
    Vec<T>::load(__ldg(av + i), x);
    Vec<T>::load(__ldg(bv + i), y);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      ab = fmaf(x[k], y[k], ab);
      aa = fmaf(x[k], x[k], aa);
      bb = fmaf(y[k], y[k], bb);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ab += __shfl_xor_sync(0xffffffffu, ab, off);
    aa += __shfl_xor_sync(0xffffffffu, aa, off);
    bb += __shfl_xor_sync(0xffffffffu, bb, off);
  }
  __shared__ float part[WARPS][3];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    part[warp][0] = ab;
    part[warp][1] = aa;
    part[warp][2] = bb;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      s0 += part[w][0];
      s1 += part[w][1];
      s2 += part[w][2];
    }
    float* o = out + (row * nblk + blockIdx.x) * 3;
    o[0] = s0;
    o[1] = s1;
    o[2] = s2;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    block_combine_kernel(const T* __restrict__ a, const T* __restrict__ b,
                         const float* __restrict__ s1b,
                         const float* __restrict__ s2b, T* __restrict__ out,
                         int64_t stride, uint32_t L, uint32_t block_elems) {
  constexpr int N = Vec<T>::N;
  const int64_t row = blockIdx.y;
  const uint32_t nvec = L / N;
  const uint32_t nblk = L / block_elems;
  const uint4* av = reinterpret_cast<const uint4*>(a + row * stride);
  const uint4* bv = reinterpret_cast<const uint4*>(b + row * stride);
  uint4* ov = reinterpret_cast<uint4*>(out + row * (int64_t)L);
  const float* s1r = s1b + row * nblk;
  const float* s2r = s2b + row * nblk;
  for (uint32_t i = blockIdx.x * THREADS + threadIdx.x; i < nvec;
       i += gridDim.x * THREADS) {
    const uint32_t blk = (i * N) / block_elems;
    const float s1 = __ldg(s1r + blk), s2 = __ldg(s2r + blk);
    float x[N], y[N], z[N];
    Vec<T>::load(__ldg(av + i), x);
    Vec<T>::load(__ldg(bv + i), y);
#pragma unroll
    for (int k = 0; k < N; ++k) z[k] = fmaf(s1, x[k], s2 * y[k]);
    ov[i] = Vec<T>::store(z);
  }
}

template <typename T>
cudaError_t launch_dots(const void* a, const void* b, void* out, int rows,
                        int64_t L, int64_t stride, int block_elems,
                        cudaStream_t st) {
  if (rows <= 0 || rows > 65535 || block_elems <= 0 ||
      block_elems % GRANULE != 0 || L <= 0 || L % block_elems != 0 ||
      L / block_elems > 0x7fffffff)
    return cudaErrorInvalidValue;
  const int64_t nblk = L / block_elems;
  dim3 grid((unsigned)nblk, (unsigned)rows);
  block_dots_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<float*>(out), stride, block_elems);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_combine(const void* a, const void* b, const void* s1b,
                           const void* s2b, void* out, int rows, int64_t L,
                           int64_t stride, int block_elems,
                           cudaStream_t st) {
  if (rows <= 0 || rows > 65535 || L <= 0 || L >= (int64_t(1) << 31) ||
      block_elems <= 0 || L % block_elems != 0 ||
      block_elems % GRANULE != 0)
    return cudaErrorInvalidValue;
  const int64_t nvec = L / Vec<T>::N;
  // enough blocks to cover 16 waves of 132 SMs; the loop strides the rest
  const int64_t want = (nvec + THREADS - 1) / THREADS;
  const unsigned gx = (unsigned)(want < 132 * 16 ? want : 132 * 16);
  dim3 grid(gx, (unsigned)rows);
  block_combine_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(s1b), static_cast<const float*>(s2b),
      static_cast<T*>(out), stride, (uint32_t)L, (uint32_t)block_elems);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a/b: rows x L elements at row stride `stride` (elements); out: fp32
// [rows * (L / block_elems), 3], row-major over (row, block).
int adasum_block_dots(const void* a, const void* b, void* out, int rows,
                      long long L, long long stride, int block_elems,
                      int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? launch_dots<float>(a, b, out, rows, L, stride,
                                      block_elems, st)
      : dtype == 1 ? launch_dots<__nv_bfloat16>(a, b, out, rows, L, stride,
                                                block_elems, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}

// a/b as above; s1b/s2b: fp32 [rows * (L / block_elems)]; out: contiguous
// [rows, L] in the operand dtype.
int adasum_block_combine(const void* a, const void* b, const void* s1b,
                         const void* s2b, void* out, int rows, long long L,
                         long long stride, int block_elems, int dtype,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? launch_combine<float>(a, b, s1b, s2b, out, rows, L,
                                         stride, block_elems, st)
      : dtype == 1 ? launch_combine<__nv_bfloat16>(a, b, s1b, s2b, out, rows,
                                                   L, stride, block_elems, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
