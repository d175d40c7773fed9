// Hand-written Hopper (sm_90a) kernels for the serving path's attention:
// flash prefill and paged decode. Plain C entry points, loaded with ctypes
// by repro_torch/kernels/build.py; each returns cudaGetLastError() after
// its launch. Inputs are float32 (dtype 0) or bfloat16 (dtype 1); every
// product, the online softmax (running max, sum, probabilities P) and the
// accumulator stay in fp32, as in the TPU kernels they replace. The plain
// PyTorch versions live beside the wrappers in
// repro_torch/kernels/flash_attention.py.
//
// ---------------------------------------------------------------------------
// flash_attention_fwd replaces `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py (pallas_call at :116).
//   Bound on an H100: operations. A 64x64 score tile costs 64*64*Dh*2 FLOP
//   for S and as much for P.V against 2*64*Dh input elements, far above the
//   card's ~295 FLOP/byte ridge; the causal prefill of B=4, T=S=1024, H=64,
//   Dh=128 needs 6.9e10 FLOP, 70 us at 989 TFLOP/s.
//   Design: one block per (64-row q tile, q head, batch row). The KV head is
//   h / G, read in place: the G-fold jnp.repeat of K/V the TPU wrapper
//   materialised (flash_attention.py:110-112) is gone. K and V tiles stream
//   through one shared buffer (K for S, then V for P.V), so two blocks fit
//   on an SM; the score tile never reaches device memory. The causal
//   frontier (and the window's lower edge) skip whole K tiles, offset by
//   q_offset for a prefix-extend prefill; ragged T/S edges are masked.
//   This first version multiplies in fp32 on the CUDA cores (no wgmma, no
//   TMA), so it runs far below the bound: tensor cores are later work.
//
// paged_decode_fwd replaces `_paged_decode_kernel` / `paged_decode_attention`
// in src/repro/kernels/flash_attention.py (pallas_call at :224).
//   Bound on an H100: bytes. Each K/V row is read once for G query heads
//   (4*G FLOP per element, far below the ridge): B=8 slots at 1024 rows,
//   KV=8, Dh=128 in bf16 read 33.5 MB, 10 us at 3.35 TB/s.
//   Design: the TPU ran the page axis as a sequential grid dimension with
//   the online softmax in VMEM scratch (:141-174); Hopper runs blocks in no
//   order, so one block per (KV head, slot) serves its G query heads and
//   loops over the slot's pages itself, reading each physical page id from
//   the page table and staging the [page_size, Dh] K/V page in shared
//   memory. The loop stops after the last page that holds a position
//   <= pos. Free slots point at trash page 0, which is read like any page;
//   its garbage stays in those slots' own (discarded) output rows.
//   With one block per (KV head, slot) few SMs are busy at small batch:
//   splitting a slot across blocks is later work.
// ---------------------------------------------------------------------------
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;  // the TPU kernels' mask value

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

// ------------------------------------------------------------ flash prefill
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
  const size_t smem = FlashTile<DH>::smem_bytes;  // above the 48 KB default
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DH><<<grid, FLASH_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Tq, S, H, KV, causal,
      window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_flash(int Dh, const void* q, const void* k,
                           const void* v, void* o, int B, int Tq, int S,
                           int H, int KV, int causal, int window,
                           int q_offset, float scale, cudaStream_t stream) {
#define FLASH_CASE(D)                                                      \
  case D:                                                                  \
    return launch_flash<T, D>(q, k, v, o, B, Tq, S, H, KV, causal, window, \
                              q_offset, scale, stream);
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

// ------------------------------------------------------------- paged decode
constexpr int DEC_THREADS = 128;

template <typename T, int DH>
__global__ void __launch_bounds__(DEC_THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp,
                    const int32_t* __restrict__ page_table,
                    const int32_t* __restrict__ pos, T* __restrict__ o,
                    int H, int KV, int ps, int P, int rolling, float scale) {
  constexpr int LD = DH + 1;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  extern __shared__ float smem[];
  float* sQ = smem;              // [G][LD]  q * scale
  float* sK = sQ + G * LD;       // [ps][LD] this page's keys
  float* sV = sK + ps * LD;      // [ps][DH] this page's values
  float* sS = sV + ps * DH;      // [G][ps]  scores, then probabilities
  float* sAcc = sS + G * ps;     // [G][DH]  fp32 accumulator
  float* sM = sAcc + G * DH;     // [G] running max
  float* sL = sM + G;            // [G] running sum
  float* sAlpha = sL + G;        // [G] this page's rescale factor

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t qbase = ((int64_t)b * H + (int64_t)kvh * G) * DH;
  for (int i = tid; i < G * DH; i += DEC_THREADS) {
    sQ[(i / DH) * LD + i % DH] = to_f(q[qbase + i]) * scale;
    sAcc[i] = 0.f;
  }
  for (int g = tid; g < G; g += DEC_THREADS) {
    sM[g] = NEG_INF;
    sL[g] = 0.f;
  }

  const int p = pos[b];
  const int cap = P * ps;
  // rows 0..p hold positions <= p until the slot wraps (rolling) or
  // saturates (linear); after that every page does
  const int n_pages = p < cap ? p / ps + 1 : P;

  for (int i = 0; i < n_pages; ++i) {
    const int64_t pid = page_table[(int64_t)b * P + i];
    __syncthreads();  // the previous page is consumed
    for (int e = tid; e < ps * DH; e += DEC_THREADS) {
      const int r = e / DH, d = e % DH;
      const int64_t src = ((pid * ps + r) * KV + kvh) * DH + d;
      sK[r * LD + d] = to_f(kp[src]);
      sV[r * DH + d] = to_f(vp[src]);
    }
    __syncthreads();
    for (int e = tid; e < G * ps; e += DEC_THREADS) {
      const int g = e / ps, r = e % ps;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) s = fmaf(sQ[g * LD + d], sK[r * LD + d], s);
      const int row = i * ps + r;
      // rolling: the latest position p' <= p with p' % cap == row
      const int slot_pos =
          rolling ? p - (((p - row) % cap) + cap) % cap : row;
      sS[e] = (slot_pos >= 0 && slot_pos <= p) ? s : -INFINITY;
    }
    __syncthreads();
    for (int g = warp; g < G; g += DEC_THREADS / 32) {
      float mx = NEG_INF;
      for (int r = lane; r < ps; r += 32) mx = fmaxf(mx, sS[g * ps + r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < ps; r += 32) {
        const float pe = expf(sS[g * ps + r] - m_new);  // masked: exp(-inf)
        sS[g * ps + r] = pe;
        sum += pe;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sM[g] = m_new;
        sL[g] = sL[g] * alpha + sum;
        sAlpha[g] = alpha;
      }
    }
    __syncthreads();
    for (int e = tid; e < G * DH; e += DEC_THREADS) {
      const int g = e / DH, d = e % DH;
      float a = sAcc[e] * sAlpha[g];
      for (int r = 0; r < ps; ++r) a = fmaf(sS[g * ps + r], sV[r * DH + d], a);
      sAcc[e] = a;
    }
  }
  __syncthreads();
  for (int e = tid; e < G * DH; e += DEC_THREADS)
    o[qbase + e] = from_f<T>(sAcc[e] / fmaxf(sL[e / DH], 1e-30f));
}

size_t decode_smem_bytes(int G, int ps, int Dh) {
  return sizeof(float) * ((size_t)G * (Dh + 1) + (size_t)ps * (Dh + 1) +
                          (size_t)ps * Dh + (size_t)G * ps + (size_t)G * Dh +
                          3 * (size_t)G);
}

template <typename T, int DH>
cudaError_t launch_decode(const void* q, const void* kp, const void* vp,
                          const void* page_table, const void* pos, void* o,
                          int B, int H, int KV, int ps, int P, int rolling,
                          float scale, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes(H / KV, ps, DH);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(KV, B);
  paged_decode_kernel<T, DH><<<grid, DEC_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(pos), static_cast<T*>(o), H, KV, ps, P,
      rolling, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_decode(int Dh, const void* q, const void* kp,
                            const void* vp, const void* page_table,
                            const void* pos, void* o, int B, int H, int KV,
                            int ps, int P, int rolling, float scale,
                            cudaStream_t stream) {
#define DECODE_CASE(D)                                                    \
  case D:                                                                 \
    return launch_decode<T, D>(q, kp, vp, page_table, pos, o, B, H, KV, ps, \
                               P, rolling, scale, stream);
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
}

}  // namespace

extern "C" {

// q [B,T,H,Dh], k/v [B,S,KV,Dh], o [B,T,H,Dh]; all contiguous, one dtype.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int T, int S, int H, int KV, int Dh,
                        int causal, int window, int q_offset, float scale,
                        int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? dispatch_flash<float>(Dh, q, k, v, o, B, T, S, H, KV,
                                         causal, window, q_offset, scale, st)
      : dtype == 1
          ? dispatch_flash<__nv_bfloat16>(Dh, q, k, v, o, B, T, S, H, KV,
                                          causal, window, q_offset, scale, st)
          : cudaErrorInvalidValue;
  return (int)err;
}

// q [B,H,Dh], k/v pages [NP,ps,KV,Dh], page_table int32 [B,P],
// pos int32 [B], o [B,H,Dh]; all contiguous.
int paged_decode_fwd(const void* q, const void* k_pages, const void* v_pages,
                     const void* page_table, const void* pos, void* o, int B,
                     int H, int KV, int Dh, int ps, int P, int rolling,
                     float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0
          ? dispatch_decode<float>(Dh, q, k_pages, v_pages, page_table, pos,
                                   o, B, H, KV, ps, P, rolling, scale, st)
      : dtype == 1
          ? dispatch_decode<__nv_bfloat16>(Dh, q, k_pages, v_pages,
                                           page_table, pos, o, B, H, KV, ps,
                                           P, rolling, scale, st)
          : cudaErrorInvalidValue;
  return (int)err;
}

// shared memory a decode block needs (the wrapper refuses > 227 KB)
size_t paged_decode_smem_bytes(int G, int ps, int Dh) {
  return decode_smem_bytes(G, ps, Dh);
}

}  // extern "C"
