// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_decode.py ·
// flash_paged_decode_tpu (wrapper _paged_attention, body _paged_kernel with
// quant=False): one query token per row attends to the row's KV, which lives
// in a shared pool of fixed-size pages (P, page, Hkv, D) reached through the
// row's block table (B, maxp); positions k < lengths[b] are valid.
//
// What bounds it on this card: every valid K/V element is read once and used
// for 2 * rep operations (rep = H / Hkv query heads share it), about 4
// operations per bf16 byte, far below the H100's ~295, so it is bound by
// the bytes of the pages it reads (3.35 TB/s).  The design keeps each
// element's traffic to one read: the rep query heads of a kv head share a
// block, so K/V are never re-read per query head, and a row walks only the
// pages its length covers, not the table's full width.
//
// Design:
// * One block per (kv head, batch row), 128 threads.  The block reads the
//   row's block-table entries itself (the TPU kernel prefetched them as
//   scalars) and stages 64 key positions at a time into shared memory with
//   16-byte loads, resolving each position's page through the table.
// * Scores for the rep heads x 64 keys, then one warp per head updates the
//   running max / sum (online softmax in fp32), then each thread
//   accumulates its (head, column) outputs over the 64 keys.
// * Masking matches the plain version: positions past lengths[b] take no
//   weight; a row of length 0 has no valid key and averages V over every
//   position of its table (maxp * page, pad entries on the scratch page 0
//   included), as the gather-then-softmax plain version does; it reads V
//   only.  l is floored at 1e-30.
// * Built for head width 128 (kHeadDim) in fp32 and bf16, and up to 16
//   query heads per kv head.
// * A table entry outside [0, P) would read outside the pool: the kernel
//   checks every entry it reads and traps (a device-side assert) instead.
// * Splitting a long row across blocks (flash-decoding) is later work.

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kChunk = 64;     // key positions staged per step
constexpr int kThreads = 128;
constexpr int kMaxRep = 16;    // query heads per kv head this kernel takes

template <int D>
size_t paged_smem_bytes(int rep) {
  return sizeof(float) * ((size_t)rep * D + kChunk * (D + 1) + kChunk * D + rep * kChunk + 3 * rep);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ block_tables,
                    const int* __restrict__ lengths, T* __restrict__ out, int H, int Hkv,
                    int page, int maxp, int P, float scale) {
  extern __shared__ float smem[];
  const int rep = H / Hkv;
  float* sQ = smem;                        // rep x D
  float* sK = sQ + rep * D;                // kChunk x (D+1)
  float* sV = sK + kChunk * (D + 1);       // kChunk x D
  float* sS = sV + kChunk * D;             // rep x kChunk: scores, then weights
  float* sM = sS + rep * kChunk;           // rep: running max
  float* sL = sM + rep;                    // rep: running sum
  float* sA = sL + rep;                    // rep: this step's rescale
  constexpr int kVec = Elem<T>::kVec;
  constexpr int kVecPerRow = D / kVec;
  constexpr int kRowStride = kThreads / D; // heads apart per thread
  constexpr int kAcc = (kMaxRep + kRowStride - 1) / kRowStride;

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* bt = block_tables + (size_t)b * maxp;
  const int cap = maxp * page;
  const int len = lengths[b];
  const bool dead = len <= 0;              // no valid key: average all of V
  const int n = dead ? cap : min(len, cap);

  for (int i = tid; i < rep * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    Elem<T>::load_vec(q + ((size_t)b * H + g * rep + r) * D + c, sQ + r * D + c);
  }
  if (tid < rep) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  const int dcol = tid % D;
  const int rsub = tid / D;
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < n; c0 += kChunk) {
    __syncthreads();                       // previous step fully consumed
    for (int i = tid; i < kChunk * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * kVec;
      const int pos = c0 + r;
      float* dk = sK + r * (D + 1) + c;
      float* dv = sV + r * D + c;
      if (pos < n) {
        const int lp = pos / page;
        const int phys = bt[lp];
        if (phys < 0 || phys >= P) __trap();
        const size_t off = (((size_t)phys * page + (pos - lp * page)) * Hkv + g) * D + c;
        if (!dead) {                       // a length-0 row scores no key
          float tmp[kVec];
          Elem<T>::load_vec(k_pool + off, tmp);
#pragma unroll
          for (int j = 0; j < kVec; ++j) dk[j] = tmp[j];
        }
        Elem<T>::load_vec(v_pool + off, dv);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) { dk[j] = 0.f; dv[j] = 0.f; }
      }
    }
    __syncthreads();

    for (int e = tid; e < rep * kChunk; e += kThreads) {
      const int r = e / kChunk;
      const int kk = e % kChunk;
      float s;
      if (c0 + kk >= n) {
        s = neg_inf();
      } else if (dead) {
        s = kNegInf;
      } else {
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(sQ[r * D + d], sK[kk * (D + 1) + d], dot);
        s = dot * scale;
      }
      sS[r * kChunk + kk] = s;
    }
    __syncthreads();

    for (int r = warp; r < rep; r += kThreads / 32) {
      const float s0 = sS[r * kChunk + lane];
      const float s1 = sS[r * kChunk + lane + 32];
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      sS[r * kChunk + lane] = p0;
      sS[r * kChunk + lane + 32] = p1;
      const float ps = warp_sum(p0 + p1);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        sA[r] = a;
        sL[r] = sL[r] * a + ps;
        sM[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int r = rsub + j * kRowStride;
      if (r < rep) {
        float x = acc[j] * sA[r];
#pragma unroll 8
        for (int kk = 0; kk < kChunk; ++kk) x = fmaf(sS[r * kChunk + kk], sV[kk * D + dcol], x);
        acc[j] = x;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int r = rsub + j * kRowStride;
    if (r < rep) {
      out[((size_t)b * H + g * rep + r) * D + dcol] = Elem<T>::store(acc[j] / fmaxf(sL[r], 1e-30f));
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k_pool, const void* v_pool, const int* block_tables,
           const int* lengths, void* out, int B, int H, int Hkv, int page, int maxp, int P,
           float scale, int device, cudaStream_t stream) {
  static bool smem_allowed[kMaxDevices] = {};
  const cudaError_t e = allow_smem_once(paged_decode_kernel<T, D>,
                                        paged_smem_bytes<D>(kMaxRep), device, smem_allowed);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = paged_smem_bytes<D>(H / Hkv);
  const dim3 grid(Hkv, B);
  paged_decode_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      block_tables, lengths, static_cast<T*>(out), H, Hkv, page, maxp, P, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16.  D must be kHeadDim.  block_tables
// (B, maxp) and lengths (B,) are int32.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int paged_decode_fwd(const void* q, const void* k_pool, const void* v_pool,
                                const void* block_tables, const void* lengths, void* out,
                                int dtype, int B, int H, int Hkv, int D, int page, int maxp,
                                int P, float scale, int device, void* stream) {
  using namespace repro_torch;
  if (D != kHeadDim || H % Hkv != 0 || H / Hkv > kMaxRep || page < 1 || maxp < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  if (dtype == 0)
    return launch<float, kHeadDim>(q, k_pool, v_pool, bt, ln, out, B, H, Hkv, page, maxp, P,
                                   scale, device, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, kHeadDim>(q, k_pool, v_pool, bt, ln, out, B, H, Hkv, page,
                                           maxp, P, scale, device, st);
  return (int)cudaErrorInvalidValue;
}
