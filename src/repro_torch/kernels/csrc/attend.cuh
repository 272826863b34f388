// Shared CUDA-core body of the port's decode-shaped attention kernels
// where the tensor cores would miss the tolerance: q in fp32 for
// contiguous decode and for paged decode and paged multi-token verify over
// fp32 or int8 pages (fp32 FMAs hold the 1e-4 fp32 tolerance that bf16 or
// TF32 tensor-core inputs would not).  The bf16 paths run elsewhere:
// decode over bf16 caches and bf16 or int8 pools on decode_mma.cuh, verify
// on attend_mma.cuh.  One block per (kv head, batch row, tile of at most
// kMaxRows query rows) attends those query rows to the row's KV, which it
// walks in 64-position chunks with an online softmax in fp32.
//
// What bounds these kernels on the H100: each K/V element is read once and
// used for 2 * rows operations (rows = K * rep query rows share it: 1 * 4
// for qwen3-8b decode, 5 * 4 for its verify), a few operations per byte,
// so the bytes of the KV they read bound them (3.35 TB/s).  The design
// reads each element once per tile: the rows of a kv head's group share
// every staged chunk, so K/V are never re-read per query head or per
// verify token (a verify of more than kMaxRows rows reads them once per
// tile), and a tile walks only the positions one of its queries can see.
// It stages fp32 with synchronous loads behind four barriers a chunk and
// never splits a row across blocks, so it reaches only 15-25% of that
// bound on long rows (PERF.md, the kernel table); the tensor-core bodies
// replace it where the dtype allows.
//
// Where K/V come from (the Src policy): FpKv reads K/V of the q type with
// 16-byte loads; Int8Kv reads int8 K/V, 16 values per 16-byte load, and
// multiplies each by the bf16 scale of its (position, kv head), reached
// through the same slot index, into the fp32 shared tiles -- as the TPU
// body dequantizes to fp32 -- so masking, the dead-block rule and the
// table trap are the same code for fp and int8 pages.
//
// Layout and masking:
// * q and out are (B, K, H, D).  Query row r of a row's K * rep is (token
//   j = r / rep, head g * rep + r % rep), rep = H / Hkv; tile z takes rows
//   [z * kMaxRows, min((z + 1) * kMaxRows, K * rep)).
// * Row b's query j sees positions [lo, hi_j): lo = max(0, len - window)
//   with a window, else 0; hi_j = min(len + j + extra, n), len = lengths[b],
//   n = the positions the row's KV has (S, or maxp * page).  extra is 0 for
//   decode (positions < len) and 1 for verify (positions <= len + j).
// * Masked positions take the finite -1e30 of the plain versions, positions
//   outside the walk -inf, and l is floored at 1e-30.  When no query of the
//   block sees a key (a decode row of length 0, or a window past the cache)
//   the block walks all n positions at -1e30 and returns the mean of V, as
//   the plain version does; it reads no K then.  With len >= 0 a verify
//   block always has a visible key, so no block mixes rows with and without.

#pragma once

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kChunk = 64;     // key positions staged per step
constexpr int kThreads = 128;

// A row's KV as a contiguous cache (B, S, Hkv, D).
struct ContiguousKv {
  int S;
  __device__ __forceinline__ int positions() const { return S; }
  // index of position `pos` of row `b` along the (B*S) or (P*page) axis
  __device__ __forceinline__ size_t slot(int b, int pos) const { return (size_t)b * S + pos; }
};

// A row's KV in a page pool (P, page, Hkv, D) reached through its block
// table (B, maxp).  JAX clamps an out-of-range gather, CUDA would read
// outside the pool: an entry outside [0, P) traps (a device-side assert).
struct PagedKv {
  const int* __restrict__ block_tables;
  int page, maxp, P;
  __device__ __forceinline__ int positions() const { return maxp * page; }
  __device__ __forceinline__ size_t slot(int b, int pos) const {
    const int lp = pos / page;
    const int phys = block_tables[(size_t)b * maxp + lp];
    if (phys < 0 || phys >= P) __trap();
    return (size_t)phys * page + (pos - lp * page);
  }
  // slot() of position lp * page + off (0 <= off < page), for a caller
  // that walks the pages itself instead of dividing by page per position
  __device__ __forceinline__ size_t slot_at(int b, int lp, int off) const {
    const int phys = block_tables[(size_t)b * maxp + lp];
    if (phys < 0 || phys >= P) __trap();
    return (size_t)phys * page + off;
  }
};

// K/V of the q type T, read 16 bytes at a time.  `off` indexes elements
// of the (..., Hkv, D) pool or cache; `entry` (the (position, kv head)
// index) is unused.
template <typename T>
struct FpKv {
  const T* __restrict__ k;
  const T* __restrict__ v;
  static constexpr int kVec = Elem<T>::kVec;
  __device__ __forceinline__ void load_k(size_t, size_t off, float* dst) const {
    Elem<T>::load_vec(k + off, dst);
  }
  __device__ __forceinline__ void load_v(size_t, size_t off, float* dst) const {
    Elem<T>::load_vec(v + off, dst);
  }
};

// int8 K/V pools with bf16 scale pools (..., Hkv, 1): element `off` of the
// pool times the scale at `entry`, in fp32 (kv_dequantize's arithmetic).
// A never-written entry has zero values and a zero scale and reads as 0.
struct Int8Kv {
  const int8_t* __restrict__ k;
  const int8_t* __restrict__ v;
  const __nv_bfloat16* __restrict__ k_scale;
  const __nv_bfloat16* __restrict__ v_scale;
  static constexpr int kVec = 16;   // int8 values per 16-byte load
  __device__ static __forceinline__ void load16(const int8_t* src, float s, float* dst) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[i] = static_cast<float>(b[i]) * s;
  }
  __device__ __forceinline__ void load_k(size_t entry, size_t off, float* dst) const {
    load16(k + off, __bfloat162float(k_scale[entry]), dst);
  }
  __device__ __forceinline__ void load_v(size_t entry, size_t off, float* dst) const {
    load16(v + off, __bfloat162float(v_scale[entry]), dst);
  }
};

template <int D>
size_t attend_smem_bytes(int rows) {
  return sizeof(float) * ((size_t)rows * D + kChunk * (D + 1) + kChunk * D + rows * kChunk + 3 * rows);
}

template <typename T, int D, int kMaxRows, class Kv, class Src>
__global__ void __launch_bounds__(kThreads)
attend_kernel(const T* __restrict__ q, Src src, const int* __restrict__ lengths,
              T* __restrict__ out, int H, int Hkv, int K, int extra, int window, float scale,
              Kv kv) {
  extern __shared__ float smem[];
  const int rep = H / Hkv;
  const int row0 = blockIdx.z * kMaxRows;  // this tile's first query row
  const int rows = min(K * rep - row0, kMaxRows);
  float* sQ = smem;                        // rows x D
  float* sK = sQ + rows * D;               // kChunk x (D+1)
  float* sV = sK + kChunk * (D + 1);       // kChunk x D
  float* sS = sV + kChunk * D;             // rows x kChunk: scores, then weights
  float* sM = sS + rows * kChunk;          // rows: running max
  float* sL = sM + rows;                   // rows: running sum
  float* sA = sL + rows;                   // rows: this step's rescale
  constexpr int kQVec = Elem<T>::kVec;     // q elements per 16-byte load
  constexpr int kQVecPerRow = D / kQVec;
  constexpr int kKvVec = Src::kVec;        // K/V elements per 16-byte load
  constexpr int kKvVecPerRow = D / kKvVec;
  // output columns: a thread owns column tid % D of every kRowStride-th
  // row (D <= kThreads), or columns tid, tid + kThreads, ... of every row
  constexpr int kColGroups = D > kThreads ? D / kThreads : 1;
  constexpr int kRowStride = kThreads * kColGroups / D;  // rows apart per thread
  constexpr int kAcc = (kMaxRows + kRowStride - 1) / kRowStride;
  static_assert(D % kThreads == 0 || kThreads % D == 0, "columns a thread");

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = kv.positions();
  const int len = lengths[b];
  const int lo = window > 0 ? max(0, len - window) : 0;
  // the tile's last query's end (its last row's token)
  const int hi_last = min(len + (row0 + rows - 1) / rep + extra, n);
  const bool dead = hi_last <= lo;         // no query sees a key
  const int w_lo = dead ? 0 : lo;
  const int w_hi = dead ? n : hi_last;

  for (int i = tid; i < rows * kQVecPerRow; i += kThreads) {
    const int r = i / kQVecPerRow;
    const int rg = row0 + r;
    const int c = (i % kQVecPerRow) * kQVec;
    Elem<T>::load_vec(q + (((size_t)b * K + rg / rep) * H + g * rep + rg % rep) * D + c,
                      sQ + r * D + c);
  }
  for (int r = tid; r < rows; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }
  const int dcol = tid % (D / kColGroups);
  const int rsub = tid / (D / kColGroups);
  float acc[kAcc][kColGroups];
#pragma unroll
  for (int j = 0; j < kAcc; ++j)
#pragma unroll
    for (int cg = 0; cg < kColGroups; ++cg) acc[j][cg] = 0.f;

  for (int c0 = (w_lo / kChunk) * kChunk; c0 < w_hi; c0 += kChunk) {
    __syncthreads();                       // previous step fully consumed
    for (int i = tid; i < kChunk * kKvVecPerRow; i += kThreads) {
      const int r = i / kKvVecPerRow;
      const int c = (i % kKvVecPerRow) * kKvVec;
      const int pos = c0 + r;
      float* dk = sK + r * (D + 1) + c;
      float* dv = sV + r * D + c;
      if (pos >= w_lo && pos < w_hi) {
        const size_t entry = kv.slot(b, pos) * Hkv + g;
        const size_t off = entry * D + c;
        if (!dead) {                       // a block without a key scores none
          float tmp[kKvVec];
          src.load_k(entry, off, tmp);
#pragma unroll
          for (int j = 0; j < kKvVec; ++j) dk[j] = tmp[j];
        }
        src.load_v(entry, off, dv);
      } else {
#pragma unroll
        for (int j = 0; j < kKvVec; ++j) { dk[j] = 0.f; dv[j] = 0.f; }
      }
    }
    __syncthreads();

    for (int e = tid; e < rows * kChunk; e += kThreads) {
      const int r = e / kChunk;
      const int kk = e % kChunk;
      const int pos = c0 + kk;
      float s;
      if (pos < w_lo || pos >= w_hi) {
        s = neg_inf();
      } else if (dead || pos >= min(len + (row0 + r) / rep + extra, n)) {
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

    for (int r = warp; r < rows; r += kThreads / 32) {
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
      if (r < rows) {
#pragma unroll
        for (int cg = 0; cg < kColGroups; ++cg) {
          const int col = dcol + cg * kThreads;
          float x = acc[j][cg] * sA[r];
#pragma unroll 8
          for (int kk = 0; kk < kChunk; ++kk) x = fmaf(sS[r * kChunk + kk], sV[kk * D + col], x);
          acc[j][cg] = x;
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int r = rsub + j * kRowStride;
    if (r < rows) {
      const int rg = row0 + r;
      T* o = out + (((size_t)b * K + rg / rep) * H + g * rep + rg % rep) * D;
#pragma unroll
      for (int cg = 0; cg < kColGroups; ++cg)
        o[dcol + cg * kThreads] = Elem<T>::store(acc[j][cg] / fmaxf(sL[r], 1e-30f));
    }
  }
}

// Launch attend_kernel on a (Hkv, B, ceil(K * rep / kMaxRows)) grid.
// Returns the CUDA error of the launch (0 on success).
template <typename T, int D, int kMaxRows, class Kv, class Src>
int launch_attend(const void* q, Src src, const int* lengths, void* out, int B, int H, int Hkv,
                  int K, int extra, int window, float scale, Kv kv, int device,
                  cudaStream_t stream) {
  static bool smem_allowed[kMaxDevices] = {};
  const cudaError_t e = allow_smem_once(attend_kernel<T, D, kMaxRows, Kv, Src>,
                                        attend_smem_bytes<D>(kMaxRows), device, smem_allowed);
  if (e != cudaSuccess) return (int)e;
  const int total = K * (H / Hkv);
  const int tiles = (total + kMaxRows - 1) / kMaxRows;
  const size_t smem = attend_smem_bytes<D>(total < kMaxRows ? total : kMaxRows);
  attend_kernel<T, D, kMaxRows, Kv, Src><<<dim3(Hkv, B, tiles), kThreads, smem, stream>>>(
      static_cast<const T*>(q), src, lengths, static_cast<T*>(out), H, Hkv, K, extra, window,
      scale, kv);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch
