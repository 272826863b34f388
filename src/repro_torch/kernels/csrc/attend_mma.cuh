// The bf16 body of paged multi-token verify on the tensor cores
// (mma.sync.m16n8k16, bf16 in, fp32 accumulate), for q in bf16 over bf16
// or int8 page pools.  paged_verify.cu launches it for both entry points
// when q is bf16; q in fp32 stays on attend.cuh's CUDA-core body, whose
// fp32 FMAs hold the 1e-4 fp32 tolerance that bf16 or TF32 tensor-core
// inputs would not.
//
// What bounds it on the H100: the bytes of the pages it reads (a K/V
// element feeds 2 * rows operations, rows <= 32 a tile, far below the ~295
// per byte the card needs in bf16).  At the serve shapes (4 rows of ~28
// positions, 20 query rows a kv head) it is bound by latency: a handful of
// blocks, each a few chunk steps long.  So the design keeps the step short
// and the grid wide, and leaves the arithmetic to the tensor cores:
//
// * One block of 4 warps per (kv head, batch row, tile of kTileRows = 32
//   query rows).  32 rows, not 64, so that the prefix cache's warm prefill
//   (K = 32, rep 4: 128 rows a kv head) launches 4 tiles a (kv head, row):
//   128 blocks for 4 rows x 8 kv heads, where 64-row tiles gave 64 of the
//   132 SMs.  The spec path's K * rep = 20 rows fit one tile.
// * Warp w owns the 16-row slice w % 2 of the tile and the half w / 2 of
//   every 64-position chunk: the two warps of a slice split the chunk's
//   positions, keep their own (m, l, acc) in registers, and merge once at
//   the end through shared memory.  A slice past the tile's rows idles.
// * Each chunk of K and V (64 positions x D, bf16, rows swizzled so that
//   ldmatrix reads them without bank conflicts) is staged into shared
//   memory through the block table, double-buffered: bf16 pools by
//   cp.async straight from the pages; int8 pools through registers, each
//   int8 value times its bf16 scale in fp32 and rounded to bf16 -- the
//   values the plain version attends.  One __syncthreads per chunk.
// * Scores: Q fragments (ldmatrix, held in registers for the whole walk)
//   times K fragments (ldmatrix) in m16n8k16 MMAs; masking and the online
//   softmax run on the accumulator registers (quad shuffles for row max
//   and sum); P is rounded to bf16 in registers as the A fragment of the
//   PV MMAs, whose V fragments come from ldmatrix.trans.  The score matrix
//   never touches shared memory.
//
// Semantics are attend.cuh's for verify (extra = 1, no window): query j of
// row b sees positions <= lengths[b] + j, capped at n = maxp * page (a
// rider's lengths + K may pass its table); masked positions take -1e30,
// positions past the walk -inf, l is floored at 1e-30; a tile whose rows
// see no key (possible only for a negative length) walks all n positions
// and returns the mean of V; a table entry outside [0, P) traps.

#pragma once

#include <stdint.h>

#include "attend.cuh"

namespace repro_torch {
namespace mma {

constexpr int kTileRows = 32;          // query rows per block: 2 slices of 16
constexpr int kWarps = 4;              // 2 row slices x 2 position halves
constexpr int kBlock = kWarps * 32;
constexpr int kHalf = kChunk / 2;      // positions of a chunk per warp
constexpr float kLog2e = 1.4426950408889634f;

// 16-byte piece `c` of row `r` in a shared tile of D bf16 per row: the
// piece index is XORed with r % 8, so the 8 rows an ldmatrix reads at one
// logical piece land in 8 different bank groups.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * (D / 8) + (c ^ (r & 7));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&x)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&x)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(addr));
}

// c += a (16x16 bf16, row-major) * b (16x8 bf16, column-major), fp32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage one 64-position chunk [c0, c0 + 64) of bf16 K/V (a cache or a
// pool, through `kv`): each thread copies its 16-byte pieces of the
// positions in [a, e) into the stage with cp.async (K only when read_k),
// zeros elsewhere.  kFromA false takes a as 0 and compares nothing with
// it: verify walks from position 0, decode from a window's edge or a
// split's.
template <int D, bool kFromA, class Kv>
__device__ __forceinline__ void fetch_bf16(const __nv_bfloat16* __restrict__ k,
                                           const __nv_bfloat16* __restrict__ v,
                                           __nv_bfloat16* sK, __nv_bfloat16* sV, const Kv& kv,
                                           int b, int g, int Hkv, int c0, int a, int e,
                                           bool read_k) {
  constexpr int kPieces = D / 8;                         // per position
  const int c = threadIdx.x % kPieces;
  const uint32_t dk = smem_u32(sK), dv = smem_u32(sV);
#pragma unroll
  for (int x = 0; x < kChunk * kPieces / kBlock; ++x) {
    const int r = threadIdx.x / kPieces + x * (kBlock / kPieces);
    const int pos = c0 + r;
    const bool ok = (!kFromA || pos >= a) && pos < e;
    const size_t off = ok ? (kv.slot(b, pos) * Hkv + g) * D + c * 8 : 0;
    cp_async16(dk + swz<D>(r, c) * 16, k + off, ok && read_k);
    cp_async16(dv + swz<D>(r, c) * 16, v + off, ok);
  }
}

// bf16 pools: each thread copies its 16-byte pieces of the chunk from the
// pages into the stage with cp.async (zeros outside [0, hi)).
struct Bf16Pages {
  const __nv_bfloat16* __restrict__ k;
  const __nv_bfloat16* __restrict__ v;
  struct Regs {};
  template <int D>
  __device__ __forceinline__ void fetch(Regs&, __nv_bfloat16* sK, __nv_bfloat16* sV,
                                        const PagedKv& kv, int b, int g, int Hkv, int c0,
                                        int hi) const {
    fetch_bf16<D, false>(k, v, sK, sV, kv, b, g, Hkv, c0, 0, hi, true);
  }
  template <int D>
  __device__ __forceinline__ void stage(const Regs&, __nv_bfloat16*, __nv_bfloat16*) const {}
};

// int8 pools with bf16 scale pools (P, page, Hkv, 1): each thread loads
// its 16-value pieces and their scales into registers (fetch), and after
// the current chunk's MMAs writes value * scale, in fp32 rounded to bf16,
// into the stage (stage).  A never-written entry (zero values, zero scale)
// reads 0, as in the plain version.
struct Int8Pages {
  const int8_t* __restrict__ k;
  const int8_t* __restrict__ v;
  const __nv_bfloat16* __restrict__ k_scale;
  const __nv_bfloat16* __restrict__ v_scale;
  static constexpr int kPer = kChunk * 128 / 16 / kBlock;  // pieces a thread, D = 128
  struct Regs {
    uint4 k[kPer], v[kPer];
    float ks[kPer], vs[kPer];
  };
  template <int D>
  __device__ __forceinline__ void fetch(Regs& x, __nv_bfloat16*, __nv_bfloat16*,
                                        const PagedKv& kv, int b, int g, int Hkv, int c0,
                                        int hi) const {
    static_assert(D == 128, "Int8Pages::kPer assumes D = 128");
    constexpr int kPieces = D / 16;
    const int c = threadIdx.x % kPieces;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int pos = c0 + threadIdx.x / kPieces + i * (kBlock / kPieces);
      if (pos < hi) {
        const size_t entry = kv.slot(b, pos) * Hkv + g;
        const size_t off = entry * D + c * 16;
        x.k[i] = *reinterpret_cast<const uint4*>(k + off);
        x.v[i] = *reinterpret_cast<const uint4*>(v + off);
        x.ks[i] = __bfloat162float(k_scale[entry]);
        x.vs[i] = __bfloat162float(v_scale[entry]);
      } else {
        x.k[i] = x.v[i] = make_uint4(0, 0, 0, 0);
        x.ks[i] = x.vs[i] = 0.f;
      }
    }
  }
  __device__ static __forceinline__ void put16(__nv_bfloat16* tile, int r, int c, const uint4& raw,
                                               float s) {
    const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
    uint4 lo, hi;
    uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
    uint32_t* h = reinterpret_cast<uint32_t*>(&hi);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      l[j] = pack_bf16(static_cast<float>(q[2 * j]) * s, static_cast<float>(q[2 * j + 1]) * s);
      h[j] = pack_bf16(static_cast<float>(q[8 + 2 * j]) * s,
                       static_cast<float>(q[9 + 2 * j]) * s);
    }
    uint4* t = reinterpret_cast<uint4*>(tile);
    t[swz<128>(r, 2 * c)] = lo;
    t[swz<128>(r, 2 * c + 1)] = hi;
  }
  template <int D>
  __device__ __forceinline__ void stage(const Regs& x, __nv_bfloat16* sK,
                                        __nv_bfloat16* sV) const {
    constexpr int kPieces = D / 16;
    const int c = threadIdx.x % kPieces;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = threadIdx.x / kPieces + i * (kBlock / kPieces);
      put16(sK, r, c, x.k[i], x.ks[i]);
      put16(sV, r, c, x.v[i], x.vs[i]);
    }
  }
};

template <int D>
constexpr size_t verify_smem_bytes() {
  // Q tile + two stages of K and V chunks; the end-of-walk merge reuses
  // the stages
  return sizeof(__nv_bfloat16) * ((size_t)kTileRows * D + 4 * kChunk * D);
}

template <int D, class Src>
__global__ void __launch_bounds__(kBlock)
verify_mma_kernel(const __nv_bfloat16* __restrict__ q, Src src, const int* __restrict__ lengths,
                  __nv_bfloat16* __restrict__ out, int H, int Hkv, int K, float scale_log2,
                  PagedKv kv) {
  static_assert(D % 16 == 0 && (kChunk * D / 8) % kBlock == 0, "tile shape");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK0 = sQ + kTileRows * D;               // stage s at + s * kChunk * D
  __nv_bfloat16* sV0 = sK0 + 2 * kChunk * D;
  constexpr int kKSteps = D / 16;                        // k16 steps over D
  constexpr int kNd = D / 8;                             // n8 blocks of the output

  const int rep = H / Hkv;
  const int row0 = blockIdx.z * kTileRows;
  const int rows = min(K * rep - row0, kTileRows);
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slice = warp & 1;
  const int half = warp >> 1;
  const int n = kv.positions();
  const int len = lengths[b];
  const int hi_last = min(len + (row0 + rows - 1) / rep + 1, n);
  const bool dead = hi_last <= 0;                        // no row sees a key
  const int w_hi = dead ? n : hi_last;

  {  // the tile's query rows, zeros past `rows`
    const uint32_t dq = smem_u32(sQ);
    for (int i = tid; i < kTileRows * (D / 8); i += kBlock) {
      const int r = i / (D / 8);
      const int c = i % (D / 8);
      const int rg = row0 + r;
      const bool ok = r < rows;
      const size_t off =
          ok ? (((size_t)b * K + rg / rep) * H + g * rep + rg % rep) * D + c * 8 : 0;
      cp_async16(dq + swz<D>(r, c) * 16, q + off, ok);
    }
  }
  typename Src::Regs regs;
  src.template fetch<D>(regs, sK0, sV0, kv, b, g, Hkv, 0, w_hi);
  src.template stage<D>(regs, sK0, sV0);
  cp_async_commit();

  // this thread's two rows of its slice: r_lo and r_lo + 8 of the tile
  const int r_lo = slice * 16 + (lane >> 2);
  const bool slice_live = slice * 16 < rows;
  int bound[2];                                          // positions < bound are seen
#pragma unroll
  for (int h = 0; h < 2; ++h) bound[h] = dead ? 0 : min(len + (row0 + r_lo + 8 * h) / rep + 1, n);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kNd][4];
#pragma unroll
  for (int j = 0; j < kNd; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  uint32_t qf[kKSteps][4];

  const int n_chunks = (w_hi + kChunk - 1) / kChunk;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int cur = ci & 1;
    cp_async_wait<0>();
    __syncthreads();                                     // chunk ci staged; ci - 1 consumed
    if (ci == 0) {
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks)
        ldsm_x4(qf[ks], smem_u32(sQ) + swz<D>(slice * 16 + (lane & 15), 2 * ks + (lane >> 4)) * 16);
    }
    const bool more = ci + 1 < n_chunks;
    __nv_bfloat16* sK = sK0 + cur * kChunk * D;
    __nv_bfloat16* sV = sV0 + cur * kChunk * D;
    __nv_bfloat16* nK = sK0 + (cur ^ 1) * kChunk * D;
    __nv_bfloat16* nV = sV0 + (cur ^ 1) * kChunk * D;
    if (more) src.template fetch<D>(regs, nK, nV, kv, b, g, Hkv, (ci + 1) * kChunk, w_hi);

    const int p0 = ci * kChunk + half * kHalf;           // this warp's first position
    if (slice_live && p0 < w_hi) {
      float s[4][4];                                     // 16 rows x 32 positions
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const uint32_t kb = smem_u32(sK);
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bf[4];
          const int r = half * kHalf + np * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldsm_x4(bf, kb + swz<D>(r, 2 * ks + ((lane >> 3) & 1)) * 16);
          mma_bf16(s[2 * np], qf[ks], bf[0], bf[1]);
          mma_bf16(s[2 * np + 1], qf[ks], bf[2], bf[3]);
        }
      }
      float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pos = p0 + j * 8 + 2 * (lane & 3) + (e & 1);
          const int h = e >> 1;
          float x;
          if (pos >= w_hi)
            x = neg_inf();
          else if (pos >= bound[h])
            x = kNegInf;
          else
            x = s[j][e] * scale_log2;
          s[j][e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
      }
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[j][e] - m[e >> 1]);
          s[j][e] = p;
          ps[e >> 1] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
        ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
        l[h] = l[h] * alpha[h] + ps[h];
      }
#pragma unroll
      for (int j = 0; j < kNd; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }
      const uint32_t vb = smem_u32(sV);
#pragma unroll
      for (int t = 0; t < 2; ++t) {                      // 16 positions a step
        const uint32_t pa[4] = {pack_bf16(s[2 * t][0], s[2 * t][1]),
                                pack_bf16(s[2 * t][2], s[2 * t][3]),
                                pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]),
                                pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3])};
        const int r = half * kHalf + t * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bf[4];
          ldsm_x4_t(bf, vb + swz<D>(r, 2 * dp + (lane >> 4)) * 16);
          mma_bf16(acc[2 * dp], pa, bf[0], bf[1]);
          mma_bf16(acc[2 * dp + 1], pa, bf[2], bf[3]);
        }
      }
    }
    if (more) {
      src.template stage<D>(regs, nK, nV);
      cp_async_commit();
    }
  }

  // merge the two position halves of each slice: half 1 hands (m, l, acc)
  // to half 0 through the (now idle) stages, half 0 writes the output
  __syncthreads();
  float* sAcc = reinterpret_cast<float*>(sK0);           // [slice][16 rows][D]
  float* sMl = sAcc + 2 * 16 * D;                        // [slice][16 rows][m, l]
  const int lr = lane >> 2;                              // row within the slice
  if (half == 1 && slice_live) {
#pragma unroll
    for (int j = 0; j < kNd; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(sAcc + (slice * 16 + lr + 8 * h) * D + j * 8 + 2 * (lane & 3)) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    if ((lane & 3) == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sMl[(slice * 16 + lr + 8 * h) * 2] = m[h];
        sMl[(slice * 16 + lr + 8 * h) * 2 + 1] = l[h];
      }
    }
  }
  __syncthreads();
  if (half == 1 || !slice_live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = slice * 16 + lr + 8 * h;               // tile row
    const float m1 = sMl[r * 2], l1 = sMl[r * 2 + 1];
    const float mm = fmaxf(m[h], m1);
    const float a0 = exp2f(m[h] - mm), a1 = exp2f(m1 - mm);
    const float inv = 1.f / fmaxf(l[h] * a0 + l1 * a1, 1e-30f);
    if (r >= rows) continue;
    const int rg = row0 + r;
    __nv_bfloat16* o = out + (((size_t)b * K + rg / rep) * H + g * rep + rg % rep) * D;
#pragma unroll
    for (int j = 0; j < kNd; ++j) {
      const int col = j * 8 + 2 * (lane & 3);
      const float2 other = *reinterpret_cast<const float2*>(sAcc + r * D + col);
      *reinterpret_cast<uint32_t*>(o + col) =
          pack_bf16((acc[j][2 * h] * a0 + other.x * a1) * inv,
                    (acc[j][2 * h + 1] * a0 + other.y * a1) * inv);
    }
  }
}

// Launch verify_mma_kernel on a (Hkv, B, ceil(K * rep / kTileRows)) grid.
// Returns the CUDA error of the launch (0 on success).
template <int D, class Src>
int launch_verify_mma(const void* q, Src src, const int* lengths, void* out, int B, int H,
                      int Hkv, int K, float scale, PagedKv kv, int device, cudaStream_t stream) {
  static bool smem_allowed[kMaxDevices] = {};
  const size_t smem = verify_smem_bytes<D>();
  const cudaError_t e = allow_smem_once(verify_mma_kernel<D, Src>, smem, device, smem_allowed);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (K * (H / Hkv) + kTileRows - 1) / kTileRows;
  verify_mma_kernel<D, Src><<<dim3(Hkv, B, tiles), kBlock, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), src, lengths, static_cast<__nv_bfloat16*>(out), H,
      Hkv, K, scale * kLog2e, kv);
  return (int)cudaGetLastError();
}

}  // namespace mma
}  // namespace repro_torch
