// The bf16 body of contiguous and paged decode on the tensor cores
// (mma.sync.m16n8k16, bf16 in, fp32 accumulate), with a split axis that
// cuts a long row across blocks (flash-decoding).  flash_decode.cu and
// paged_decode.cu launch it when q is bf16; q in fp32 and the int8-page
// decode stay on attend.cuh's CUDA-core body, whose fp32 FMAs hold the
// 1e-4 fp32 tolerance that bf16 or TF32 tensor-core inputs would not.
//
// What bounds it on the H100: the bytes of the K/V it reads.  Each element
// feeds 2 * rep operations (rep = H / Hkv <= 16 query heads share it), a
// few per byte against the ~295 the card needs in bf16.  The CUDA-core
// body it replaces reached 17-24% of that bound at 32 rows x 4096: it
// staged fp32 with synchronous loads behind four barriers a chunk, so
// nothing was in flight while a chunk computed.  At the serve shapes (4
// rows of ~30 positions) latency bounds it: one chunk a block.  And with
// few rows, one block per (kv head, row) leaves most of the 132 SMs idle.
// The design:
//
// * One block of 4 warps per (kv head, batch row, split).  The rep query
//   heads of the kv head form one 16-row A slice (rows past rep are
//   zeros), loaded once and held in registers for the whole walk.
// * Warp w takes positions [16 w, 16 w + 16) of every 64-position chunk
//   and keeps its own (m, l, acc) in registers; the 4 warps merge once at
//   the end through shared memory.  Every warp does MMAs on every chunk.
// * K and V chunks (64 positions x D, bf16, rows swizzled so that
//   ldmatrix reads them without bank conflicts) are staged by cp.async
//   into a ring of kDecodeStages stages, one __syncthreads a chunk, so two
//   chunks are in flight while one computes.  A paged position resolves
//   its page through the block table (PagedKv::slot: an entry outside
//   [0, P) traps); positions outside the block's walk are zero-filled
//   (cp.async src-size 0) and never looked up.
// * S = QK^T and O += PV are m16n8k16 MMAs; masking and the online
//   softmax run on the accumulators, in exp2 with the scale folded into
//   log2 e; P is rounded to bf16 as the A fragment of the PV MMAs.
// * Split z of `splits` (gridDim.z) walks positions [z * span, (z + 1) *
//   span) of the row's n, intersected with the row's walk.  The host
//   picks `splits` and span (whole 64-position chunks, splits * span >=
//   n) from B, Hkv and n alone (repro_torch/kernels/decode_split.py).
//   With one split the block writes bf16 out; with more, each block writes
//   its unnormalised fp32 partial (m, l, acc) to a workspace and
//   decode_combine_kernel, launched right after, merges the splits.  An
//   empty intersection writes m = -1e30, l = 0, acc = 0, which the merge
//   weighs 0.
//
// Semantics are attend.cuh's for decode (K = 1, extra = 0): row b sees
// positions [lo, hi), lo = max(0, len - window) with a window, else 0, hi =
// min(len, n); masked positions take -1e30, positions outside the walk
// -inf, m starts at -1e30 (so no -inf - -inf arises), and l is floored at
// 1e-30.  A dead row (length 0, or a window past the cache) walks all n
// positions at -1e30 and returns the mean of V, reading no K; each split
// covers its part of those n positions, and the merge gives the same mean.

#pragma once

#include <stdint.h>

#include "attend_mma.cuh"

namespace repro_torch {
namespace mma {

constexpr int kDecodeRows = 16;        // one m16 slice: the rep <= 16 heads
constexpr int kDecodeStages = 3;       // chunks in the cp.async ring
constexpr int kQuarter = kChunk / kWarps;  // positions of a chunk per warp

template <int D>
constexpr size_t decode_smem_bytes() {
  // Q slice + the ring's K and V chunks; the end-of-walk merge reuses the
  // ring
  return sizeof(__nv_bfloat16) * ((size_t)kDecodeRows * D + 2 * kDecodeStages * kChunk * D);
}

// q (B, 1, H, D), K/V through `kv` ((B, S, Hkv, D) caches or (P, page, Hkv,
// D) pools), out (B, 1, H, D); `part` the split workspace (unused with one
// split): B * H * splits * D fp32 acc, then B * H * splits (m, l) pairs,
// partial p = (b * H + head) * splits + z.
template <int D, class Kv>
__global__ void __launch_bounds__(kBlock)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ part, int H, int Hkv,
                  int window, int span, float scale_log2, Kv kv) {
  static_assert(D % 16 == 0 && (kChunk * D / 8) % kBlock == 0, "tile shape");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK0 = sQ + kDecodeRows * D;             // stage s at + s * kChunk * D
  __nv_bfloat16* sV0 = sK0 + kDecodeStages * kChunk * D;
  constexpr int kKSteps = D / 16;                        // k16 steps over D
  constexpr int kNd = D / 8;                             // n8 blocks of the output

  const int rep = H / Hkv;
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = kv.positions();
  const int len = lengths[b];
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int hi = min(len, n);
  const bool dead = hi <= lo;                            // the row sees no key
  const int w_lo = dead ? 0 : lo;
  const int w_hi = dead ? n : hi;
  // this split's part of the walk: [a, e)
  const int a = max(w_lo, split * span);
  const int e = min(w_hi, split * span + span);
  const int c_first = a / kChunk;
  const int n_chunks = a < e ? (e - 1) / kChunk - c_first + 1 : 0;

  {  // the query slice, zeros past rep
    const uint32_t dq = smem_u32(sQ);
    for (int i = tid; i < kDecodeRows * (D / 8); i += kBlock) {
      const int r = i / (D / 8);
      const int c = i % (D / 8);
      const bool ok = r < rep;
      const size_t off = ok ? ((size_t)b * H + g * rep + r) * D + c * 8 : 0;
      cp_async16(dq + swz<D>(r, c) * 16, q + off, ok);
    }
  }
#pragma unroll
  for (int s = 0; s < kDecodeStages - 1; ++s) {          // Q rides in the first group
    if (s < n_chunks)
      fetch_bf16<D, true>(k, v, sK0 + s * kChunk * D, sV0 + s * kChunk * D, kv, b, g, Hkv,
                          (c_first + s) * kChunk, a, e, !dead);
    cp_async_commit();
  }

  // this thread's rows: lane / 4 and lane / 4 + 8 of the slice
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kNd][4];
#pragma unroll
  for (int j = 0; j < kNd; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  uint32_t qf[kKSteps][4];

  for (int ci = 0; ci < n_chunks; ++ci) {
    cp_async_wait<kDecodeStages - 2>();
    __syncthreads();                                     // chunk ci staged; ci - 1 consumed
    if (ci == 0) {
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks)
        ldsm_x4(qf[ks], smem_u32(sQ) + swz<D>(lane & 15, 2 * ks + (lane >> 4)) * 16);
    }
    {  // refill the stage chunk ci - 1 used
      const int nx = ci + kDecodeStages - 1;
      if (nx < n_chunks) {
        const int st = nx % kDecodeStages;
        fetch_bf16<D, true>(k, v, sK0 + st * kChunk * D, sV0 + st * kChunk * D, kv, b, g,
                            Hkv, (c_first + nx) * kChunk, a, e, !dead);
      }
      cp_async_commit();
    }
    const int st = ci % kDecodeStages;
    const int p0 = (c_first + ci) * kChunk + warp * kQuarter;  // this warp's first position
    if (p0 < e && p0 + kQuarter > a) {
      float s[2][4];                                     // 16 rows x 16 positions
#pragma unroll
      for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const uint32_t kb = smem_u32(sK0 + st * kChunk * D);
      {
        const int r = warp * kQuarter + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
          uint32_t bf[4];
          ldsm_x4(bf, kb + swz<D>(r, 2 * ks + ((lane >> 3) & 1)) * 16);
          mma_bf16(s[0], qf[ks], bf[0], bf[1]);
          mma_bf16(s[1], qf[ks], bf[2], bf[3]);
        }
      }
      float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int pos = p0 + j * 8 + 2 * (lane & 3) + (x & 1);
          float y;
          if (pos < a || pos >= e)
            y = neg_inf();
          else if (dead)
            y = kNegInf;
          else
            y = s[j][x] * scale_log2;
          s[j][x] = y;
          mx[x >> 1] = fmaxf(mx[x >> 1], y);
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
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float p = exp2f(s[j][x] - m[x >> 1]);
          s[j][x] = p;
          ps[x >> 1] += p;
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
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
      const uint32_t vb = smem_u32(sV0 + st * kChunk * D);
      const int r = warp * kQuarter + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bf[4];
        ldsm_x4_t(bf, vb + swz<D>(r, 2 * dp + (lane >> 4)) * 16);
        mma_bf16(acc[2 * dp], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
  }

  // merge the 4 warps through the (now idle) ring: each writes its rows'
  // (m, l, acc); the block then writes out, or this split's partial
  cp_async_wait<0>();
  __syncthreads();
  float* sAcc = reinterpret_cast<float*>(sK0);           // [warp][16 rows][D]
  float* sMl = sAcc + kWarps * kDecodeRows * D;          // [warp][16 rows][m, l]
  const int lr = lane >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * kDecodeRows + lr + 8 * h;
#pragma unroll
    for (int j = 0; j < kNd; ++j)
      *reinterpret_cast<float2*>(sAcc + r * D + j * 8 + 2 * (lane & 3)) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    if ((lane & 3) == 0) {
      sMl[r * 2] = m[h];
      sMl[r * 2 + 1] = l[h];
    }
  }
  __syncthreads();
  for (int i = tid; i < rep * D; i += kBlock) {
    const int r = i / D;
    const int d = i % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sMl[(w * kDecodeRows + r) * 2]);
    float sum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int wr = w * kDecodeRows + r;
      const float f = exp2f(sMl[wr * 2] - mm);
      sum += f * sMl[wr * 2 + 1];
      o += f * sAcc[wr * D + d];
    }
    const size_t head = (size_t)b * H + g * rep + r;
    if (splits == 1) {
      out[head * D + d] = __float2bfloat16(o / fmaxf(sum, 1e-30f));
    } else {
      const size_t p = head * splits + split;
      part[p * D + d] = o;
      if (d == 0) {
        float* ml = part + (size_t)gridDim.y * H * splits * D;
        ml[p * 2] = mm;
        ml[p * 2 + 1] = sum;
      }
    }
  }
}

// Merge the splits' partials of one (row, head) per block, thread d for
// output column d: out = sum_z 2^(m_z - M) acc_z / max(sum_z 2^(m_z - M)
// l_z, 1e-30), M = max_z m_z.
template <int D>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ out,
                      int splits, int heads) {
  const size_t head = blockIdx.x;                        // b * H + h
  const int d = threadIdx.x;
  const float* ml = part + (size_t)heads * splits * D;
  const size_t p0 = head * splits;
  float mm = kNegInf;
  for (int z = 0; z < splits; ++z) mm = fmaxf(mm, ml[(p0 + z) * 2]);
  float sum = 0.f, o = 0.f;
  for (int z = 0; z < splits; ++z) {
    const float f = exp2f(ml[(p0 + z) * 2] - mm);
    sum += f * ml[(p0 + z) * 2 + 1];
    o += f * part[(p0 + z) * D + d];
  }
  out[head * D + d] = __float2bfloat16(o / fmaxf(sum, 1e-30f));
}

// Launch decode_mma_kernel on a (Hkv, B, splits) grid and, with more than
// one split, decode_combine_kernel on B * H blocks after it.  Returns the
// CUDA error of the launches (0 on success).
template <int D, class Kv>
int launch_decode_mma(const void* q, const void* k, const void* v, const int* lengths,
                      void* out, void* part, int B, int H, int Hkv, int window, int splits,
                      int span, float scale, Kv kv, int device, cudaStream_t stream) {
  static bool smem_allowed[kMaxDevices] = {};
  const size_t smem = decode_smem_bytes<D>();
  cudaError_t e = allow_smem_once(decode_mma_kernel<D, Kv>, smem, device, smem_allowed);
  if (e != cudaSuccess) return (int)e;
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* ws = static_cast<float*>(part);
  decode_mma_kernel<D, Kv><<<dim3(Hkv, B, splits), kBlock, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lengths, o, ws, H, Hkv, window, span, scale * kLog2e,
      kv);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  decode_combine_kernel<D><<<B * H, D, 0, stream>>>(ws, o, splits, B * H);
  return (int)cudaGetLastError();
}

}  // namespace mma
}  // namespace repro_torch
