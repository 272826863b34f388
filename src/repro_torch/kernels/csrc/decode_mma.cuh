// The bf16 body of contiguous and paged decode on the tensor cores
// (mma.sync.m16n8k16, bf16 in, fp32 accumulate), with a split axis that
// cuts a long row across blocks (flash-decoding), over bf16 K/V (a cache
// or a pool) or int8 pools with bf16 scale pools.  flash_decode.cu and
// paged_decode.cu launch it when q is bf16; q in fp32 stays on attend.cuh's
// CUDA-core body, whose fp32 FMAs hold the 1e-4 fp32 tolerance that bf16
// or TF32 tensor-core inputs would not.
//
// What bounds it on the H100: the bytes of the K/V it reads.  Each element
// feeds 2 * rep operations (rep = H / Hkv <= 16 query heads share it), a
// few per byte against the ~295 the card needs in bf16.  The CUDA-core
// body it replaces reached 14-24% of that bound at 32 rows x 4096: it
// staged fp32 with synchronous loads behind four barriers a chunk, so
// nothing was in flight while a chunk computed.  At the serve shapes (4
// rows of ~30 positions) latency bounds it: one chunk a block.  And with
// few rows, one block per (kv head, row) leaves most of the 132 SMs idle.
// The design:
//
// * One block of 4 warps per (kv head, batch row, split).  The rep query
//   heads of the kv head form one 16-row A slice (rows past rep are
//   zeros), loaded once and held in registers for the whole walk -- up to
//   D = 128.  At D = 256 (recurrentgemma-9b) the slice would take 64
//   registers a thread beside the 128 of the accumulators, so there each
//   warp reads its A fragment of a k16 step from the shared Q slice with
//   ldmatrix right before the step's MMAs, as it reads K; the ring (three
//   stages of 64 KB) and Q take 200 KB, so one block fits an SM
//   (decode_split.py's TARGET_BLOCKS_D256).
// * Warp w takes positions [16 w, 16 w + 16) of every 64-position chunk
//   and keeps its own (m, l, acc) in registers; the 4 warps merge once at
//   the end through shared memory.  Every warp does MMAs on every chunk.
// * K and V chunks are staged by cp.async into a ring of 3 stages, one
//   __syncthreads a chunk, so the two chunks after the one a block
//   computes stay in flight.  A paged position resolves its page through
//   the block table (PagedKv::slot: an entry outside [0, P) traps);
//   positions outside the block's walk are zero-filled (cp.async src-size
//   0) and never looked up.  Where K/V come from is the Src policy:
//   - DecodeBf16: 3 stages of bf16 (64 positions x D, rows swizzled so that
//     ldmatrix reads them without bank conflicts), which the MMAs read in
//     place;
//   - DecodeInt8 (row 2q): 3 stages of the raw int8 bytes (half of
//     bf16's) and, by the same cp.async, the 4-byte word holding each
//     position's bf16 K and V scale, so no load is waited on outside the
//     ring.  Once a stage lands, each warp converts its own 16 positions'
//     K to bf16 -- exactly: an int8 value is (128 + its low 7 bits) minus
//     128 or 256, in bf16 integer and logic operations -- into the swizzled
//     tile the bf16 fragments read, and after the QK MMAs their V into the
//     same rows, so the MMAs are the bf16 ones.  One 16 KB tile for K and
//     V keeps a block at 70 KB of shared memory: 3 blocks an SM, where 2
//     left this latency-bound walk with too little in flight.  The scales
//     fold into the accumulators instead of every element: S[:, pos] =
//     (q . k_int8[pos]) x k_scale[pos] x the softmax scale, and the PV
//     MMAs take P'[:, pos] = p[:, pos] x v_scale[pos] rounded to bf16,
//     while l sums the unscaled p.  That is the TPU kernel's fp32
//     dequantize up to the bf16 rounding of P', which the bf16 body has
//     for P.
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
// positions at -1e30 and returns the mean of V (int8: of v_scale x v),
// reading no K; each split covers its part of those n positions, and the
// merge gives the same mean.  A never-written int8 entry (zero values,
// zero scale) reads 0, as in the plain version.

#pragma once

#include <stdint.h>

#include "attend_mma.cuh"

namespace repro_torch {
namespace mma {

constexpr int kDecodeRows = 16;        // one m16 slice: the rep <= 16 heads
constexpr int kDecodeStages = 3;       // chunks in the cp.async ring
constexpr int kQuarter = kChunk / kWarps;  // positions of a chunk per warp

// Two int8 values, bytes `sel` of w (0x4140: bytes 0 and 1; 0x4342: 2 and
// 3), as a bf16 pair, exactly: each is (128 + its low 7 bits) - (its sign
// bit ? 256 : 128), both terms built as bf16 bit patterns (0x4300 = 128.0,
// 0x4380 = 256.0) and subtracted in one bf16x2 operation whose result,
// an integer in [-128, 127], bf16 holds exactly.
__device__ __forceinline__ uint32_t bf16x2_of_int8x2(uint32_t w, uint32_t sel) {
  const uint32_t p = __byte_perm(w, 0, sel);             // 0x00bb00aa
  const uint32_t lo = (p & 0x007f007fu) | 0x43004300u;
  const uint32_t hi = (p & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo),
                                   *reinterpret_cast<const __nv_bfloat162*>(&hi));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Copy 4 bytes from device memory to shared memory asynchronously, or only
// the first `bytes` of them (the rest zero-filled; 0: src is not read).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

// bf16 K/V (a cache or a pool): each stage holds a chunk's K and V as the
// swizzled bf16 tiles the MMAs read in place.  Stage st's K at st * kChunk
// * D of the ring, its V at (kDecodeStages + st) * kChunk * D.
struct DecodeBf16 {
  const __nv_bfloat16* __restrict__ k;
  const __nv_bfloat16* __restrict__ v;
  static constexpr int kMinBlocks = 1;   // blocks an SM the registers must allow
  static constexpr bool kScaled = false;
  template <int D>
  static constexpr size_t smem_bytes() {
    return sizeof(__nv_bfloat16) * 2 * kDecodeStages * kChunk * D;
  }
  template <int D, class Kv>
  __device__ __forceinline__ void fetch(unsigned char* ring, int st, const Kv& kv, int b, int g,
                                        int Hkv, int c0, int a, int e, bool read_k) const {
    auto* sK = reinterpret_cast<__nv_bfloat16*>(ring) + st * kChunk * D;
    fetch_bf16<D, true>(k, v, sK, sK + kDecodeStages * kChunk * D, kv, b, g, Hkv, c0, a, e,
                        read_k);
  }
  template <int D>
  __device__ __forceinline__ const __nv_bfloat16* tile_k(unsigned char* ring, int st, int,
                                                         int) const {
    return reinterpret_cast<const __nv_bfloat16*>(ring) + st * kChunk * D;
  }
  template <int D>
  __device__ __forceinline__ const __nv_bfloat16* tile_v(unsigned char* ring, int st, int,
                                                         int) const {
    return reinterpret_cast<const __nv_bfloat16*>(ring) + (kDecodeStages + st) * kChunk * D;
  }
};

// int8 pools (P, page, Hkv, D) with bf16 scale pools (P, page, Hkv, 1).
// Shared memory: one bf16 tile (kChunk x D) that each warp fills with its
// 16 positions' K, reads, then fills with their V; each warp's fp32 scales
// of those positions (16 K, then 16 V); then kDecodeStages stages, each the raw
// int8 K and V (kChunk x D bytes each), the 4-byte word holding each
// position's K and V scale (kChunk each), and which half of it the scale
// is (one byte each).  The words come by cp.async with the values: a scale
// pool is only 2-byte aligned, so the word is the aligned one around it --
// its neighbour entry is in the same tensor, or a trailing entry is copied
// alone (cp.async src-size 2), or, for a pool whose base is 2 mod 4 (a
// view into a larger allocation), the 2 bytes before the first entry are
// read and unused.  Thread t stages the 16-byte pieces c = t % 8 of rows
// t / 8 + 16 x (x < 4) of K and V, and the K (c even) or V (c odd) scale
// of row t / 8 + 16 (c / 2), reusing that row's table lookup.
struct DecodeInt8 {
  const int8_t* __restrict__ k;
  const int8_t* __restrict__ v;
  const __nv_bfloat16* __restrict__ k_scale;
  const __nv_bfloat16* __restrict__ v_scale;
  size_t entries;              // (position, kv head) entries of a scale pool
  static constexpr int kMinBlocks = 3;
  static constexpr bool kScaled = true;
  static constexpr int kVScales = kQuarter;   // a warp's V scales after its K scales
  template <int D>
  __host__ __device__ static constexpr size_t tile_bytes() {
    return sizeof(__nv_bfloat16) * kChunk * D + sizeof(float) * kWarps * 2 * kQuarter;
  }
  template <int D>
  __host__ __device__ static constexpr size_t stage_bytes() {
    return 2 * kChunk * D + 2 * kChunk * sizeof(uint32_t) + 2 * kChunk;
  }
  template <int D>
  static constexpr size_t smem_bytes() {
    return tile_bytes<D>() + kDecodeStages * stage_bytes<D>();
  }
  template <int D>
  __device__ static __forceinline__ unsigned char* stage_of(unsigned char* ring, int st) {
    return ring + tile_bytes<D>() + st * stage_bytes<D>();
  }
  template <int D>
  __device__ __forceinline__ void fetch(unsigned char* ring, int st, const PagedKv& kv, int b,
                                        int g, int Hkv, int c0, int a, int e, bool read_k) const {
    static_assert(D == 128, "DecodeInt8 stages 8 pieces a row: D = 128");
    constexpr int kPieces = D / 16;                      // 16 int8 values a piece
    constexpr int kRows = kBlock / kPieces;              // rows a pass
    const int c = threadIdx.x % kPieces;
    unsigned char* stage = stage_of<D>(ring, st);
    const uint32_t dk = smem_u32(stage);
    const uint32_t dv = dk + kChunk * D;
    size_t s_entry = 0;
    bool s_ok = false;
    // the rows' pages, walked from the first row's: one division a fetch
    int lp = (c0 + threadIdx.x / kPieces) / kv.page;
    int off = c0 + threadIdx.x / kPieces - lp * kv.page;
#pragma unroll
    for (int x = 0; x < kChunk / kRows; ++x) {
      const int r = threadIdx.x / kPieces + x * kRows;
      const int pos = c0 + r;
      const bool ok = pos >= a && pos < e;
      const size_t entry = ok ? kv.slot_at(b, lp, off) * Hkv + g : 0;
      cp_async16(dk + r * D + c * 16, k + entry * D + c * 16, ok && read_k);
      cp_async16(dv + r * D + c * 16, v + entry * D + c * 16, ok);
      if (x == c >> 1) {
        s_entry = entry;
        s_ok = ok;
      }
      for (off += kRows; off >= kv.page; off -= kv.page) ++lp;
    }
    // this thread's scale: the aligned word around it, and its half
    const bool is_v = c & 1;
    const int r = threadIdx.x / kPieces + (c >> 1) * kRows;
    const __nv_bfloat16* pool = is_v ? v_scale : k_scale;
    const size_t bias = (reinterpret_cast<uintptr_t>(pool) >> 1) & 1;
    const size_t w = s_entry + bias;                     // from the aligned address below
    const int bytes = !(s_ok && (is_v || read_k)) ? 0 : ((w | 1) - bias < entries ? 4 : 2);
    cp_async4(smem_u32(stage + 2 * kChunk * D) + (is_v * kChunk + r) * 4,
              reinterpret_cast<const unsigned char*>(pool) - 2 * bias + 4 * (w >> 1), bytes);
    stage[2 * kChunk * D + 2 * kChunk * 4 + is_v * kChunk + r] = w & 1;
  }
  // warp w converts its rows [16 w, 16 w + 16) of K (kv 0) or V (kv 1) in
  // stage st into rows [16 w, 16 w + 16) of the tile, lane taking piece
  // lane % 8 of rows 16 w + lane / 8 + 4 i.  A quarter-warp reads one
  // row's 128 bytes, and writes its two bf16 halves in an order (lanes 0-3
  // the low half first, 4-7 the high) that puts the 8 lanes' 16-byte
  // stores in 8 different bank groups.
  template <int D>
  __device__ __forceinline__ void convert(unsigned char* ring, int st, int warp, int lane,
                                          int kv) const {
    constexpr int kPieces = D / 16;
    auto* tile = reinterpret_cast<uint4*>(ring);
    const unsigned char* stage = stage_of<D>(ring, st) + kv * kChunk * D;
    const int c = lane % kPieces;
    const bool lo_first = c < kPieces / 2;
#pragma unroll
    for (int i = 0; i < kQuarter * kPieces / 32; ++i) {
      const int r = warp * kQuarter + lane / kPieces + i * (32 / kPieces);
      const uint4 raw = *reinterpret_cast<const uint4*>(stage + r * D + c * 16);
      const uint32_t w0 = lo_first ? raw.x : raw.z, w1 = lo_first ? raw.y : raw.w;
      const uint32_t w2 = lo_first ? raw.z : raw.x, w3 = lo_first ? raw.w : raw.y;
      tile[swz<D>(r, 2 * c + !lo_first)] =
          make_uint4(bf16x2_of_int8x2(w0, 0x4140), bf16x2_of_int8x2(w0, 0x4342),
                     bf16x2_of_int8x2(w1, 0x4140), bf16x2_of_int8x2(w1, 0x4342));
      tile[swz<D>(r, 2 * c + lo_first)] =
          make_uint4(bf16x2_of_int8x2(w2, 0x4140), bf16x2_of_int8x2(w2, 0x4342),
                     bf16x2_of_int8x2(w3, 0x4140), bf16x2_of_int8x2(w3, 0x4342));
    }
  }
  // the warp's K in the tile, and its positions' scales as floats
  template <int D>
  __device__ __forceinline__ const __nv_bfloat16* tile_k(unsigned char* ring, int st, int warp,
                                                         int lane) const {
    convert<D>(ring, st, warp, lane, 0);
    {  // lane l < 16: the K scale of the warp's position l; else the V scale
      const unsigned char* stage = stage_of<D>(ring, st);
      const int kind = lane / kQuarter;
      const int r = kind * kChunk + warp * kQuarter + lane % kQuarter;
      const uint32_t word = reinterpret_cast<const uint32_t*>(stage + 2 * kChunk * D)[r];
      const bool high = stage[2 * kChunk * D + 2 * kChunk * 4 + r];
      reinterpret_cast<float*>(ring + sizeof(__nv_bfloat16) * kChunk * D)[warp * 2 * kQuarter +
                                                                          lane] =
          __uint_as_float(high ? word & 0xffff0000u : word << 16);
    }
    __syncwarp();
    return reinterpret_cast<const __nv_bfloat16*>(ring);
  }
  // the warp's V in the tile, over its K once every lane has read that
  template <int D>
  __device__ __forceinline__ const __nv_bfloat16* tile_v(unsigned char* ring, int st, int warp,
                                                         int lane) const {
    __syncwarp();
    convert<D>(ring, st, warp, lane, 1);
    __syncwarp();
    return reinterpret_cast<const __nv_bfloat16*>(ring);
  }
  // the warp's K scales (its V scales at + kVScales)
  template <int D>
  __device__ __forceinline__ const float* scales(unsigned char* ring, int warp) const {
    return reinterpret_cast<const float*>(ring + sizeof(__nv_bfloat16) * kChunk * D) +
           warp * 2 * kQuarter;
  }
};

template <int D, class Src>
constexpr size_t decode_smem_bytes() {
  // Q slice + the source's ring (and tiles); the end-of-walk merge reuses
  // what follows Q
  return sizeof(__nv_bfloat16) * kDecodeRows * D + Src::template smem_bytes<D>();
}

// q (B, 1, H, D), K/V from `src` through `kv` ((B, S, Hkv, D) caches or
// (P, page, Hkv, D) pools), out (B, 1, H, D); `part` the split workspace
// (unused with one split): B * H * splits * D fp32 acc, then B * H *
// splits (m, l) pairs, partial p = (b * H + head) * splits + z.
template <int D, class Kv, class Src>
__global__ void __launch_bounds__(kBlock, Src::kMinBlocks)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q, Src src,
                  const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
                  float* __restrict__ part, int H, int Hkv, int window, int span,
                  float scale_log2, Kv kv) {
  static_assert(D % 16 == 0 && (kChunk * D / 8) % kBlock == 0, "tile shape");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* ring = smem_raw + sizeof(__nv_bfloat16) * kDecodeRows * D;
  constexpr int kKSteps = D / 16;                        // k16 steps over D
  constexpr int kNd = D / 8;                             // n8 blocks of the output
  constexpr bool kQInRegs = D <= 128;                    // else read per k-step

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
  for (int s = 0; s < kDecodeStages - 1; ++s) {                // Q rides in the first group
    if (s < n_chunks)
      src.template fetch<D>(ring, s, kv, b, g, Hkv, (c_first + s) * kChunk, a, e, !dead);
    cp_async_commit();
  }

  // this thread's rows: lane / 4 and lane / 4 + 8 of the slice
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kNd][4];
#pragma unroll
  for (int j = 0; j < kNd; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  uint32_t qf[kQInRegs ? kKSteps : 1][4];

  for (int ci = 0; ci < n_chunks; ++ci) {
    cp_async_wait<kDecodeStages - 2>();
    __syncthreads();                                     // chunk ci staged; ci - 1 consumed
    if constexpr (kQInRegs) {
      if (ci == 0) {
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks)
          ldsm_x4(qf[ks], smem_u32(sQ) + swz<D>(lane & 15, 2 * ks + (lane >> 4)) * 16);
      }
    }
    {  // refill the stage chunk ci - 1 used
      const int nx = ci + kDecodeStages - 1;
      if (nx < n_chunks)
        src.template fetch<D>(ring, nx % kDecodeStages, kv, b, g, Hkv, (c_first + nx) * kChunk,
                              a, e, !dead);
      cp_async_commit();
    }
    const int st = ci % kDecodeStages;
    const int p0 = (c_first + ci) * kChunk + warp * kQuarter;  // this warp's first position
    if (p0 < e && p0 + kQuarter > a) {
      float s[2][4];                                     // 16 rows x 16 positions
#pragma unroll
      for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const uint32_t kb = smem_u32(src.template tile_k<D>(ring, st, warp, lane));
      {
        const int r = warp * kQuarter + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
          uint32_t bf[4];
          ldsm_x4(bf, kb + swz<D>(r, 2 * ks + ((lane >> 3) & 1)) * 16);
          if constexpr (!kQInRegs)
            ldsm_x4(qf[0], smem_u32(sQ) + swz<D>(lane & 15, 2 * ks + (lane >> 4)) * 16);
          const uint32_t(&af)[4] = qf[kQInRegs ? ks : 0];
          mma_bf16(s[0], af, bf[0], bf[1]);
          mma_bf16(s[1], af, bf[2], bf[3]);
        }
      }
      // int8: this thread's positions' scales, the K scale with the
      // softmax scale folded in; [j][x & 1] as the accumulators' columns
      float ksc[2][2], vsc[2][2];
      if constexpr (Src::kScaled) {
        const float* sc = src.template scales<D>(ring, warp) + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 kk = *reinterpret_cast<const float2*>(sc + j * 8);
          const float2 vv = *reinterpret_cast<const float2*>(sc + Src::kVScales + j * 8);
          ksc[j][0] = kk.x * scale_log2;
          ksc[j][1] = kk.y * scale_log2;
          vsc[j][0] = vv.x;
          vsc[j][1] = vv.y;
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
          else if constexpr (Src::kScaled)
            y = s[j][x] * ksc[j][x & 1];
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
      if constexpr (Src::kScaled) {                      // P' = p x v_scale
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) s[j][x] *= vsc[j][x & 1];
      }
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
      const uint32_t vb = smem_u32(src.template tile_v<D>(ring, st, warp, lane));
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
  float* sAcc = reinterpret_cast<float*>(ring);          // [warp][16 rows][D]
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
template <int D, class Kv, class Src>
int launch_decode_mma(const void* q, Src src, const int* lengths, void* out, void* part, int B,
                      int H, int Hkv, int window, int splits, int span, float scale, Kv kv,
                      int device, cudaStream_t stream) {
  static bool smem_allowed[kMaxDevices] = {};
  const size_t smem = decode_smem_bytes<D, Src>();
  cudaError_t e = allow_smem_once(decode_mma_kernel<D, Kv, Src>, smem, device, smem_allowed);
  if (e != cudaSuccess) return (int)e;
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* ws = static_cast<float*>(part);
  decode_mma_kernel<D, Kv, Src><<<dim3(Hkv, B, splits), kBlock, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), src, lengths, o, ws, H, Hkv, window, span,
      scale * kLog2e, kv);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  decode_combine_kernel<D><<<B * H, D, 0, stream>>>(ws, o, splits, B * H);
  return (int)cudaGetLastError();
}

}  // namespace mma
}  // namespace repro_torch
