// Prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py ·
// flash_attention_tpu (body _flash_kernel): causal / sliding-window /
// bidirectional attention with native GQA and an online softmax in fp32.
//
// What bounds it on this card: the work is 4 * B * H * D * (visible
// query-key pairs) operations against (q + k + v + out) bytes; for causal
// attention with qwen3-8b's 32/8 heads that is about 0.4 * S operations
// per byte, so beyond ~750 tokens it is bound by arithmetic (the H100 needs
// ~295 per byte in bf16) and below that by the bytes.  Only the tensor
// cores reach the bf16 rate (989 TFLOP/s dense), and on Hopper only
// through wgmma.
//
// bf16 design (flash_wgmma_kernel), the FlashAttention-3 shape:
// * One CTA per (tile of kRows = 128 query rows, kv head, batch row).  A
//   row is one (query position, query head) pair of the kv head's group,
//   flattened so that the rep = H / Hkv heads of a position are adjacent;
//   the 128 rows share every K/V tile, which is GQA's saving.  The latest
//   (for causal attention the longest) row tiles are launched first.
// * Two consumer warpgroups own 64 rows each.  S = Q K^T is wgmma
//   m64n64k16 with both operands in shared memory (Q and the 64-key K tile,
//   bf16, K-major, 128-byte swizzle); masking and the online softmax (m, l
//   in fp32 registers, exp2 with the scale folded in) run on the
//   accumulator registers; P is rounded to bf16 in registers and O += P V
//   is wgmma m64nDk16 with A from registers and the V tile (MN-major,
//   128-byte swizzle) from shared memory.  O stays in fp32 registers.
// * K/V tiles arrive in a ring of kStages = 3 stages by cp.async (16 bytes
//   a thread, zero-filled past Skv), in the swizzled layout the wgmma
//   descriptors name.  All threads stage Q and the first kStages tiles
//   together, so that a short prefill waits for one round of loads; after
//   that a producer warpgroup refills the ring: it waits on the stage's
//   "empty" mbarrier (one arrival per consumer warp, once its wgmma reads
//   are done), issues the tile, waits for its own copies, makes them
//   visible to the tensor cores' async proxy (fence.proxy.async) and
//   arrives on the stage's "full" mbarrier, which the consumers wait on.
//   cp.async, not TMA: a (position, kv head) row of K is a strided gather
//   of the (B, S, Hkv, D) layout that the same code serves for any Skv
//   tail, and it keeps the build free of the driver API
//   (cuTensorMapEncodeTiled) that _build.py does not link.
// * 384 threads (two consumer warpgroups and the producer warpgroup) and
//   one CTA per SM: the consumers keep 32 score and D/2 output accumulators
//   each within the 168 registers a thread of 384 has, without setmaxnreg;
//   132 KB of shared memory at D = 128 (Q 32 KB, three stages of 32 KB, a
//   1 KB alignment pad).
// * At D = 256 (recurrentgemma-9b) a 64-row warpgroup's O alone is 64 x
//   256 fp32, 128 registers a thread, which with the 32 scores and 16 P
//   fragments does not fit 168; and two warpgroups' Q with three stages
//   would need 263,168 bytes of shared memory, over the 232,448 a block
//   may use.  So the CTA has one consumer warpgroup (64 query rows) beside
//   the producer: 256 threads, up to 255 registers each, and 230,400
//   bytes (Q 32 KB, three stages of 64 KB, the pad).  O += P V is two
//   m64n128k16 products a k16 step, on V's column panels 0-1 and 2-3.  The
//   K/V tiles are read once per 64 rows instead of 128, so the arithmetic
//   per staged byte halves against D = 128's.
// * Masking matches the plain version exactly: masked scores take the
//   finite -1e30, keys past Skv -inf, and l is floored at 1e-30.  A row
//   that sees no key at all (only possible when Sq > Skv with a window)
//   makes the CTA visit every tile, so it averages all of V as the plain
//   version does.  Tiles wholly above the causal diagonal or below the
//   window of every row in the CTA are skipped, and tiles wholly visible to
//   every row skip the mask.
//
// fp32 keeps the CUDA-core body (flash_fwd_kernel): fp32 FMAs, since TF32
// tensor-core inputs would not hold the 1e-4 fp32 tolerance that the
// full-width fp32 consistency checks rest on.  One block of 256 threads
// per 64 rows, K/V staged as padded fp32, 4x4 scores per lane.
//
// Both are built for head widths 64 (the speculative draft), 128 (qwen3-8b
// and the other dense and vlm configs) and 256 (recurrentgemma-9b's local
// attention).

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

// ---- fp32: the CUDA-core body
constexpr int kRows = 64;      // query rows per block
constexpr int kKeys = 64;      // keys per staged tile
constexpr int kThreads = 256;  // 16 row groups x 16 lanes

template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (kRows * (D + 1) + kKeys * (D + 1) + kKeys * D + kRows * (kKeys + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int Sq, int Skv, int H, int Hkv, int causal, int window,
                 float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;                       // kRows x (D+1)
  float* sK = sQ + kRows * (D + 1);       // kKeys x (D+1)
  float* sV = sK + kKeys * (D + 1);       // kKeys x D
  float* sP = sV + kKeys * D;             // kRows x (kKeys+1)
  constexpr int kVec = Elem<T>::kVec;
  constexpr int kVecPerRow = D / kVec;
  constexpr int kCols = D / 16;           // output columns per lane

  const int rep = H / Hkv;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = blockIdx.x * kRows;
  const int n_rows = Sq * rep;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;                // row group: rows 4rg .. 4rg+3
  const int ln = tid & 15;                // lane within the group

  for (int i = tid; i < kRows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    const int gr = r0 + r;
    float* dst = sQ + r * (D + 1) + c;
    if (gr < n_rows) {
      const int h = g * rep + gr % rep;
      float tmp[kVec];
      Elem<T>::load_vec(q + ((size_t)(b * Sq + gr / rep) * H + h) * D + c, tmp);
#pragma unroll
      for (int j = 0; j < kVec; ++j) dst[j] = tmp[j];
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) dst[j] = 0.f;
    }
  }

  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = (r0 + rg * 4 + i) / rep;

  // keys any row of this block can see: [k_lo, k_hi)
  const int q_lo = r0 / rep;
  const int q_hi = min(Sq - 1, (r0 + kRows - 1) / rep);
  int k_lo = 0, k_hi = Skv;
  if (causal) k_hi = min(k_hi, q_hi + 1);
  if (window > 0) k_lo = max(0, q_lo - window + 1);
  if (window > 0 && q_hi - (Skv - 1) >= window) {
    k_lo = 0;                             // some row sees no key: visit all
    k_hi = Skv;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int kt = (k_lo / kKeys) * kKeys; kt < k_hi; kt += kKeys) {
    __syncthreads();                      // previous tile fully consumed
    for (int i = tid; i < kKeys * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * kVec;
      const int kp = kt + r;
      float* dk = sK + r * (D + 1) + c;
      float* dv = sV + r * D + c;
      if (kp < Skv) {
        const size_t off = ((size_t)(b * Skv + kp) * Hkv + g) * D + c;
        float tmp[kVec];
        Elem<T>::load_vec(k + off, tmp);
#pragma unroll
        for (int j = 0; j < kVec; ++j) dk[j] = tmp[j];
        Elem<T>::load_vec(v + off, dv);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) { dk[j] = 0.f; dv[j] = 0.f; }
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(rg * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(ln + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float sv[4];
      float mx = neg_inf();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kt + ln + 16 * j;
        bool visible = true;
        if (causal) visible = visible && qpos[i] >= kp;
        if (window > 0) visible = visible && qpos[i] - kp < window;
        sv[j] = kp >= Skv ? neg_inf() : (visible ? s[i][j] * scale : kNegInf);
        mx = fmaxf(mx, sv[j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sv[j] - m_new);
        sP[(rg * 4 + i) * (kKeys + 1) + ln + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();                         // a group's P rows live in its own warp

#pragma unroll 4
    for (int kk = 0; kk < kKeys; ++kk) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = sV[kk * D + ln + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(rg * 4 + i) * (kKeys + 1) + kk];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = r0 + rg * 4 + i;
    if (gr >= n_rows) continue;
    const int h = g * rep + gr % rep;
    T* o = out + ((size_t)(b * Sq + gr / rep) * H + h) * D;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[ln + 16 * c] = Elem<T>::store(acc[i][c] / denom);
  }
}

// ---- bf16: the wgmma body
namespace wg {

constexpr int kKeys = 64;                     // keys per staged tile
constexpr int kStages = 3;                    // K/V ring depth
constexpr int kProducerThreads = 128;         // one producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// a CTA at head width D: consumer warpgroups of 64 query rows each, two,
// or one at D = 256
template <int D>
struct Cta {
  static constexpr int kConsumers = D == 256 ? 1 : 2;
  static constexpr int kRows = 64 * kConsumers;  // query rows per CTA
  static constexpr int kThreads = 128 * kConsumers + kProducerThreads;
};

template <int D>
constexpr size_t smem_bytes() {
  return 1024 + sizeof(__nv_bfloat16) * ((size_t)Cta<D>::kRows * D + kStages * 2 * kKeys * D);
}
static_assert(smem_bytes<256>() + 2 * kStages * sizeof(uint64_t) <= 232448,
              "D = 256 fits one block's shared memory");

// a compile-time count of threads that stage a tile together
template <int N>
struct Step {
  static constexpr int value = N;
};

// Byte offset of 16-byte piece c (of D / 8) of row r in a tile of R rows
// held as D / 64 panels of R rows x 128 bytes, each row's pieces permuted
// by r % 8: the 128-byte swizzle that wgmma's descriptors name.  Panels
// start 1024-byte aligned.
template <int R>
__device__ __forceinline__ uint32_t panel_off(int r, int c) {
  return (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset, stride byte offset (8-row groups 1024 bytes apart), all in
// 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t lbo_bytes) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// 2^x on the special-function unit (denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// keep the compiler from touching accumulators across an async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, fp32) = or += A (64 x 16, K-major smem) * B (16 x 64, K-major smem)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) += A (64 x 16, registers) * B (16 x 64, MN-major smem)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128) += A (64 x 16, registers) * B (16 x 128, MN-major smem)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x D) += P (64 x 16, registers) * the V rows of one k16 step, whose
// column panels (64 columns of kKeys rows x 128 bytes each) start at sv: one
// product of width D, or at D = 256 one of width 128 on each half
template <int D>
__device__ __forceinline__ void pv_wgmma(float (&o)[D / 2], const uint32_t (&a)[4],
                                         uint32_t sv) {
  if constexpr (D <= 128) {
    wgmma_rs(o, a, desc(sv, kKeys * 128));
  } else {
#pragma unroll
    for (int n = 0; n < D / 128; ++n)
      wgmma_rs(*reinterpret_cast<float(*)[64]>(o + 64 * n), a,
               desc(sv + n * 2 * kKeys * 128, kKeys * 128));
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int D>
__global__ void __launch_bounds__(Cta<D>::kThreads, 1)
flash_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int Sq,
                   int Skv, int H, int Hkv, int causal, int window, float scale_log2) {
  static_assert(D == 64 || D == 128 || D == 256, "head width");
  constexpr int kConsumers = Cta<D>::kConsumers;
  constexpr int kRows = Cta<D>::kRows;
  constexpr int kThreads = Cta<D>::kThreads;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  constexpr uint32_t kQBytes = kRows * D * 2;
  constexpr uint32_t kTileBytes = kKeys * D * 2;
  constexpr int kPieces = D / 8;                    // 16-byte pieces a row
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sKV = sQ + kQBytes;                // stage s: K, then V

  const int rep = H / Hkv;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int n_rows = Sq * rep;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // keys any row of this CTA can see: [k_lo, k_hi)
  const int q_lo = r0 / rep;
  const int q_hi = min(Sq - 1, (r0 + kRows - 1) / rep);
  int k_lo = 0, k_hi = Skv;
  if (causal) k_hi = min(k_hi, q_hi + 1);
  if (window > 0) k_lo = max(0, q_lo - window + 1);
  if (window > 0 && q_hi - (Skv - 1) >= window) {
    k_lo = 0;                                       // some row sees no key: visit all
    k_hi = Skv;
  }
  const int t0 = (k_lo / kKeys) * kKeys;
  const int n_tiles = max(0, (k_hi - t0 + kKeys - 1) / kKeys);

  // K and V tile j into ring stage j % kStages: this thread's 16-byte
  // pieces first, first + step, ... (step, a Step<N>, a multiple of a
  // row's pieces, so that a thread keeps one column; where it is also a
  // multiple of 8 rows the thread keeps one swizzle phase, computed once;
  // the producer's 4 rows a pass at D = 256 swizzle each row)
  auto load_tile = [&](int j, int first, auto step) {
    constexpr int dr = decltype(step)::value / kPieces;
    const int kt = t0 + j * kKeys;
    const uint32_t sK = sKV + (j % kStages) * 2 * kTileBytes;
    const uint32_t sV = sK + kTileBytes;
    const int c = first % kPieces;
    int r = first / kPieces;
    const uint32_t so = (c >> 3) * (kKeys * 128) + (((c & 7) ^ (r & 7)) << 4);
    size_t off = ((size_t)(b * Skv + kt + r) * Hkv + g) * D + c * 8;
    const size_t doff = (size_t)dr * Hkv * D;
    for (; r < kKeys; r += dr, off += doff) {
      const bool ok = kt + r < Skv;
      const uint32_t at = dr % 8 == 0 ? so + r * 128 : panel_off<kKeys>(r, c);
      cp_async16(sK + at, ok ? k + off : k, ok);
      cp_async16(sV + at, ok ? v + off : v, ok);
    }
  };
  static_assert(kThreads % kPieces == 0 && kProducerThreads % kPieces == 0,
                "load_tile keeps a thread on one column");

  // prologue, all threads: Q and the first kStages tiles, so that a short
  // prefill (one or two tiles) waits for one round of loads, not for one
  // warpgroup issuing them all
  for (int i = tid; i < kRows * kPieces; i += kThreads) {
    const int r = i / kPieces;
    const int c = i % kPieces;
    const int gr = r0 + r;
    const bool ok = gr < n_rows;
    const size_t off =
        ok ? ((size_t)(b * Sq + gr / rep) * H + g * rep + gr % rep) * D + c * 8 : 0;
    cp_async16(sQ + panel_off<kRows>(r, c), q + off, ok);
  }
  for (int j = 0; j < min(n_tiles, kStages); ++j) load_tile(j, tid, Step<kThreads>{});
  cp_async_commit();
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kProducerThreads);
      mbar_init(&empty[s], 4 * kConsumers);         // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cp_async_wait<0>();
  fence_proxy_async();                              // visible to wgmma's async proxy
  __syncthreads();

  // the ring: tile j >= kStages is loaded once phase j / kStages - 1 of its
  // stage's empty barrier completes (every consumer warp done with tile
  // j - kStages), and completes the same phase of the stage's full barrier
  if (warp >= 4 * kConsumers) {                     // producer warpgroup
    const int pt = tid - 128 * kConsumers;
    for (int j = kStages; j < n_tiles; ++j) {
      mbar_wait(&empty[j % kStages], (j / kStages - 1) & 1);
      load_tile(j, pt, Step<kProducerThreads>{});
      cp_async_commit();
      if (j > kStages) {                            // tile j - 1 landed
        cp_async_wait<1>();
        fence_proxy_async();
        mbar_arrive(&full[(j - 1) % kStages]);
      }
    }
    if (n_tiles > kStages) {
      cp_async_wait<0>();
      fence_proxy_async();
      mbar_arrive(&full[(n_tiles - 1) % kStages]);
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the CTA; this
  // thread the rows rt and rt + 8 of them (the wgmma accumulator layout)
  const int wg = warp >> 2;
  const int rt = r0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int qpos[2] = {rt / rep, (rt + 8) / rep};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  const uint32_t qa = sQ + wg * 64 * 128;

  float sc[32];
  for (int j = 0; j < n_tiles; ++j) {
    const int kt = t0 + j * kKeys;
    const uint32_t sK = sKV + (j % kStages) * 2 * kTileBytes;
    const uint32_t sV = sK + kTileBytes;
    if (j >= kStages) mbar_wait(&full[j % kStages], (j / kStages - 1) & 1);

    // S = Q K^T
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t koff = (ks & 3) * 32;          // 16 columns into the panel
      wgmma_ss_n64(sc, desc(qa + (ks >> 2) * (kRows * 128) + koff, 16),
                   desc(sK + (ks >> 2) * (kKeys * 128) + koff, 16), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // mask, running max and sum; every row of the CTA sees every key of an
    // "open" tile, whose scores are all real, so it skips the mask and
    // folds the scale into exp2's argument
    const bool open = kt + kKeys <= Skv && (!causal || kt + kKeys - 1 <= q_lo) &&
                      (window <= 0 || q_hi - kt < window);
    float mx[2] = {neg_inf(), neg_inf()};
    if (open) {
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      mx[0] *= scale_log2;
      mx[1] *= scale_log2;
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        const int kp = kt + (i >> 2) * 8 + 2 * (lane & 3) + (i & 1);
        bool visible = true;
        if (causal) visible = visible && qpos[h] >= kp;
        if (window > 0) visible = visible && qpos[h] - kp < window;
        const float x = kp >= Skv ? neg_inf() : (visible ? sc[i] * scale_log2 : kNegInf);
        sc[i] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = ex2(m[h] - m_new);
      m[h] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const float p = ex2(open ? fmaf(sc[i], scale_log2, -m[h]) : sc[i] - m[h]);
      sc[i] = p;
      ps[h] += p;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
      l[h] = l[h] * alpha[h] + ps[h];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P V, P rounded to bf16 as the A fragments of four k16 steps
    uint32_t pa[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int x = 0; x < 4; ++x) pa[t][x] = pack_bf16(sc[8 * t + 2 * x], sc[8 * t + 2 * x + 1]);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t) pv_wgmma<D>(o, pa[t], sV + t * 16 * 128);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[j % kStages]);  // stage free for the producer
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = rt + 8 * h;
    if (gr >= n_rows) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    __nv_bfloat16* dst = out + ((size_t)(b * Sq + gr / rep) * H + g * rep + gr % rep) * D;
#pragma unroll
    for (int i = 2 * h; i < D / 2; i += 4) {
      const int col = (i >> 2) * 8 + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(dst + col) = pack_bf16(o[i] * inv, o[i + 1] * inv);
    }
  }
}

}  // namespace wg

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
               int H, int Hkv, int causal, int window, float scale, int device,
               cudaStream_t stream) {
  static bool smem_allowed[kMaxDevices] = {};
  const size_t smem = flash_smem_bytes<D>();
  const cudaError_t e = allow_smem_once(flash_fwd_kernel<float, D>, smem, device, smem_allowed);
  if (e != cudaSuccess) return (int)e;
  const int rep = H / Hkv;
  const dim3 grid((Sq * rep + kRows - 1) / kRows, Hkv, B);
  flash_fwd_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Sq, Skv, H, Hkv, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
                int H, int Hkv, int causal, int window, float scale, int device,
                cudaStream_t stream) {
  static bool smem_allowed[kMaxDevices] = {};
  const size_t smem = wg::smem_bytes<D>();
  const cudaError_t e =
      allow_smem_once(wg::flash_wgmma_kernel<D>, smem, device, smem_allowed);
  if (e != cudaSuccess) return (int)e;
  const int rep = H / Hkv;
  constexpr int kCtaRows = wg::Cta<D>::kRows;
  const dim3 grid((Sq * rep + kCtaRows - 1) / kCtaRows, Hkv, B);
  wg::flash_wgmma_kernel<D><<<grid, wg::Cta<D>::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Sq, Skv, H, Hkv,
      causal, window, scale * wg::kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16.  D must be 64, 128 or 256.  window <= 0
// means no window.  Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int dtype, int B, int Sq, int Skv, int H, int Hkv, int D,
                                   int causal, int window, float scale, int device,
                                   void* stream) {
  using namespace repro_torch;
  using Launch = int (*)(const void*, const void*, const void*, void*, int, int, int, int, int,
                         int, int, float, int, cudaStream_t);
  const int w = D == 64 ? 0 : D == 128 ? 1 : D == 256 ? 2 : -1;
  if (w < 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  static const Launch launch[2][3] = {{launch_f32<64>, launch_f32<128>, launch_f32<256>},
                                      {launch_bf16<64>, launch_bf16<128>, launch_bf16<256>}};
  return launch[dtype][w](q, k, v, out, B, Sq, Skv, H, Hkv, causal, window, scale, device,
                          static_cast<cudaStream_t>(stream));
}
