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
// ~295 per byte in bf16) and below that by the bytes.  This first version
// does the arithmetic with fp32 FMAs on the CUDA cores (67 TFLOP/s peak),
// not on the tensor cores (989 TFLOP/s bf16); wgmma and TMA staging are
// later work.
//
// Design:
// * One block per (row tile, kv head, batch row).  A row is one (query
//   position, query head) pair of the kv head's group, flattened so that the
//   rep = H / Hkv heads of a position are adjacent; the 64 rows of a block
//   share every K/V tile staged in shared memory, which is GQA's saving.
// * A loop over 64-key tiles inside the block takes the place of the TPU's
//   sequential kv grid axis; the running max, sum and output accumulator of
//   each row stay in registers.  Tiles wholly above the causal diagonal or
//   below the window of every row in the block are skipped.
// * 256 threads: 16 groups of 16 lanes, each group owning 4 rows.  A lane
//   computes 4x4 scores (keys lane + 16j), the group reduces row max / sum
//   with shuffles, and each lane accumulates 4 rows x D/16 output columns.
// * Masking matches the plain version exactly: masked scores take the
//   finite -1e30, keys past Skv are excluded, and l is floored at 1e-30.
//   A row that sees no key at all (only possible when Sq > Skv with a
//   window) makes the block visit every tile, so it averages all of V as
//   the plain version does.
// * Built for head widths 64 (the speculative draft) and 128 (qwen3-8b) in
//   fp32 and bf16.

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
           int H, int Hkv, int causal, int window, float scale, int device,
           cudaStream_t stream) {
  static bool smem_allowed[kMaxDevices] = {};
  const size_t smem = flash_smem_bytes<D>();
  const cudaError_t e = allow_smem_once(flash_fwd_kernel<T, D>, smem, device, smem_allowed);
  if (e != cudaSuccess) return (int)e;
  const int rep = H / Hkv;
  const dim3 grid((Sq * rep + kRows - 1) / kRows, Hkv, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Skv, H, Hkv, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_width(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
                 int H, int Hkv, int D, int causal, int window, float scale, int device,
                 cudaStream_t st) {
  if (D == 64)
    return launch<T, 64>(q, k, v, out, B, Sq, Skv, H, Hkv, causal, window, scale, device, st);
  return launch<T, 128>(q, k, v, out, B, Sq, Skv, H, Hkv, causal, window, scale, device, st);
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16.  D must be 64 or 128.  window <= 0
// means no window.  Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int dtype, int B, int Sq, int Skv, int H, int Hkv, int D,
                                   int causal, int window, float scale, int device,
                                   void* stream) {
  using namespace repro_torch;
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_width<float>(q, k, v, out, B, Sq, Skv, H, Hkv, D, causal, window, scale,
                               device, st);
  if (dtype == 1)
    return launch_width<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, Hkv, D, causal, window,
                                       scale, device, st);
  return (int)cudaErrorInvalidValue;
}
