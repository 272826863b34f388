// Contiguous decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py ·
// flash_decode_tpu (body _decode_kernel): one query token per row attends
// to the row's contiguous cache (B, S, Hkv, D), positions
// max(0, len - window) <= k < len valid.  The TPU kernel takes one scalar
// cache_len for the batch; this one takes (B,) lengths, because the slot
// engine decodes each row at its own depth (a scalar is their broadcast).
//
// What bounds it on this card: each K/V element is read once and used for
// 2 * rep operations (rep = H / Hkv query heads share it), a few operations
// per byte against the ~295 the H100 needs in bf16, so the bytes of the
// cache it reads bound it (3.35 TB/s).
//
// Design (the shared body in attend.cuh, with K = 1 query per row): one
// block per (kv head, batch row) walks the row's valid positions in
// 64-position chunks staged in shared memory with 16-byte loads (the TPU's
// sequential kv grid axis becomes that loop); the rep query heads of the kv
// head share each chunk, so the cache is read once, and positions past the
// row's length or below its window are never read.  A row of length 0, or
// whose window lies past the cache, averages V over all S positions, as the
// plain version does.  Built for head widths 64 (the speculative draft)
// and 128 (qwen3-8b) in fp32 and bf16, up to 16 query heads per kv head.

#include "attend.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxRep = 16;    // query heads per kv head this kernel takes

template <typename T>
int launch_width(const void* q, const void* k, const void* v, const int* lengths, void* out,
                 int B, int S, int H, int Hkv, int D, int window, float scale, int device,
                 cudaStream_t st) {
  const ContiguousKv kv{S};
  const FpKv<T> src{static_cast<const T*>(k), static_cast<const T*>(v)};
  if (D == 64)
    return launch_attend<T, 64, kMaxRep>(q, src, lengths, out, B, H, Hkv, 1, 0, window, scale,
                                         kv, device, st);
  return launch_attend<T, 128, kMaxRep>(q, src, lengths, out, B, H, Hkv, 1, 0, window, scale,
                                        kv, device, st);
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16.  D must be 64 or 128.  q (B, 1, H, D),
// caches (B, S, Hkv, D), lengths (B,) int32; window <= 0 means no window.
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, int dtype, int B, int S, int H,
                                int Hkv, int D, int window, float scale, int device,
                                void* stream) {
  using namespace repro_torch;
  if ((D != 64 && D != 128) || H % Hkv != 0 || H / Hkv > kMaxRep || S < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lengths);
  if (dtype == 0)
    return launch_width<float>(q, k, v, ln, out, B, S, H, Hkv, D, window, scale, device, st);
  if (dtype == 1)
    return launch_width<__nv_bfloat16>(q, k, v, ln, out, B, S, H, Hkv, D, window, scale, device,
                                       st);
  return (int)cudaErrorInvalidValue;
}
