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
// cache it reads bound it (3.35 TB/s).  At the serve shapes (4 rows of ~30
// positions) the latency of a one-chunk walk bounds it, and with a few
// long rows, the number of blocks in flight.
//
// Design.  q in bf16 (the serve dtype) runs the tensor-core body of
// decode_mma.cuh: blocks of 4 warps per (kv head, batch row, split), the
// rep query heads one 16-row MMA slice, 64-position chunks staged as bf16
// by a 3-stage cp.async ring (the TPU's sequential kv grid axis becomes
// that loop), the online softmax in registers; when B * Hkv blocks cannot
// fill the card, the S positions are cut into splits (chosen on the host
// from B, Hkv and S) merged by a second, small kernel.  q in fp32 stays on
// attend.cuh's CUDA-core body (one block per (kv head, batch row), fp32
// FMAs): TF32 or bf16 tensor-core inputs would not hold the fp32 tolerance
// of 1e-4.  Either way the rep query heads of a kv head share each staged
// chunk, so the cache is read once, and positions past the row's length
// or below its window are never read.  A row of length 0, or whose window
// lies past the cache, averages V over all S positions, as the plain
// version does.  Built for head widths 64 (the speculative draft), 128
// (qwen3-8b, the other dense and vlm configs) and 256 (recurrentgemma-9b's
// ring cache) in fp32 and bf16, up to 16 query heads per kv head.

#include "decode_mma.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxRep = 16;    // query heads per kv head this kernel takes

// q in fp32 on the CUDA-core body
template <int D>
int launch_fp32(const void* q, const void* k, const void* v, const int* lengths, void* out,
                int B, int S, int H, int Hkv, int window, float scale, int device,
                cudaStream_t st) {
  const FpKv<float> src{static_cast<const float*>(k), static_cast<const float*>(v)};
  return launch_attend<float, D, kMaxRep>(q, src, lengths, out, B, H, Hkv, 1, 0, window, scale,
                                          ContiguousKv{S}, device, st);
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16.  D must be 64, 128 or 256.  q (B, 1, H,
// D), caches (B, S, Hkv, D), lengths (B,) int32; window <= 0 means no window.
// splits: blocks the S positions of a row are cut across (bf16 only; fp32
// takes 1), split z walking positions [z * span, (z + 1) * span), so
// splits * span must reach S; with more than one, workspace holds B * H *
// splits * (D + 2) floats (uninitialised: every split writes its
// partial).  Returns the CUDA error of the launch (0 on success).
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, void* workspace, int dtype,
                                int B, int S, int H, int Hkv, int D, int window, int splits,
                                int span, float scale, int device, void* stream) {
  using namespace repro_torch;
  if ((D != 64 && D != 128 && D != 256) || B < 1 || Hkv < 1 || H % Hkv != 0 ||
      H / Hkv > kMaxRep || S < 1 || splits < 1 || splits > 65535 || span < 1 ||
      (long long)splits * span < S || (splits > 1 && (dtype != 1 || workspace == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lengths);
  if (dtype == 0) {
    const auto fp32 = D == 64 ? launch_fp32<64> : D == 128 ? launch_fp32<128> : launch_fp32<256>;
    return fp32(q, k, v, ln, out, B, S, H, Hkv, window, scale, device, st);
  }
  if (dtype == 1) {
    const ContiguousKv kv{S};
    const mma::DecodeBf16 src{static_cast<const __nv_bfloat16*>(k),
                              static_cast<const __nv_bfloat16*>(v)};
    const auto bf16 = D == 64    ? mma::launch_decode_mma<64, ContiguousKv, mma::DecodeBf16>
                      : D == 128 ? mma::launch_decode_mma<128, ContiguousKv, mma::DecodeBf16>
                                 : mma::launch_decode_mma<256, ContiguousKv, mma::DecodeBf16>;
    return bf16(q, src, ln, out, workspace, B, H, Hkv, window, splits, span, scale, kv, device,
                st);
  }
  return (int)cudaErrorInvalidValue;
}
