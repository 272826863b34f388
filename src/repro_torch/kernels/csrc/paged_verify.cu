// Paged multi-token verify attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/spec_verify.py ·
// flash_paged_verify_tpu (body _verify_kernel, wrapper _paged_attention in
// paged_decode.py) in both its forms: K query tokens per row -- the pending
// token and the drafts of a speculative verify, or the uncached suffix of a
// prompt in the prefix cache's warm prefill -- whose KV is already in the
// page pool (P, page, Hkv, D) at positions lengths[b] .. lengths[b] + K - 1,
// reached through the row's block table (B, maxp); query j attends
// positions <= lengths[b] + j.  paged_verify_fwd takes pools of q's type
// (no scales); paged_verify_int8_fwd takes int8 pools with bf16 scale pools
// (P, page, Hkv, 1) riding the same table (k_scale/v_scale), each element
// dequantized in fp32 as it is staged (and rounded to bf16 for q in bf16,
// the values the plain version attends).
//
// What bounds it on this card: each K/V element is read once per tile and
// used for 2 * rows operations (20 query rows for qwen3-8b with spec_k 4, up
// to 32 or 64 per tile), far below the ~295 operations per bf16 byte the
// H100 needs, so the bytes of the pages it reads bound it (3.35 TB/s; int8
// pages halve them); at the serve shapes, a few rows of ~30 positions, the
// latency of a short walk bounds it.
//
// Design.  q in bf16 (the serve dtype, both entry points) runs the
// tensor-core body of attend_mma.cuh: blocks of 4 warps per (kv head,
// batch row, tile of 32 query rows), K/V chunks staged as bf16 (int8 pages
// dequantized in fp32 and rounded to bf16 on the way) by double-buffered
// cp.async or register loads, scores and PV on mma.sync.m16n8k16 with the
// online softmax in registers, two warps per 16-row slice splitting each
// chunk's positions.  q in fp32 stays on attend.cuh's CUDA-core body (one
// block per tile of <= 64 rows, fp32 FMAs): TF32 or bf16 tensor-core
// inputs would not hold the fp32 tolerance of 1e-4 that the full-width
// fp32 consistency checks rest on.  Either way the K * rep query rows
// (every verify token of every query head of the group) are cut into tiles
// -- the TPU kernel holds all of them in one q block, which shared memory
// cannot for a warm prefill of hundreds of tokens -- and the rows of a tile
// share each staged 64-position chunk, so the pages are read once per tile,
// not once per token.  Each query row carries its own causal bound
// lengths[b] + j; a tile walks up to its last row's bound, capped at
// maxp * page, the positions the plain version has (a rider row's
// lengths + K may pass its table).  A table entry outside [0, P) traps
// instead of reading outside the pool.  Built for head width 128 with q in
// fp32 and bf16, pools of q's type or int8, any K.

#include "attend_mma.cuh"

namespace repro_torch {
namespace {
constexpr int kMaxRows = 64;   // query rows (tokens x query heads) per fp32 tile

bool bad_shape(int dtype, int B, int K, int H, int Hkv, int D, int page, int maxp) {
  const long long tile = dtype == 1 ? mma::kTileRows : kMaxRows;
  return D != 128 || B < 1 || K < 1 || Hkv < 1 || H % Hkv != 0 || page < 1 || maxp < 1 ||
         (long long)K * (H / Hkv) > 65535LL * tile;     // grid z limit
}

// q in fp32 on the CUDA-core body; the pools' source policy `src`
template <class Src>
int launch_fp32(const void* q, Src src, const void* block_tables, const void* lengths,
                void* out, int B, int K, int H, int Hkv, int page, int maxp, int P, float scale,
                int device, void* stream) {
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  const PagedKv kv{static_cast<const int*>(block_tables), page, maxp, P};
  return launch_attend<float, 128, kMaxRows>(q, src, static_cast<const int*>(lengths), out, B,
                                             H, Hkv, K, 1, 0, scale, kv, device,
                                             static_cast<cudaStream_t>(stream));
}

// q in bf16 on the tensor-core body
template <class Src>
int launch_bf16(const void* q, Src src, const void* block_tables, const void* lengths,
                void* out, int B, int K, int H, int Hkv, int page, int maxp, int P, float scale,
                int device, void* stream) {
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  const PagedKv kv{static_cast<const int*>(block_tables), page, maxp, P};
  return mma::launch_verify_mma<128>(q, src, static_cast<const int*>(lengths), out, B, H, Hkv,
                                     K, scale, kv, device, static_cast<cudaStream_t>(stream));
}

}  // namespace
}  // namespace repro_torch

// dtype (q's and out's): 0 = float32, 1 = bfloat16, the pools of the same
// type.  D must be 128.  q (B, K, H, D), block_tables (B, maxp) and
// lengths (B,) int32 (valid tokens before the K new ones).  Returns the
// CUDA error of the launch (0 on success).
extern "C" int paged_verify_fwd(const void* q, const void* k_pool, const void* v_pool,
                                const void* block_tables, const void* lengths, void* out,
                                int dtype, int B, int K, int H, int Hkv, int D, int page,
                                int maxp, int P, float scale, int device, void* stream) {
  using namespace repro_torch;
  if (bad_shape(dtype, B, K, H, Hkv, D, page, maxp)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_fp32(q, FpKv<float>{static_cast<const float*>(k_pool),
                                      static_cast<const float*>(v_pool)},
                       block_tables, lengths, out, B, K, H, Hkv, page, maxp, P, scale, device,
                       stream);
  if (dtype == 1)
    return launch_bf16(q, mma::Bf16Pages{static_cast<const __nv_bfloat16*>(k_pool),
                                         static_cast<const __nv_bfloat16*>(v_pool)},
                       block_tables, lengths, out, B, K, H, Hkv, page, maxp, P, scale, device,
                       stream);
  return (int)cudaErrorInvalidValue;
}

// As paged_verify_fwd with int8 pools (P, page, Hkv, D) and bf16 scale
// pools (P, page, Hkv, 1); dtype is q's and out's.
extern "C" int paged_verify_int8_fwd(const void* q, const void* k_pool, const void* v_pool,
                                     const void* k_scale, const void* v_scale,
                                     const void* block_tables, const void* lengths, void* out,
                                     int dtype, int B, int K, int H, int Hkv, int D, int page,
                                     int maxp, int P, float scale, int device, void* stream) {
  using namespace repro_torch;
  if (bad_shape(dtype, B, K, H, Hkv, D, page, maxp)) return (int)cudaErrorInvalidValue;
  const auto* k8 = static_cast<const int8_t*>(k_pool);
  const auto* v8 = static_cast<const int8_t*>(v_pool);
  const auto* ks = static_cast<const __nv_bfloat16*>(k_scale);
  const auto* vs = static_cast<const __nv_bfloat16*>(v_scale);
  if (dtype == 0)
    return launch_fp32(q, Int8Kv{k8, v8, ks, vs}, block_tables, lengths, out, B, K, H, Hkv,
                       page, maxp, P, scale, device, stream);
  if (dtype == 1)
    return launch_bf16(q, mma::Int8Pages{k8, v8, ks, vs}, block_tables, lengths, out, B, K, H,
                       Hkv, page, maxp, P, scale, device, stream);
  return (int)cudaErrorInvalidValue;
}
