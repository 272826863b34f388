// Paged multi-token verify attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/spec_verify.py ·
// flash_paged_verify_tpu (body _verify_kernel, wrapper _paged_attention in
// paged_decode.py) with fp pools: speculative decoding verifies K = spec_k
// + 1 tokens per row (the pending token and the drafts) in one target
// forward.  Their KV is already in the page pool (P, page, Hkv, D) at
// positions lengths[b] .. lengths[b] + K - 1, reached through the row's
// block table (B, maxp); query j attends positions <= lengths[b] + j.
//
// What bounds it on this card: each K/V element is read once and used for
// 2 * K * rep operations (20 query rows for qwen3-8b with spec_k 4), about
// 20 operations per bf16 byte, still far below the ~295 the H100 needs, so
// the bytes of the pages it reads bound it (3.35 TB/s).
//
// Design (the shared body in attend.cuh): one block per (kv head, batch
// row), whose K * rep query rows (every verify token of every query head
// of the group) share each staged 64-position chunk, so the row's pages are
// read once per verify, not once per token.  Each query row carries its own
// causal bound lengths[b] + j; the walk stops at min(lengths[b] + K,
// maxp * page), the positions the plain version has (a rider row's
// lengths + K may pass its table).  A table entry outside [0, P) traps
// instead of reading outside the pool.  Built for head width 128 in fp32
// and bf16, up to 64 query rows (K * H / Hkv) per block.

#include "attend.cuh"

namespace repro_torch {
namespace {
constexpr int kMaxRows = 64;   // verify tokens x query heads per kv head
}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16.  D must be 128.  q (B, K, H, D),
// block_tables (B, maxp) and lengths (B,) int32 (valid tokens before the K
// new ones).  Returns the CUDA error of the launch (0 on success).
extern "C" int paged_verify_fwd(const void* q, const void* k_pool, const void* v_pool,
                                const void* block_tables, const void* lengths, void* out,
                                int dtype, int B, int K, int H, int Hkv, int D, int page,
                                int maxp, int P, float scale, int device, void* stream) {
  using namespace repro_torch;
  if (D != 128 || K < 1 || H % Hkv != 0 || K * (H / Hkv) > kMaxRows || page < 1 || maxp < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lengths);
  const PagedKv kv{static_cast<const int*>(block_tables), page, maxp, P};
  if (dtype == 0)
    return launch_attend<float, 128, kMaxRows>(q, k_pool, v_pool, ln, out, B, H, Hkv, K, 1, 0,
                                               scale, kv, device, st);
  if (dtype == 1)
    return launch_attend<__nv_bfloat16, 128, kMaxRows>(q, k_pool, v_pool, ln, out, B, H, Hkv,
                                                       K, 1, 0, scale, kv, device, st);
  return (int)cudaErrorInvalidValue;
}
