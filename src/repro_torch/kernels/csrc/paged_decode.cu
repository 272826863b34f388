// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_decode.py ·
// flash_paged_decode_tpu (wrapper _paged_attention, body _paged_kernel with
// quant=False): one query token per row attends to the row's KV, which lives
// in a shared pool of fixed-size pages (P, page, Hkv, D) reached through the
// row's block table (B, maxp); positions k < lengths[b] are valid.
//
// What bounds it on this card: every valid K/V element is read once and used
// for 2 * rep operations (rep = H / Hkv query heads share it), about 4
// operations per bf16 byte, far below the H100's ~295, so it is bound by
// the bytes of the pages it reads (3.35 TB/s).
//
// Design (the shared body in attend.cuh, with K = 1 query per row):
// * One block per (kv head, batch row), 128 threads.  The block reads the
//   row's block-table entries itself (the TPU kernel prefetched them as
//   scalars) and stages 64 key positions at a time into shared memory with
//   16-byte loads, resolving each position's page through the table; the
//   rep query heads share each staged chunk, and a row walks only the pages
//   its length covers.
// * A row of length 0 has no valid key and averages V over every position
//   of its table (maxp * page, pad entries on the scratch page 0 included),
//   as the gather-then-softmax plain version does; it reads V only.
// * A table entry outside [0, P) traps instead of reading outside the pool.
// * Built for head width 128 in fp32 and bf16, up to 16 query heads per kv
//   head.

#include "attend.cuh"

namespace repro_torch {
namespace {
constexpr int kMaxRep = 16;    // query heads per kv head this kernel takes
}  // namespace
}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16.  D must be 128.  block_tables (B, maxp)
// and lengths (B,) are int32.  Returns the CUDA error of the launch (0 on
// success).
extern "C" int paged_decode_fwd(const void* q, const void* k_pool, const void* v_pool,
                                const void* block_tables, const void* lengths, void* out,
                                int dtype, int B, int H, int Hkv, int D, int page, int maxp,
                                int P, float scale, int device, void* stream) {
  using namespace repro_torch;
  if (D != 128 || H % Hkv != 0 || H / Hkv > kMaxRep || page < 1 || maxp < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lengths);
  const PagedKv kv{static_cast<const int*>(block_tables), page, maxp, P};
  if (dtype == 0)
    return launch_attend<float, 128, kMaxRep>(q, k_pool, v_pool, ln, out, B, H, Hkv, 1, 0, 0,
                                              scale, kv, device, st);
  if (dtype == 1)
    return launch_attend<__nv_bfloat16, 128, kMaxRep>(q, k_pool, v_pool, ln, out, B, H, Hkv, 1,
                                                      0, 0, scale, kv, device, st);
  return (int)cudaErrorInvalidValue;
}
