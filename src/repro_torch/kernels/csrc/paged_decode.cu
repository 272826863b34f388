// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_decode.py ·
// flash_paged_decode_tpu (wrapper _paged_attention, body _paged_kernel),
// in both its forms: one query token per row attends to the row's KV, which
// lives in a shared pool of fixed-size pages (P, page, Hkv, D) reached
// through the row's block table (B, maxp); positions k < lengths[b] are
// valid.  paged_decode_fwd takes pools of q's type (quant=False);
// paged_decode_int8_fwd takes int8 pools with bf16 scale pools
// (P, page, Hkv, 1) riding the same table (quant=True, k_scale/v_scale),
// each element dequantized to fp32 as it is staged.
//
// What bounds it on this card: every valid K/V element is read once and used
// for 2 * rep operations (rep = H / Hkv query heads share it), about 4
// operations per bf16 byte (8 per int8 byte, plus one multiply to
// dequantize), far below the H100's ~295, so it is bound by the bytes of
// the pages it reads (3.35 TB/s): int8 pages halve them.
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
// * Built for head width 128 with q in fp32 and bf16, pools of q's type or
//   int8, up to 16 query heads per kv head.

#include "attend.cuh"

namespace repro_torch {
namespace {
constexpr int kMaxRep = 16;    // query heads per kv head this kernel takes

bool bad_shape(int B, int H, int Hkv, int D, int page, int maxp) {
  return D != 128 || B < 1 || Hkv < 1 || H % Hkv != 0 || H / Hkv > kMaxRep || page < 1 ||
         maxp < 1;
}

template <class Src>
int launch_paged(const void* q, Src src, const void* block_tables, const void* lengths,
                 void* out, int dtype, int B, int H, int Hkv, int page, int maxp, int P,
                 float scale, int device, void* stream) {
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lengths);
  const PagedKv kv{static_cast<const int*>(block_tables), page, maxp, P};
  if (dtype == 0)
    return launch_attend<float, 128, kMaxRep>(q, src, ln, out, B, H, Hkv, 1, 0, 0, scale, kv,
                                              device, st);
  if (dtype == 1)
    return launch_attend<__nv_bfloat16, 128, kMaxRep>(q, src, ln, out, B, H, Hkv, 1, 0, 0,
                                                      scale, kv, device, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// dtype (q's and out's): 0 = float32, 1 = bfloat16, the pools of the same
// type.  D must be 128.  block_tables (B, maxp) and lengths (B,) are int32.
// Returns the CUDA error of the launch (0 on success).
extern "C" int paged_decode_fwd(const void* q, const void* k_pool, const void* v_pool,
                                const void* block_tables, const void* lengths, void* out,
                                int dtype, int B, int H, int Hkv, int D, int page, int maxp,
                                int P, float scale, int device, void* stream) {
  using namespace repro_torch;
  if (bad_shape(B, H, Hkv, D, page, maxp)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_paged(q, FpKv<float>{static_cast<const float*>(k_pool),
                                       static_cast<const float*>(v_pool)},
                        block_tables, lengths, out, dtype, B, H, Hkv, page, maxp, P, scale,
                        device, stream);
  if (dtype == 1)
    return launch_paged(q, FpKv<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(k_pool),
                                               static_cast<const __nv_bfloat16*>(v_pool)},
                        block_tables, lengths, out, dtype, B, H, Hkv, page, maxp, P, scale,
                        device, stream);
  return (int)cudaErrorInvalidValue;
}

// As paged_decode_fwd with int8 pools (P, page, Hkv, D) and bf16 scale
// pools (P, page, Hkv, 1); dtype is q's and out's.
extern "C" int paged_decode_int8_fwd(const void* q, const void* k_pool, const void* v_pool,
                                     const void* k_scale, const void* v_scale,
                                     const void* block_tables, const void* lengths, void* out,
                                     int dtype, int B, int H, int Hkv, int D, int page,
                                     int maxp, int P, float scale, int device, void* stream) {
  using namespace repro_torch;
  if (bad_shape(B, H, Hkv, D, page, maxp)) return (int)cudaErrorInvalidValue;
  const Int8Kv src{static_cast<const int8_t*>(k_pool), static_cast<const int8_t*>(v_pool),
                   static_cast<const __nv_bfloat16*>(k_scale),
                   static_cast<const __nv_bfloat16*>(v_scale)};
  return launch_paged(q, src, block_tables, lengths, out, dtype, B, H, Hkv, page, maxp, P,
                      scale, device, stream);
}
