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
// the pages it reads (3.35 TB/s): int8 pages halve them.  At the serve
// shapes (4 rows of ~30 positions) the latency of a one-chunk walk bounds
// it, and with a few long rows, the number of blocks in flight.
//
// Design.  q in bf16 over bf16 pools (the serve dtype) runs the
// tensor-core body of decode_mma.cuh: blocks of 4 warps per (kv head,
// batch row, split), the rep query heads one 16-row MMA slice, K/V chunks
// staged as bf16 by a 3-stage cp.async ring straight from the pages, the
// online softmax in registers; when B * Hkv blocks cannot fill the card, a
// row's table is cut into splits (chosen on the host from B, Hkv and
// maxp * page) merged by a second, small kernel.  q in fp32, and the int8
// pools in both types, stay on attend.cuh's CUDA-core body (one block per
// (kv head, batch row), fp32 FMAs; the int8 form is redesigned next): TF32
// or bf16 tensor-core inputs would not hold the fp32 tolerance of 1e-4.
// Either way:
// * the block reads the row's block-table entries itself (the TPU kernel
//   prefetched them as scalars) and resolves each staged position's page
//   through the table; the rep query heads share each staged chunk, and a
//   row walks only the pages its length covers;
// * a row of length 0 has no valid key and averages V over every position
//   of its table (maxp * page, pad entries on the scratch page 0 included),
//   as the gather-then-softmax plain version does; it reads V only;
// * a table entry outside [0, P) traps instead of reading outside the pool;
// * built for head width 128 with q in fp32 and bf16, pools of q's type or
//   int8, up to 16 query heads per kv head.

#include "decode_mma.cuh"

namespace repro_torch {
namespace {
constexpr int kMaxRep = 16;    // query heads per kv head this kernel takes

bool bad_shape(int B, int H, int Hkv, int D, int page, int maxp) {
  return D != 128 || B < 1 || Hkv < 1 || H % Hkv != 0 || H / Hkv > kMaxRep || page < 1 ||
         maxp < 1;
}

// q of type T on the CUDA-core body: fp32 over any pools, bf16 over int8
template <typename T, class Src>
int launch_attend_paged(const void* q, Src src, const void* block_tables, const void* lengths,
                        void* out, int B, int H, int Hkv, int page, int maxp, int P, float scale,
                        int device, void* stream) {
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  const PagedKv kv{static_cast<const int*>(block_tables), page, maxp, P};
  return launch_attend<T, 128, kMaxRep>(q, src, static_cast<const int*>(lengths), out, B, H, Hkv,
                                        1, 0, 0, scale, kv, device,
                                        static_cast<cudaStream_t>(stream));
}

}  // namespace
}  // namespace repro_torch

// dtype (q's and out's): 0 = float32, 1 = bfloat16, the pools of the same
// type.  D must be 128.  block_tables (B, maxp) and lengths (B,) are int32.
// splits: blocks a row's maxp * page positions are cut across (bf16 only;
// fp32 takes 1), split z walking positions [z * span, (z + 1) * span), so
// splits * span must reach maxp * page; with more than one, workspace
// holds B * H * splits * (D + 2) floats (uninitialised: every split writes
// its partial).  Returns the CUDA error of the launch (0 on success).
extern "C" int paged_decode_fwd(const void* q, const void* k_pool, const void* v_pool,
                                const void* block_tables, const void* lengths, void* out,
                                void* workspace, int dtype, int B, int H, int Hkv, int D,
                                int page, int maxp, int P, int splits, int span, float scale,
                                int device, void* stream) {
  using namespace repro_torch;
  if (bad_shape(B, H, Hkv, D, page, maxp) || splits < 1 || splits > 65535 || span < 1 ||
      (long long)splits * span < (long long)maxp * page ||
      (splits > 1 && (dtype != 1 || workspace == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_attend_paged<float>(q, FpKv<float>{static_cast<const float*>(k_pool),
                                                     static_cast<const float*>(v_pool)},
                                      block_tables, lengths, out, B, H, Hkv, page, maxp, P,
                                      scale, device, stream);
  if (dtype == 1) {
    const cudaError_t e = use_device(device);
    if (e != cudaSuccess) return (int)e;
    const PagedKv kv{static_cast<const int*>(block_tables), page, maxp, P};
    return mma::launch_decode_mma<128>(q, k_pool, v_pool, static_cast<const int*>(lengths), out,
                                       workspace, B, H, Hkv, 0, splits, span, scale, kv, device,
                                       static_cast<cudaStream_t>(stream));
  }
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
  if (dtype == 0)
    return launch_attend_paged<float>(q, src, block_tables, lengths, out, B, H, Hkv, page, maxp,
                                      P, scale, device, stream);
  if (dtype == 1)
    return launch_attend_paged<__nv_bfloat16>(q, src, block_tables, lengths, out, B, H, Hkv,
                                              page, maxp, P, scale, device, stream);
  return (int)cudaErrorInvalidValue;
}
