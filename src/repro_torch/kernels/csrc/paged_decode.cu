// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_decode.py ·
// flash_paged_decode_tpu (wrapper _paged_attention, body _paged_kernel),
// in both its forms: one query token per row attends to the row's KV, which
// lives in a shared pool of fixed-size pages (P, page, Hkv, D) reached
// through the row's block table (B, maxp); positions k < lengths[b] are
// valid.  paged_decode_fwd takes pools of q's type (quant=False);
// paged_decode_int8_fwd takes int8 pools with bf16 scale pools
// (P, page, Hkv, 1) riding the same table (quant=True, k_scale/v_scale).
//
// What bounds it on this card: every valid K/V element is read once and used
// for 2 * rep operations (rep = H / Hkv query heads share it), about 4
// operations per bf16 byte (8 per int8 byte), far below the H100's ~295,
// so it is bound by the bytes of the pages it reads (3.35 TB/s): int8
// pages halve them.  At the serve shapes (4 rows of ~30 positions) the
// latency of a one-chunk walk bounds it, and with a few long rows, the
// number of blocks in flight.
//
// Design.  q in bf16 (the serve dtype), over bf16 pools or int8 ones, runs
// the tensor-core body of decode_mma.cuh: blocks of 4 warps per (kv head,
// batch row, split), the rep query heads one 16-row MMA slice, K/V chunks
// staged by a 3-stage cp.async ring straight from the pages (DecodeBf16:
// bf16; DecodeInt8: the raw int8 bytes and their scales, each warp's
// positions converted to bf16 exactly once they land, the scales folded
// into the scores and into P), the online softmax in registers; when B *
// Hkv blocks cannot fill the card, a row's table is cut into splits
// (chosen on the host from B, Hkv and maxp * page) merged by a second,
// small kernel.  q in fp32, over fp32 or int8 pools, stays on attend.cuh's
// CUDA-core body (one block per (kv head, batch row), fp32 FMAs, int8
// dequantized to fp32 as it is staged): TF32 or bf16 tensor-core inputs
// would not hold the fp32 tolerance of 1e-4.  Either way:
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

bool bad_splits(int dtype, int page, int maxp, int splits, int span, const void* workspace) {
  return splits < 1 || splits > 65535 || span < 1 ||
         (long long)splits * span < (long long)maxp * page ||
         (splits > 1 && (dtype != 1 || workspace == nullptr));
}

// q in fp32 on the CUDA-core body, over fp32 or int8 pools
template <class Src>
int launch_fp32(const void* q, Src src, const void* block_tables, const void* lengths, void* out,
                int B, int H, int Hkv, int page, int maxp, int P, float scale, int device,
                void* stream) {
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  const PagedKv kv{static_cast<const int*>(block_tables), page, maxp, P};
  return launch_attend<float, 128, kMaxRep>(q, src, static_cast<const int*>(lengths), out, B, H,
                                            Hkv, 1, 0, 0, scale, kv, device,
                                            static_cast<cudaStream_t>(stream));
}

// q in bf16 on the tensor-core body, over bf16 or int8 pools
template <class Src>
int launch_bf16(const void* q, Src src, const void* block_tables, const void* lengths, void* out,
                void* workspace, int B, int H, int Hkv, int page, int maxp, int P, int splits,
                int span, float scale, int device, void* stream) {
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  const PagedKv kv{static_cast<const int*>(block_tables), page, maxp, P};
  return mma::launch_decode_mma<128>(q, src, static_cast<const int*>(lengths), out, workspace, B,
                                     H, Hkv, 0, splits, span, scale, kv, device,
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
  if (bad_shape(B, H, Hkv, D, page, maxp) || bad_splits(dtype, page, maxp, splits, span, workspace))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_fp32(q, FpKv<float>{static_cast<const float*>(k_pool),
                                      static_cast<const float*>(v_pool)},
                       block_tables, lengths, out, B, H, Hkv, page, maxp, P, scale, device,
                       stream);
  if (dtype == 1)
    return launch_bf16(q, mma::DecodeBf16{static_cast<const __nv_bfloat16*>(k_pool),
                                          static_cast<const __nv_bfloat16*>(v_pool)},
                       block_tables, lengths, out, workspace, B, H, Hkv, page, maxp, P, splits,
                       span, scale, device, stream);
  return (int)cudaErrorInvalidValue;
}

// As paged_decode_fwd with int8 pools (P, page, Hkv, D) and bf16 scale
// pools (P, page, Hkv, 1); dtype is q's and out's, and splits, span and
// workspace are as there (bf16 only).
extern "C" int paged_decode_int8_fwd(const void* q, const void* k_pool, const void* v_pool,
                                     const void* k_scale, const void* v_scale,
                                     const void* block_tables, const void* lengths, void* out,
                                     void* workspace, int dtype, int B, int H, int Hkv, int D,
                                     int page, int maxp, int P, int splits, int span,
                                     float scale, int device, void* stream) {
  using namespace repro_torch;
  if (bad_shape(B, H, Hkv, D, page, maxp) || bad_splits(dtype, page, maxp, splits, span, workspace))
    return (int)cudaErrorInvalidValue;
  const auto* k8 = static_cast<const int8_t*>(k_pool);
  const auto* v8 = static_cast<const int8_t*>(v_pool);
  const auto* ks = static_cast<const __nv_bfloat16*>(k_scale);
  const auto* vs = static_cast<const __nv_bfloat16*>(v_scale);
  if (dtype == 0)
    return launch_fp32(q, Int8Kv{k8, v8, ks, vs}, block_tables, lengths, out, B, H, Hkv, page,
                       maxp, P, scale, device, stream);
  if (dtype == 1)
    return launch_bf16(q, mma::DecodeInt8{k8, v8, ks, vs, (size_t)P * page * Hkv}, block_tables,
                       lengths, out, workspace, B, H, Hkv, page, maxp, P, splits, span, scale,
                       device, stream);
  return (int)cudaErrorInvalidValue;
}
