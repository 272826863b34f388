// Shared helpers for the port's attention kernels: 16-byte vector loads of
// fp32 from device memory (the CUDA-core body's element type), and the
// asynchronous-copy and bf16-packing steps of the tensor-core bodies.
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

// The finite "masked" score of the plain versions (repro_torch.models.attention):
// exp() of it underflows to exactly 0 once any real score is seen, and a row
// with no real score averages V uniformly instead of turning NaN.
constexpr float kNegInf = -1e30f;

// -inf: the score of a key that does not exist (past the sequence or the
// block table), which takes no weight even in a row with no real score
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <typename T> struct Elem;

template <> struct Elem<float> {
  static constexpr int kVec = 4;  // elements per 16-byte load
  __device__ static __forceinline__ void load_vec(const float* src, float* dst) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
  __device__ static __forceinline__ float store(float x) { return x; }
};

constexpr int kMaxDevices = 64;

// Make `device` current, without a cudaSetDevice when it already is.
inline cudaError_t use_device(int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  return cur == device ? cudaSuccess : cudaSetDevice(device);
}

// Raise a kernel's dynamic shared-memory cap to `bytes` on `device`, once per
// device and kernel (the caller keeps `done`, one flag per device): the
// attribute persists, so later launches skip the call.
template <typename Kernel>
cudaError_t allow_smem_once(Kernel kernel, size_t bytes, int device, bool* done) {
  if (done[device]) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) done[device] = true;
  return e;
}

// ---- bf16 tensor-core staging helpers (sm_80+ instructions, used on sm_90a)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from device memory to shared memory asynchronously; with
// `valid` false, write 16 zero bytes instead (src is not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed cp.async groups of this thread are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two floats rounded to bf16 (nearest even), `lo` in the low half: the
// order a tensor-core fragment holds neighbouring columns in.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace repro_torch
