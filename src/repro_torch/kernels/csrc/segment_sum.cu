// Per-destination sum of edge messages: the Sum stage of GCN and of SAGE
// with sum or mean combine.
//
// Replaces: src/repro/kernels/segment_sum.py, segment_sum_csc (body
// _segment_sum_kernel), the TPU kernel that sums the messages of each
// 128-row destination block as a one-hot matmul on the MXU.
//
// Bound on the H100: bytes. Each message row is read once and each
// output row written once; there is one add per element read, far below
// the card's 67 TFLOP/s of float32, so the floor is
// (E*D + N*D) * 4 bytes (plus the plan's 4 bytes per edge and row) over
// 3.35 TB/s.
//
// Design: one warp per destination row, walking the row's edges
// perm[indptr[i]:indptr[i+1]] in plan order. The warp loads 32 edge ids
// at a time (one per lane) and broadcasts them with __shfl_sync; lanes
// stride over the feature axis with 16-byte loads when D % 4 == 0, so
// each message row is read in full 128-byte transactions and summed in
// registers. No shared memory and no atomics: the order of the sum is
// fixed by the plan, so the result is the same on every run, which is
// what lets a served cache hit equal a full recompute.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void add_to(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

__device__ __forceinline__ void add_to(float& acc, const float& v) {
  acc += v;
}

__device__ __forceinline__ void set_zero(float4& acc) {
  acc = make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void set_zero(float& acc) { acc = 0.f; }

// T is float4 (D % 4 == 0, 16-byte aligned) or float; `width` counts Ts.
template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
segment_sum_kernel(const T* __restrict__ data, const int* __restrict__ perm,
                   const int* __restrict__ indptr, T* __restrict__ out,
                   int64_t num_segments, int64_t width) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= num_segments) return;  // uniform across the warp
  const int64_t begin = indptr[row];
  const int64_t end = indptr[row + 1];
  for (int64_t c0 = 0; c0 < width; c0 += 32) {
    const int64_t c = c0 + lane;
    const bool active = c < width;
    T acc;
    set_zero(acc);
    for (int64_t base = begin; base < end; base += 32) {
      const int mine = (base + lane < end) ? perm[base + lane] : 0;
      const int n = end - base < 32 ? (int)(end - base) : 32;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int64_t e = __shfl_sync(kFullMask, mine, j);
        if (active) add_to(acc, data[e * width + c]);
      }
    }
    if (active) out[row * width + c] = acc;
  }
}

}  // namespace

// data (E, dim) f32, perm (E,) int32, indptr (num_segments+1,) int32
// -> out (num_segments, dim) f32. Returns cudaGetLastError().
extern "C" int segment_sum_f32(const void* data, const void* perm,
                               const void* indptr, void* out,
                               int64_t num_segments, int64_t dim,
                               void* stream) {
  if (num_segments <= 0 || dim <= 0) return 0;
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid(
      (unsigned)((num_segments + kWarpsPerBlock - 1) / kWarpsPerBlock));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = dim % 4 == 0 && (uintptr_t)data % 16 == 0 &&
                    (uintptr_t)out % 16 == 0;
  if (vec4) {
    segment_sum_kernel<float4><<<grid, block, 0, s>>>(
        static_cast<const float4*>(data), static_cast<const int*>(perm),
        static_cast<const int*>(indptr), static_cast<float4*>(out),
        num_segments, dim / 4);
  } else {
    segment_sum_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(data), static_cast<const int*>(perm),
        static_cast<const int*>(indptr), static_cast<float*>(out),
        num_segments, dim);
  }
  return (int)cudaGetLastError();
}
