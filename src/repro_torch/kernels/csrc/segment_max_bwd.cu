// Backward of the per-destination max: d_data[e] = g[r] * (data[e] ==
// fwd[r]) with r = edge_dst[e], the gather of each output row's cotangent
// onto the edges that attain the row's max.
//
// Replaces: src/repro/kernels/backward.py, segment_max_bwd_csc (body
// _gather_max_bwd_kernel), the TPU kernel that tiles the edge axis and
// gathers rows of VMEM-resident cotangent and forward-output blocks
// through the plan's scalar-prefetched inverse map, masking by the
// argmax hit.
//
// Semantics kept from the TPU kernel:
// - the row lookup clips, as jnp.take(..., mode="clip") does, so a
//   bucket's pad edge (edge_dst = N, see kernels/plan.py) reads row N - 1;
// - every entry equal to its row's max gets the row's full cotangent: ties
//   do not split it (the reference backend's rule does, ROADMAP C.1);
// - the mask multiplies (g * 1 or g * 0), as the TPU kernel's
//   ge * (data == fe).astype(...) does, and a NaN entry equals nothing.
// The wrapper (kernels/ops.py) returns an empty tensor without a launch
// when there are no edges, and zeros when N = 0.
//
// Bound on the H100: bytes. Each edge's data row is read and its output
// row written once, and the cotangent and forward-output rows and the
// inverse map are read; one compare and one multiply per element, so the
// floor is (2*E*D + 2*N*D) * 4 + E * 4 bytes over 3.35 TB/s.
//
// Design: edge-parallel and scatter-free: one thread per (edge, column)
// element, 16-byte loads and stores when D % 4 == 0, so a warp reads and
// writes whole 128-byte lines; each output element has one writer and no
// atomics, so the result is the same on every run. The cotangent and
// forward rows that many edges share stay in L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float hit(float g, float d, float f) {
  return g * (d == f ? 1.f : 0.f);
}

__device__ __forceinline__ float4 hit(const float4& g, const float4& d,
                                      const float4& f) {
  return make_float4(hit(g.x, d.x, f.x), hit(g.y, d.y, f.y),
                     hit(g.z, d.z, f.z), hit(g.w, d.w, f.w));
}

// T is float4 (D % 4 == 0, 16-byte aligned) or float; `width` counts Ts.
template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_max_bwd_kernel(const T* __restrict__ g, const T* __restrict__ fwd,
                       const T* __restrict__ data,
                       const int* __restrict__ edge_dst,
                       T* __restrict__ out, int64_t num_edges,
                       int64_t num_segments, int64_t width) {
  const int64_t total = num_edges * width;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x; t < total;
       t += stride) {
    const int64_t e = t / width;
    const int64_t c = t - e * width;
    int64_t row = edge_dst[e];
    if (row > num_segments - 1) row = num_segments - 1;  // clip, as on the TPU
    const int64_t r = row * width + c;
    out[t] = hit(g[r], data[t], fwd[r]);
  }
}

}  // namespace

// g, fwd (num_segments, dim) f32, data (num_edges, dim) f32, edge_dst
// (num_edges,) int32 -> out (num_edges, dim) f32. Returns
// cudaGetLastError().
extern "C" int segment_max_bwd_f32(const void* g, const void* fwd,
                                   const void* data, const void* edge_dst,
                                   void* out, int64_t num_edges,
                                   int64_t num_segments, int64_t dim,
                                   void* stream) {
  if (num_edges <= 0 || num_segments <= 0 || dim <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = dim % 4 == 0 && (uintptr_t)g % 16 == 0 &&
                    (uintptr_t)fwd % 16 == 0 && (uintptr_t)data % 16 == 0 &&
                    (uintptr_t)out % 16 == 0;
  const int64_t width = vec4 ? dim / 4 : dim;
  int64_t blocks = (num_edges * width + kThreads - 1) / kThreads;
  if (blocks > (int64_t)1 << 30) blocks = (int64_t)1 << 30;  // grid-stride
  const dim3 grid((unsigned)blocks), block(kThreads);
  if (vec4) {
    segment_max_bwd_kernel<float4><<<grid, block, 0, s>>>(
        static_cast<const float4*>(g), static_cast<const float4*>(fwd),
        static_cast<const float4*>(data), static_cast<const int*>(edge_dst),
        static_cast<float4*>(out), num_edges, num_segments, width);
  } else {
    segment_max_bwd_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(fwd),
        static_cast<const float*>(data), static_cast<const int*>(edge_dst),
        static_cast<float*>(out), num_edges, num_segments, width);
  }
  return (int)cudaGetLastError();
}
