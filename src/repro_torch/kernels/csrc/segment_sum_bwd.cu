// Backward of the per-destination sum: d_data[e] = g[edge_dst[e]], the
// gather of each output row's cotangent onto the edges that fed it.
//
// Replaces: src/repro/kernels/backward.py, segment_sum_bwd_csc (body
// _gather_bwd_kernel), the TPU kernel that tiles the edge axis and gathers
// rows of a VMEM-resident cotangent block through the plan's scalar-
// prefetched inverse map.
//
// Semantics kept from the TPU kernel: the gather clips, as jnp.take(...,
// mode="clip") does, so an edge whose edge_dst is N (a bucket's pad edge,
// see kernels/plan.py) reads row N - 1. The output has the plan's edge
// count. The wrapper (kernels/ops.py) returns an empty tensor without a
// launch when there are no edges, and zeros when N = 0.
//
// Bound on the H100: bytes. Each edge's output row is written once, and
// the cotangent rows and the inverse map are read; there is no arithmetic,
// so the floor is (E*D + N*D + E) * 4 bytes over 3.35 TB/s.
//
// Design: edge-parallel and scatter-free. One thread per (edge, column)
// element, with 16-byte loads and stores when D % 4 == 0, so a warp writes
// whole 128-byte lines of the output and reads whole lines of a cotangent
// row; GCN's D = 128 gives one edge per warp. Each output element is
// written by one thread, with no atomics, so the result is deterministic.
// Rows of g that many edges share stay in L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// T is float4 (D % 4 == 0, 16-byte aligned) or float; `width` counts Ts.
template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_bwd_kernel(const T* __restrict__ g,
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
    out[t] = g[row * width + c];
  }
}

}  // namespace

// g (num_segments, dim) f32, edge_dst (num_edges,) int32
// -> out (num_edges, dim) f32. Returns cudaGetLastError().
extern "C" int segment_sum_bwd_f32(const void* g, const void* edge_dst,
                                   void* out, int64_t num_edges,
                                   int64_t num_segments, int64_t dim,
                                   void* stream) {
  if (num_edges <= 0 || num_segments <= 0 || dim <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = dim % 4 == 0 && (uintptr_t)g % 16 == 0 &&
                    (uintptr_t)out % 16 == 0;
  const int64_t width = vec4 ? dim / 4 : dim;
  int64_t blocks = (num_edges * width + kThreads - 1) / kThreads;
  if (blocks > (int64_t)1 << 30) blocks = (int64_t)1 << 30;  // grid-stride
  const dim3 grid((unsigned)blocks), block(kThreads);
  if (vec4) {
    segment_sum_bwd_kernel<float4><<<grid, block, 0, s>>>(
        static_cast<const float4*>(g), static_cast<const int*>(edge_dst),
        static_cast<float4*>(out), num_edges, num_segments, width);
  } else {
    segment_sum_bwd_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(g), static_cast<const int*>(edge_dst),
        static_cast<float*>(out), num_edges, num_segments, width);
  }
  return (int)cudaGetLastError();
}
