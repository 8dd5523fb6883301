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
// Bound on the H100: bytes. The function needs each cotangent row and one
// E-long index read once and each edge's output row written once, whichever
// schedule runs; there is no arithmetic, so the floor is
// (E*D + N*D + E) * 4 bytes over 3.35 TB/s. (The rows schedule reads
// indptr and piece_ptr besides perm, N + 1 ints more.)
//
// Design: two schedules of one copy, each output element written by one
// lane, with no atomics, so the result is bitwise the plain version's.
// Lanes hold 16-byte groups of 4 floats (row_pieces.cuh's load4/store4),
// a row of G = ceil(D / 4) groups taking a sub-warp of L lanes, L the
// power of two >= G (at most 32), S = 32 / L sub-warps a warp.
// - Rows (where a row of g is 64 bytes or more): the destination plan's
//   rows and pieces (row_pieces.cuh). A row warp takes S consecutive
//   rows, one row unit (a row's first kPiece edges) per sub-warp; a warp
//   takes each 64-edge piece of a long row, finding its row through
//   piece_ptr, and each kPiece of the pad edges perm[indptr[N]:E], which
//   read row N - 1 as the clip does; there its sub-warps take alternate
//   edges. The grid holds max_pieces piece warps and max_pad_runs run
//   warps (row_pieces.cuh's bounds from E); a warp past piece_ptr[N] or
//   past E exits. A lane loads its group of g[r] once
//   into registers and writes it to out[perm[k]] for each edge k of the
//   unit, kUnroll ids in flight. Each cotangent row is read once (once a
//   piece on a long row), perm and indptr sequentially: the bound's
//   bytes and indptr's. The edge gather reads a whole row of g per edge: past the L2
//   cache E*D*4 more bytes from device memory, and within it as many
//   from the L2.
// - Edges (narrower rows): a sub-warp per edge in edge order, reading its
//   row of g through edge_dst, so the output is written in order, whole
//   lines a warp. The rows' writes land at random edges: a row of 16
//   bytes half-fills a 32-byte sector, which the L2 completes by a read
//   from device memory, and one of 32 bytes is a lone sector.
// The switch (segment_sum_bwd_rows), measured on an H100 (80GB HBM3,
// 700 W) by phase 6 of chip_smoke.py, both schedules at D 4 to 128 on
// five plans whose g is 0.001 to 10 times the L2's 50 MB (PERF.md):
// rows win or tie from D 16 on every plan (1.6 times faster at D 128
// past the L2, 1.4 at the GCN cells' 2 MB), edges win at D 4 and 8 on
// every plan (1.2 to 6 times), past the L2 too (D 8 at 2.4 times its
// size: edges 0.93 ms, rows 1.15). The crossover is a row of 64 bytes,
// kRowsMinRowBytes, whatever the size of g against the L2. The system's
// one caller, the Sum stage's backward of GCN, sends D 128 (rows); no
// workload of it sends a row narrower than 16 floats today, so the edges
// schedule only keeps such calls at the edge-parallel form's speed.
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_pieces.cuh"

namespace {

using namespace row_pieces;

constexpr int kUnroll = 8;  // edge ids a lane loads at once
constexpr int64_t kRowsMinRowBytes = 64;  // rows from D = 16

// The warp's lanes over a row of `groups` groups.
struct Lanes {
  int lanes, subs, sub, li;
};

__device__ __forceinline__ Lanes lanes_of(int64_t groups, int lane) {
  const int l = pow2_lanes(groups);
  return {l, 32 / l, lane / l, lane % l};
}

// Edges perm[t0], perm[t0 + step], ... below b each get row `grow`: the
// lane's groups li, li + lanes, ...; kUnroll ids in flight, the next
// kUnroll loading while these stores go out.
template <bool kVec>
__device__ __forceinline__ void copy_row(const float* __restrict__ grow,
                                         const int* __restrict__ perm,
                                         int t0, int b, int step,
                                         float* __restrict__ out,
                                         int64_t dim, int64_t groups,
                                         Lanes ln) {
  for (int64_t c = ln.li; c < groups; c += ln.lanes) {
    const float4 v = load4<kVec>(grow, c, dim);
    int ids[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * step;
      ids[u] = t < b ? perm[t] : -1;
    }
    for (int t = t0; t < b; t += kUnroll * step) {
      int next[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int tn = t + (kUnroll + u) * step;
        next[u] = tn < b ? perm[tn] : -1;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (ids[u] >= 0) store4<kVec>(out + (int64_t)ids[u] * dim, c, dim, v);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) ids[u] = next[u];
    }
  }
}

struct Args {
  const float* g;
  const int *perm, *indptr, *piece_ptr, *edge_dst;
  float* out;
  int n;
  int64_t num_edges, max_pieces, dim, row_warps, warps;
};

// Warps: row_warps row warps of S row units each, then max_pieces for the
// pieces, then max_pad_runs for the kPiece-edge runs of pad edges; a
// warp with no piece or run exits.
template <bool kVec>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
segment_sum_bwd_rows_kernel(const Args p) {
  const int lane = threadIdx.x & 31;
  const int64_t k =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (k >= p.warps) return;  // uniform across the warp
  const int64_t groups = (p.dim + 3) / 4;
  const Lanes ln = lanes_of(groups, lane);
  int64_t r;
  int a, b, first, step;
  if (k < p.row_warps) {  // a row unit per sub-warp
    r = k * ln.subs + ln.sub;
    if (r >= p.n) return;  // no shuffle follows
    const Unit u = row_unit(p.indptr, p.piece_ptr, (int)r);
    a = u.a, b = u.b, first = a, step = 1;
  } else {  // a piece, or kPiece pad edges, by the whole warp
    const int64_t q = k - p.row_warps;
    if (q < p.max_pieces) {
      if (!has_piece(p.piece_ptr, p.n, q)) return;  // uniform
      const Unit u = piece_unit(p.indptr, p.piece_ptr, p.n, q, nullptr, lane);
      r = u.row, a = u.a, b = u.b;
    } else {
      const int64_t at = p.indptr[p.n] + (q - p.max_pieces) * kPiece;
      if (at >= p.num_edges) return;  // uniform
      r = p.n - 1;
      a = (int)at;
      b = (int)(at + kPiece < p.num_edges ? at + kPiece : p.num_edges);
    }
    first = a + ln.sub, step = ln.subs;
  }
  copy_row<kVec>(p.g + r * p.dim, p.perm, first, b, step, p.out, p.dim,
                 groups, ln);
}

// A sub-warp per edge, S edges a warp, in edge order.
template <bool kVec>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
segment_sum_bwd_edges_kernel(const Args p) {
  const int lane = threadIdx.x & 31;
  const int64_t groups = (p.dim + 3) / 4;
  const Lanes ln = lanes_of(groups, lane);
  const int64_t e =
      ((int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * ln.subs +
      ln.sub;
  if (e >= p.num_edges) return;
  int64_t r = p.edge_dst[e];
  if (r > p.n - 1) r = p.n - 1;  // clip, as on the TPU
  const float* grow = p.g + r * p.dim;
  float* orow = p.out + e * p.dim;
  for (int64_t c = ln.li; c < groups; c += ln.lanes)
    store4<kVec>(orow, c, p.dim, load4<kVec>(grow, c, p.dim));
}

template <bool kVec>
void launch(Args p, bool rows, cudaStream_t s) {
  const dim3 block(32 * kWarpsPerBlock);
  const int64_t subs = 32 / pow2_lanes((p.dim + 3) / 4);
  if (rows) {
    p.row_warps = (p.n + subs - 1) / subs;
    p.warps = p.row_warps + p.max_pieces + max_pad_runs(p.num_edges);
    segment_sum_bwd_rows_kernel<kVec><<<blocks_for(p.warps), block, 0, s>>>(p);
  } else {
    p.warps = (p.num_edges + subs - 1) / subs;
    segment_sum_bwd_edges_kernel<kVec><<<blocks_for(p.warps), block, 0, s>>>(p);
  }
}

}  // namespace

// The schedule rule: 1 (rows) for a cotangent of rows of dim floats,
// else 0 (edges).
extern "C" int64_t segment_sum_bwd_rows(int64_t dim) {
  return dim * 4 >= kRowsMinRowBytes;
}

// g (num_segments, dim) f32; perm and edge_dst (num_edges,), indptr and
// piece_ptr (num_segments+1,) int32, max_pieces (row_pieces.cuh's bound
// for num_edges edges) -> out (num_edges, dim) f32. rows: 1 walks the plan's rows (perm, indptr, piece_ptr), 0
// the edges (edge_dst), below 0 the rule's choice (segment_sum_bwd_rows).
// One launch on `stream`. Returns cudaGetLastError().
extern "C" int segment_sum_bwd_f32(const void* g, const void* perm,
                                   const void* indptr, const void* piece_ptr,
                                   const void* edge_dst, void* out,
                                   int64_t num_edges, int64_t num_segments,
                                   int64_t max_pieces, int64_t dim,
                                   int64_t rows, void* stream) {
  if (num_edges <= 0 || num_segments <= 0 || dim <= 0) return 0;
  const Args p{static_cast<const float*>(g),
               static_cast<const int*>(perm),
               static_cast<const int*>(indptr),
               static_cast<const int*>(piece_ptr),
               static_cast<const int*>(edge_dst),
               static_cast<float*>(out),
               (int)num_segments,
               num_edges,
               max_pieces,
               dim,
               0,
               0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 0) rows = segment_sum_bwd_rows(dim);
  if (dim % 4 == 0 && (uintptr_t)g % 16 == 0 && (uintptr_t)out % 16 == 0)
    launch<true>(p, rows != 0, s);
  else
    launch<false>(p, rows != 0, s);
  return (int)cudaGetLastError();
}
