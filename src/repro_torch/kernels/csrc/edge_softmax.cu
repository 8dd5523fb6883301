// Per destination and head: the softmax over the row's in-edge logits,
// applied to the edges' values; the Sum stage of GAT and GAT-E.
//
// Replaces: src/repro/kernels/edge_softmax.py, edge_softmax_csc (body
// _edge_softmax_kernel), the TPU kernel that runs an online softmax over
// the edge chunks of each 128-row destination block with one-hot matmuls.
//
// Bound on the H100: bytes. Each edge's H logits and H*D values are read
// once and each row's H*D outputs and 2*H statistics written once; the
// two exponentials and few multiply-adds per element read are far below
// the float32 rate, so the floor is
// (E*H*(1+D) + N*H*(D+2)) * 4 bytes (plus the plan) over 3.35 TB/s.
//
// Design: two schedules, chosen by the plan's size alone, so that no
// row's degree sets the time.
// - Below kLargePlan (2^19) rows plus edges, every plan the cells run
//   (their buckets and layers): the row-and-piece schedule of
//   row_pieces.cuh, which segment_sum.cu, segment_max.cu and
//   edge_softmax_bwd.cu share: a warp per row takes its first kPiece
//   edges, and the rest of a long row is cut into pieces of kPiece
//   edges counted from the row's start, one more warp per piece. A
//   row's cuts, and so its bits, are the same wherever it lies in the
//   plan: a served cache hit (the top layer over a 1-hop view) equals a
//   full recompute (over a K-hop view) on hub rows too.
// - From kLargePlan on: merge-path chunks. The plan's rows and real
//   edges form one sequence in plan order: row r's edges
//   perm[indptr[r]:indptr[r+1]], then an end marker for r, N + E items
//   in all (E = indptr[N]; pad edges sort past it and join no row).
//   Chunk k is items [k*kChunk, (k+1)*kChunk), one warp each, so a
//   warp's work is bounded by its items whatever the rows' lengths, and
//   a million short rows cost 27,000 warps, not a million. On an H100
//   80GB HBM3 (PERF.md), alipay_like power-law plans of 0.7 to 7
//   million items take 0.86-0.74x the time in chunks that they take in
//   rows and pieces: a warp per 6-edge row is a chain of dependent
//   loads (indptr, perm, then the edges) that chunks stream through.
//   At 0.14 million items (the GAT-E cells' 20k-node plan) chunks take
//   1.9x: too few chunks to fill the card, each a serial walk. Chunks
//   cut rows where the item count falls, so a long row's bits depend on
//   its offset in the plan: offset invariance holds below kLargePlan
//   only.
// A warp finds its first row with a 32-way search (over piece_ptr for a
// piece, over indptr for a chunk: a few rounds of 32 parallel probes),
// stages its edge ids (and, for a chunk,
// its rows' offsets) in shared memory, and walks its row pieces in plan
// order. Lane j holds the pair (h, d) = (j / D, j % D), in passes of 32
// when H*D > 32 (GAT-E's 4 heads of 8 fill one warp exactly), and keeps
// its head's online state (m, l, acc) in registers. A row piece issues
// kUnroll edges' logit and value loads before it folds them in: m_new =
// max(m, x_1..x_U), one rescale exp(m - m_new), then the edges'
// p = exp(x - m_new) summed in edge order. A chunk streams its edges
// across row ends instead, the next kUnroll edges' loads in flight
// while the current ones are folded in edge by edge with one
// exponential each, so that a chunk of 40 short rows is not 40 round
// trips. A piece that is a whole row is written straight out:
// out = acc / max(l, 1e-20), m, den = l. A row that is cut leaves its
// state (acc, m, l) per unit in scratch slots: for a chunk, slot 1 of
// the chunk where it starts and slot 0 of every later one it reaches;
// for rows and pieces, as row_pieces.cuh lays them out. The second launch (edge_softmax_merge)
// gives each cut row to the warp of the unit that holds its end, which
// folds the slots in plan order, (m, l, acc) <- (max(m, m'),
// l*s + l'*s', acc*s + acc'*s') with s = exp(m - max), s' =
// exp(m' - max), and divides once at the end: the 1e-20 clamp applies
// only there.
//
// Masked edges arrive with NEG logits and no separate mask: a row whose
// edges are all masked ends with m = NEG and den = its edge count, also
// when it is cut (two all-NEG partials merge with s = s' = 1, so their
// counts add), and an empty row with m = NEG, den = 0 and out = 0.
//
// Deterministic: the schedule, the chunks and the pieces are functions
// of the plan alone (compile-time sizes; nothing depends on the SM
// count or timing), each output element and each slot has one writer,
// there are no atomics, and every sum and merge runs in a fixed order.
// The same plan and data give the same bits on every run.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "row_pieces.cuh"

namespace {

using namespace row_pieces;

constexpr int kChunk = 256;  // large plans: merge-path items per warp
constexpr int64_t kLargePlan = int64_t{1} << 19;  // N + E from which
                                                  // chunks pay
constexpr int kUnroll = 4;   // edges whose loads a warp issues at once

struct State {
  float m, l, acc;
};

// Lane (h, j)'s online softmax over the `count` edges ids[0..count),
// staged in shared memory.
__device__ State fold(const float* __restrict__ logits,
                      const float* __restrict__ values, const int* ids,
                      int count, int64_t heads, int64_t hd, int64_t h,
                      int64_t j) {
  State st{kNeg, 0.f, 0.f};
  for (int t = 0; t < count; t += kUnroll) {
    float x[kUnroll], v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t + u < count) {
        const int64_t e = ids[t + u];
        x[u] = logits[e * heads + h];
        v[u] = values[e * hd + j];
      } else {
        x[u] = -INFINITY;  // p = 0, m unchanged
        v[u] = 0.f;
      }
    }
    float m_new = st.m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) m_new = fmaxf(m_new, x[u]);
    const float alpha = expf(st.m - m_new);
    float ps = 0.f, pv = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = expf(x[u] - m_new);
      ps += p;
      pv += p * v[u];
    }
    st.l = st.l * alpha + ps;
    st.acc = st.acc * alpha + pv;
    st.m = m_new;
  }
  return st;
}

// A lane's part of a row's state: out, m and den of row r when `slot` is
// null, else the partial [acc | m | l] at `slot`.
__device__ __forceinline__ void put(const State& st, float* __restrict__ slot,
                                    float* __restrict__ out,
                                    float* __restrict__ m_out,
                                    float* __restrict__ den_out, int64_t r,
                                    int64_t heads, int64_t hd, int64_t dim,
                                    int64_t h, int64_t j) {
  if (slot) {
    slot[j] = st.acc;
    if (j % dim == 0) {
      slot[hd + h] = st.m;
      slot[hd + heads + h] = st.l;
    }
  } else {
    out[r * hd + j] = st.acc / fmaxf(st.l, 1e-20f);
    if (j % dim == 0) {
      m_out[r * heads + h] = st.m;
      den_out[r * heads + h] = st.l;
    }
  }
}

// carry: (units, 2, H*D + 2*H) partials, each [acc | m | l], at the
// slots row_pieces.cuh lays out; merge_row: per chunk (kChunks) or per
// piece, the row whose end it holds and whose partials the second
// launch folds, or -1.
template <bool kChunks>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
edge_softmax_kernel(const float* __restrict__ logits,
                    const float* __restrict__ values,
                    const int* __restrict__ perm,
                    const int* __restrict__ indptr,
                    const int* __restrict__ piece_ptr,
                    float* __restrict__ out, float* __restrict__ m_out,
                    float* __restrict__ den_out, float* __restrict__ carry,
                    int* __restrict__ merge_row, int n, int64_t heads,
                    int64_t dim, int64_t units) {
  constexpr int kSpan = kChunks ? kChunk : kPiece;
  __shared__ int s_ids[kWarpsPerBlock][kSpan];
  __shared__ int s_ptr[kWarpsPerBlock][kChunks ? kChunk + 2 : 1];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int64_t k = (int64_t)blockIdx.x * kWarpsPerBlock + w;
  if (k >= units) return;  // uniform across the warp
  const int64_t hd = heads * dim;
  const int64_t slot = hd + 2 * heads;
  if (!kChunks) {  // a row, or a piece of one (row_pieces.cuh)
    if (k >= n && !has_piece(piece_ptr, n, k - n)) return;
    const Unit u = unit_of(indptr, piece_ptr, n, k, merge_row, lane);
    for (int t = lane; t < u.b - u.a; t += 32) s_ids[w][t] = perm[u.a + t];
    __syncwarp();
    float* dst = u.slot < 0 ? nullptr : carry + u.slot * slot;
    for (int64_t j = lane; j < hd; j += 32) {
      const int64_t h = j / dim;
      put(fold(logits, values, s_ids[w], u.b - u.a, heads, hd, h, j), dst,
          out, m_out, den_out, u.row, heads, hd, dim, h, j);
    }
    return;
  }
  // chunk k of the merge path: items [d0, d1), rows i0..i1, edges [j0, j1)
  const int64_t items = (int64_t)n + indptr[n];
  const int64_t d0 = k * kChunk;
  if (d0 >= items) {
    if (lane == 0) merge_row[k] = -1;
    return;
  }
  const int64_t d1 = d0 + kChunk < items ? d0 + kChunk : items;
  const int i0 = count_rows(indptr, 0, n, true, d0, lane);
  const int i1 = count_rows(indptr, i0, i0 + kChunk < n ? i0 + kChunk : n,
                            true, d1, lane);  // at most kChunk rows end here
  const int j0 = (int)(d0 - i0), j1 = (int)(d1 - i1);
  for (int t = lane; t < j1 - j0; t += 32) s_ids[w][t] = perm[j0 + t];
  const int last = i1 < n ? i1 : n - 1;  // rows i0..last meet the chunk
  for (int t = lane; t <= last + 1 - i0; t += 32)
    s_ptr[w][t] = indptr[i0 + t];
  __syncwarp();
  if (lane == 0) merge_row[k] = (i0 < i1 && s_ptr[w][0] < j0) ? i0 : -1;
  // The chunk's edges stream through in groups of kUnroll, the next
  // group's loads in flight while this one is folded in, across row
  // ends: a chunk of short rows is not a chain of one round trip a row.
  for (int64_t j = lane; j < (hd + 31) / 32 * 32; j += 32) {
    const bool active = j < hd;
    const int64_t h = active ? j / dim : 0;
    const auto load = [&](float* x, float* v, int g) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (active && g + u < j1) {
          const int64_t e = s_ids[w][g + u - j0];
          x[u] = logits[e * heads + h];
          v[u] = values[e * hd + j];
        } else {
          x[u] = v[u] = 0.f;
        }
      }
    };
    // row r's state goes out whole, or to a slot when a chunk edge cuts
    // it: slot 0 if r began in an earlier chunk, else slot 1
    const auto flush = [&](int r, const State& st) {
      const int start = s_ptr[w][r - i0];
      if (active)
        put(st, r < i1 && start >= j0
                    ? nullptr
                    : carry + (k * 2 + (start < j0 ? 0 : 1)) * slot,
            out, m_out, den_out, r, heads, hd, dim, h, j);
    };
    int r = i0;
    int end = r < i1 ? s_ptr[w][1] : j1;  // row i1 ends past the chunk
    State st{kNeg, 0.f, 0.f};
    float x[kUnroll], v[kUnroll];
    load(x, v, j0);
    for (int g = j0; g < j1; g += kUnroll) {
      float xn[kUnroll], vn[kUnroll];
      load(xn, vn, g + kUnroll);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (g + u >= j1) break;
        while (r < i1 && g + u >= end) {  // rows that end before this edge
          flush(r++, st);
          st = State{kNeg, 0.f, 0.f};
          end = r < i1 ? s_ptr[w][r - i0 + 1] : j1;
        }
        // the online update with one exponential: exp(m - m_new) and
        // exp(x - m_new) are exp(-|x - m|) and 1, in some order
        const bool up = x[u] > st.m;
        const float ex = expf(up ? st.m - x[u] : x[u] - st.m);
        const float alpha = up ? ex : 1.f, p = up ? 1.f : ex;
        st.l = st.l * alpha + p;
        st.acc = st.acc * alpha + p * v[u];
        st.m = up ? x[u] : st.m;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x[u] = xn[u], v[u] = vn[u];
    }
    for (; r < i1; ++r) {  // rows that end after the chunk's last edge
      flush(r, st);
      st = State{kNeg, 0.f, 0.f};
    }
    if (r < n && s_ptr[w][r - i0] < j1) flush(r, st);  // row i1's piece
  }
}

// One warp per chunk or piece: finish the cut row whose end it holds,
// folding the row's partials in plan order: slot 1 of the chunk where it
// starts and slot 0 of each later chunk to this one; slot 1 of its first
// piece (its row unit's) and slot 0 of each of its pieces.
template <bool kChunks>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
edge_softmax_merge(const int* __restrict__ indptr,
                   const int* __restrict__ piece_ptr,
                   const float* __restrict__ carry,
                   const int* __restrict__ merge_row,
                   float* __restrict__ out, float* __restrict__ m_out,
                   float* __restrict__ den_out, int n, int64_t heads,
                   int64_t dim, int64_t units) {
  const int lane = threadIdx.x & 31;
  const int64_t k =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (k >= units || (!kChunks && !has_piece(piece_ptr, n, k))) return;
  const int r = merge_row[k];
  if (r < 0) return;  // uniform across the warp
  const int64_t hd = heads * dim;
  const int64_t slot = hd + 2 * heads;
  const int64_t first = kChunks ? ((int64_t)r + indptr[r]) / kChunk
                                : (int64_t)piece_ptr[r];
  for (int64_t j = lane; j < hd; j += 32) {
    const int64_t h = j / dim;
    const float* s = carry + (first * 2 + 1) * slot;
    State st{s[hd + h], s[hd + heads + h], s[j]};
    for (int64_t q = kChunks ? first + 1 : first; q <= k; ++q) {
      s = carry + q * 2 * slot;
      const float m2 = s[hd + h];
      const float m_new = fmaxf(st.m, m2);
      const float s1 = expf(st.m - m_new), s2 = expf(m2 - m_new);
      st.l = st.l * s1 + s[hd + heads + h] * s2;
      st.acc = st.acc * s1 + s[j] * s2;
      st.m = m_new;
    }
    put(st, nullptr, out, m_out, den_out, r, heads, hd, dim, h, j);
  }
}

// A plan's schedule: merge-path chunks from kLargePlan items on, each
// chunk a unit that holds partials (counted from the rows and all E
// edges, pads included: a chunk past the real items exits), else
// row_pieces.cuh's rows and up to max_pieces pieces. Shapes alone set
// it, so it is the same for every view of a bucket.
bool chunked(int64_t num_segments, int64_t num_edges) {
  return num_segments + num_edges >= kLargePlan;
}

Schedule plan_schedule(int64_t num_segments, int64_t num_edges,
                       int64_t max_pieces) {
  if (!chunked(num_segments, num_edges))
    return schedule_for(num_segments, max_pieces);
  const int64_t chunks = (num_segments + num_edges + kChunk - 1) / kChunk;
  return {chunks, chunks};
}

template <bool kChunks>
void launch(const float* logits, const float* values, const int* perm,
            const int* indptr, const int* piece_ptr, float* out,
            float* m_out, float* den_out, char* scratch, int64_t num_segments, const Schedule& sc,
            int64_t heads, int64_t dim, cudaStream_t s) {
  int* merge_row = reinterpret_cast<int*>(scratch);
  float* carry = reinterpret_cast<float*>(scratch + carry_offset(sc.units));
  const dim3 block(32 * kWarpsPerBlock);
  edge_softmax_kernel<kChunks><<<blocks_for(sc.warps), block, 0, s>>>(
      logits, values, perm, indptr, piece_ptr, out, m_out, den_out, carry,
      merge_row, (int)num_segments, heads, dim, sc.warps);
  if (sc.units > 0)  // a shape test: the merge runs for every view
    edge_softmax_merge<kChunks><<<blocks_for(sc.units), block, 0, s>>>(
        indptr, piece_ptr, carry, merge_row, out, m_out, den_out,
        (int)num_segments, heads, dim, sc.units);
}

}  // namespace

// Bytes of scratch edge_softmax_f32 needs for a plan of num_segments
// rows, num_edges edges (pad edges included) and at most max_pieces
// pieces at heads x dim.
extern "C" int64_t edge_softmax_scratch_bytes(int64_t num_segments,
                                              int64_t num_edges,
                                              int64_t max_pieces,
                                              int64_t heads, int64_t dim) {
  return scratch_bytes(
      plan_schedule(num_segments, num_edges, max_pieces).units,
      (heads * dim + 2 * heads) * 4);
}

// logits (E, heads) f32, values (E, heads, dim) f32, perm (E,) int32,
// indptr and piece_ptr (num_segments+1,) int32, max_pieces
// (row_pieces.cuh's bound for E edges), scratch
// (edge_softmax_scratch_bytes) -> out (num_segments, heads, dim), m and
// den (num_segments, heads) f32. Two launches on `stream` (one when the
// schedule has no unit that holds partials). Returns
// cudaGetLastError().
extern "C" int edge_softmax_f32(const void* logits, const void* values,
                                const void* perm, const void* indptr,
                                const void* piece_ptr, void* out,
                                void* m_out, void* den_out, void* scratch,
                                int64_t num_segments, int64_t num_edges,
                                int64_t max_pieces, int64_t heads,
                                int64_t dim, void* stream) {
  if (num_segments <= 0 || heads <= 0 || dim <= 0) return 0;
  const Schedule sc = plan_schedule(num_segments, num_edges, max_pieces);
  const auto* lg = static_cast<const float*>(logits);
  const auto* va = static_cast<const float*>(values);
  const auto* pm = static_cast<const int*>(perm);
  const auto* ip = static_cast<const int*>(indptr);
  const auto* pp = static_cast<const int*>(piece_ptr);
  auto* o = static_cast<float*>(out);
  auto* mo = static_cast<float*>(m_out);
  auto* dn = static_cast<float*>(den_out);
  auto* scr = static_cast<char*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunked(num_segments, num_edges))
    launch<true>(lg, va, pm, ip, pp, o, mo, dn, scr, num_segments, sc,
                 heads, dim, s);
  else
    launch<false>(lg, va, pm, ip, pp, o, mo, dn, scr, num_segments, sc,
                  heads, dim, s);
  return (int)cudaGetLastError();
}
