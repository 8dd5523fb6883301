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
// Design: one set of units, two schedules that run them, chosen by the
// plan's size alone, so that no row's degree sets the time.
// - The units are row_pieces.cuh's, which segment_sum.cu, segment_max.cu
//   and edge_softmax_bwd.cu share: a row's first kPiece edges (its row
//   unit, also when the row is empty), and the rest of a long row cut
//   into pieces of kPiece edges counted from the row's start. Each unit
//   folds its edges from its start in groups of kUnroll (fold_group): it
//   issues the group's logit and value loads, then m_new = max(m,
//   x_1..x_U), one rescale exp(m - m_new), and the edges' p = exp(x -
//   m_new) summed in edge order. A unit that is a whole row is written
//   straight out: out = acc / max(l, 1e-20), m, den = l. A row that is
//   cut leaves its state (acc, m, l) per unit in the slots row_pieces.cuh
//   lays out (slot 1 of piece_ptr[r] from its row unit, slot 0 of each
//   piece), and the second launch (edge_softmax_merge) gives the row to
//   the warp of its last piece, which folds the slots in row order,
//   (m, l, acc) <- (max(m, m'), l*s + l'*s', acc*s + acc'*s') with s =
//   exp(m - max), s' = exp(m' - max), and divides once at the end: the
//   1e-20 clamp applies only there. So a row's bits are a function of
//   its edges and data alone, whichever schedule runs it and wherever it
//   lies in the plan: a served cache hit (the top layer over a 1-hop
//   view) equals a full recompute (over a K-hop view) at every bucket.
// - Below kLargePlan (2^19) rows plus edges, every plan the cells run
//   (their buckets and layers): a warp per unit (rows, then pieces).
// - From kLargePlan on: merge-path chunks over the same units. The
//   plan's rows and real edges form one sequence in plan order: row r's
//   edges perm[indptr[r]:indptr[r+1]], then an end marker for r, N + E
//   items in all (E = indptr[N]; pad edges sort past it and join no
//   row). Row r's unit j starts at item r + indptr[r] + j*kPiece. Chunk k
//   is items [k*C, (k+1)*C), one warp each, and takes the units that
//   start in it, so a warp's work is bounded by C + kPiece items whatever
//   the rows' lengths, and a million short rows cost some 27,000 to
//   55,000 warps, not a million. C is kChunk (128), or 256 from
//   kWideChunks (2^22) rows plus edges on, where the plan is many waves
//   of chunks and fewer searches pay more than a shorter tail. The chunk
//   size sets no bits: only the units do. The warp streams its units'
//   groups in plan order across unit and row ends, two groups' loads in
//   flight in two register buffers that take turns (a copy from one to
//   the other would wait for its loads): a chunk of 40 short rows is not
//   40 round trips, where a warp per 6-edge row is a chain of dependent
//   loads (indptr, perm, then the edges). On an H100 80GB HBM3 (PERF.md)
//   chunks take less time than rows and pieces on alipay_like power-law
//   plans of 0.7 to 7 million items, and more at 0.14 million (the GAT-E
//   cells' 20k-node plan): too few chunks to fill the card, each a serial
//   walk.
// A warp finds its first row with a 32-way search (over piece_ptr for a
// piece, over indptr for a chunk's first and last units: a few rounds of
// 32 parallel probes), stages its edge ids (and, for a chunk, its rows'
// offsets) in shared memory, and walks its units in plan order. Lane j
// holds the pair (h, d) = (j / D, j % D), in passes of 32 when H*D > 32
// (GAT-E's 4 heads of 8 fill one warp exactly), and keeps its head's
// online state (m, l, acc) in registers.
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

constexpr int64_t kLargePlan = int64_t{1} << 19;  // N + E from which
                                                  // chunks pay
constexpr int kChunk = 128;  // merge-path items per warp, and twice that
constexpr int64_t kWideChunks = int64_t{1} << 22;  // from this N + E on
constexpr int kUnroll = 4;   // edges whose loads a warp issues at once
static_assert(kPiece % kUnroll == 0, "a unit's end must be a group's");

struct State {
  float m, l, acc;
};

// One group of up to kUnroll edges folded into st (x = -inf, v = 0 past
// the group's end): m_new = max(m, x_1..x_U), one rescale exp(m - m_new),
// then the edges' p = exp(x - m_new) summed in edge order. Both schedules
// fold every unit through this, group for group from the unit's start.
__device__ __forceinline__ void fold_group(State& st, const float* x,
                                           const float* v) {
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

// Lane (h, j)'s online softmax over the `count` edges ids[0..count),
// staged in shared memory: one unit of the rows schedule.
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
    fold_group(st, x, v);
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

// A place in the merge path's units: the unit of row `row` that starts
// at edge `edge` (its row unit when edge == indptr[row]).
struct Cursor {
  int row, edge;
};

// The first unit that starts at item d or later, given r, the row whose
// items hold item d (n when d is past the last item).
__device__ inline Cursor first_unit(const int* __restrict__ indptr, int n,
                                    int r, int64_t d) {
  if (r >= n) return {n, indptr[n]};
  const int s = indptr[r], e = indptr[r + 1];
  const int64_t start = (int64_t)r + s;  // the item of its row unit
  if (start >= d) return {r, s};
  const int64_t j = (d - start + kPiece - 1) / kPiece;  // a piece, if any
  if (j * kPiece < e - s) return {r, s + (int)(j * kPiece)};
  return {r + 1, e};
}

// carry: (units, 2, H*D + 2*H) partials, each [acc | m | l], at the
// slots row_pieces.cuh lays out; merge_row: per piece, the row whose
// end it holds and whose partials the second launch folds, or -1.
// kItems: a warp per unit of the rows schedule (0), or per merge-path
// chunk of kItems items.
template <int kItems>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
edge_softmax_kernel(const float* __restrict__ logits,
                    const float* __restrict__ values,
                    const int* __restrict__ perm,
                    const int* __restrict__ indptr,
                    const int* __restrict__ piece_ptr,
                    float* __restrict__ out, float* __restrict__ m_out,
                    float* __restrict__ den_out, float* __restrict__ carry,
                    int* __restrict__ merge_row, int n, int64_t heads,
                    int64_t dim, int64_t warps) {
  // a chunk's units start in its kItems items and run at most kPiece - 1
  // edges past them (and a group's ids are read kUnroll at a time); its
  // rows are at most kItems + 1, their ends one more
  constexpr bool kChunks = kItems > 0;
  constexpr int kSpan = kChunks ? kItems + kPiece + kUnroll : kPiece;
  __shared__ int s_ids[kWarpsPerBlock][kSpan];
  __shared__ int s_ptr[kWarpsPerBlock][kChunks ? kItems + 2 : 1];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int64_t k = (int64_t)blockIdx.x * kWarpsPerBlock + w;
  if (k >= warps) return;  // uniform across the warp
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
  // chunk k of the merge path, items [d0, d0 + kItems): the units from
  // (ra, ja) up to (rb, jb), the first unit at or past the next chunk
  const int64_t items = (int64_t)n + indptr[n];
  const int64_t d0 = k * kItems;
  if (d0 >= items) return;
  const int64_t d1 = d0 + kItems;
  const int i0 = count_rows(indptr, 0, n, true, d0, lane);
  const int i1 = count_rows(indptr, i0, i0 + kItems < n ? i0 + kItems : n,
                            true, d1, lane);  // at most kItems rows end here
  const Cursor a = first_unit(indptr, n, i0, d0);
  const Cursor b = first_unit(indptr, n, i1, d1);
  const int ra = a.row, ja = a.edge, rb = b.row, jb = b.edge;
  for (int t = lane; t < jb - ja; t += 32) s_ids[w][t] = perm[ja + t];
  const int last = rb < n ? rb : n - 1;  // rows ra..last meet the chunk
  for (int t = lane; t <= last + 1 - ra; t += 32)
    s_ptr[w][t] = indptr[ra + t];
  __syncwarp();
  const int* ids = s_ids[w] - ja;  // ids[g]: edge g's id, ja <= g < jb
  const int* ptr = s_ptr[w] - ra;  // ptr[r]: indptr[r], ra <= r <= last + 1
  for (int64_t j = lane; j < (hd + 31) / 32 * 32; j += 32) {
    const bool active = j < hd;
    const int64_t h = active ? j / dim : 0;
    // the row that holds edge g, from r on: rows that end at g are done,
    // and an empty one among them is written out (its row unit starts in
    // this chunk)
    const auto seek = [&](int r, int g) {
      for (; r < rb && g == ptr[r + 1]; ++r)
        if (active && ptr[r] == g)
          put(State{kNeg, 0.f, 0.f}, nullptr, out, m_out, den_out, r, heads,
              hd, dim, h, j);
      return r;
    };
    State st{kNeg, 0.f, 0.f};
    // the group of n edges at edge g of row r, whose edges are [s, e)
    struct Group {
      int r, g, n, s, e;
    };
    // the group after q: in q's row, or in the row that holds its end
    const auto after = [&](const Group& q) {
      const int g2 = q.g + q.n;
      if (g2 < q.e && g2 < jb)
        return Group{q.r, g2, min(kUnroll, q.e - g2), q.s, q.e};
      const int r2 = seek(q.r, g2);
      if (g2 >= jb) return Group{r2, g2, 0, g2, g2};
      const int s2 = ptr[r2], e2 = ptr[r2 + 1];
      return Group{r2, g2, min(kUnroll, e2 - g2), s2, e2};
    };
    // group q's loads: its edge ids read whole from shared memory (past
    // jb they are never used), then the edges' logits and values
    const auto issue = [&](const Group& q, float* x, float* v) {
      int64_t id[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) id[u] = ids[q.g + u];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (active && u < q.n) {
          x[u] = logits[id[u] * heads + h];
          v[u] = values[id[u] * hd + j];
        } else {
          x[u] = -INFINITY;  // p = 0, m unchanged
          v[u] = 0.f;
        }
      }
    };
    // fold group q in; at its unit's end, write the unit out
    const auto finish = [&](const Group& q, const float* x, const float* v) {
      fold_group(st, x, v);
      const int ge = q.g + q.n;
      if (ge == q.e || (ge - q.s) % kPiece == 0) {
        const int unit = (ge - 1 - q.s) / kPiece;  // 0: the row unit
        if (unit == 0 && ge == q.e) {
          if (active)
            put(st, nullptr, out, m_out, den_out, q.r, heads, hd, dim, h, j);
        } else {
          const int64_t p = (int64_t)piece_ptr[q.r] + unit - 1;
          if (active)
            put(st, carry + (unit == 0 ? (p + 1) * 2 + 1 : p * 2) * slot,
                out, m_out, den_out, q.r, heads, hd, dim, h, j);
          if (unit > 0 && j == 0) merge_row[p] = ge == q.e ? q.r : -1;
        }
        st = State{kNeg, 0.f, 0.f};
      }
    };
    // two groups' loads in flight: each buffer is loaded while the other
    // is folded in, and never copied (a copy would wait for its loads)
    Group qa = after(Group{ra, ja, 0, ja, ja}), qb;
    float xa[kUnroll], va[kUnroll], xb[kUnroll], vb[kUnroll];
    issue(qa, xa, va);
    while (qa.g < jb) {
      qb = after(qa);
      issue(qb, xb, vb);
      finish(qa, xa, va);
      if (qb.g >= jb) break;
      qa = after(qb);
      issue(qa, xa, va);
      finish(qb, xb, vb);
    }
  }
}

// One warp per piece: finish the cut row whose end it holds, folding the
// row's partials in row order: slot 1 of its first piece (its row
// unit's) and slot 0 of each of its pieces.
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
edge_softmax_merge(const int* __restrict__ piece_ptr,
                   const float* __restrict__ carry,
                   const int* __restrict__ merge_row,
                   float* __restrict__ out, float* __restrict__ m_out,
                   float* __restrict__ den_out, int n, int64_t heads,
                   int64_t dim, int64_t units) {
  const int lane = threadIdx.x & 31;
  const int64_t k =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (k >= units || !has_piece(piece_ptr, n, k)) return;
  const int r = merge_row[k];
  if (r < 0) return;  // uniform across the warp
  const int64_t hd = heads * dim;
  const int64_t slot = hd + 2 * heads;
  const int64_t first = piece_ptr[r];
  for (int64_t j = lane; j < hd; j += 32) {
    const int64_t h = j / dim;
    const float* s = carry + (first * 2 + 1) * slot;
    State st{s[hd + h], s[hd + heads + h], s[j]};
    for (int64_t q = first; q <= k; ++q) {
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

// A plan's schedule: from kLargePlan items on, a merge-path chunk a warp
// (counted from the rows and all E edges, pads included: a chunk past
// the real items exits), of kChunk items, or 2 * kChunk from kWideChunks
// on (where the plan gives the card many waves of chunks, so fewer
// searches pay more than a shorter tail); else row_pieces.cuh's rows and
// up to max_pieces pieces. Under either, the pieces hold partials and
// merge them. Shapes alone set it, so it is the same for every view of a
// bucket.
int chunk_items(int64_t num_segments, int64_t num_edges) {
  const int64_t items = num_segments + num_edges;
  return items < kLargePlan ? 0 : items < kWideChunks ? kChunk : 2 * kChunk;
}

Schedule plan_schedule(int64_t num_segments, int64_t num_edges,
                       int64_t max_pieces) {
  const Schedule rows = schedule_for(num_segments, max_pieces);
  const int c = chunk_items(num_segments, num_edges);
  if (c == 0) return rows;
  return {(num_segments + num_edges + c - 1) / c, rows.units};
}

template <int kItems>
void launch(const float* logits, const float* values, const int* perm,
            const int* indptr, const int* piece_ptr, float* out,
            float* m_out, float* den_out, char* scratch,
            int64_t num_segments, const Schedule& sc, int64_t heads,
            int64_t dim, cudaStream_t s) {
  int* merge_row = reinterpret_cast<int*>(scratch);
  float* carry = reinterpret_cast<float*>(scratch + carry_offset(sc.units));
  const dim3 block(32 * kWarpsPerBlock);
  edge_softmax_kernel<kItems><<<blocks_for(sc.warps), block, 0, s>>>(
      logits, values, perm, indptr, piece_ptr, out, m_out, den_out, carry,
      merge_row, (int)num_segments, heads, dim, sc.warps);
  if (sc.units > 0)  // a shape test: the merge runs for every view
    edge_softmax_merge<<<blocks_for(sc.units), block, 0, s>>>(
        piece_ptr, carry, merge_row, out, m_out, den_out,
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
  switch (chunk_items(num_segments, num_edges)) {
    case 0:
      launch<0>(lg, va, pm, ip, pp, o, mo, dn, scr, num_segments, sc, heads,
                dim, s);
      break;
    case kChunk:
      launch<kChunk>(lg, va, pm, ip, pp, o, mo, dn, scr, num_segments, sc,
                     heads, dim, s);
      break;
    default:
      launch<2 * kChunk>(lg, va, pm, ip, pp, o, mo, dn, scr, num_segments,
                         sc, heads, dim, s);
  }
  return (int)cudaGetLastError();
}
