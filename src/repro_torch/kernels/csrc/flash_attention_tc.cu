// Blockwise (flash) attention in bf16 on the tensor cores, for the LM
// zoo's prefill: causal and/or sliding-window, GQA by index, a per-row
// first visible key. The float32 entry point stays in flash_attention.cu.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention (body
// _flash_kernel), the TPU kernel that walks key blocks of one
// (batch, head, query block) in a sequential grid axis, keeps the running
// (max, denominator, accumulator) in VMEM scratch, and skips key blocks
// outside the causal / window band and past seq_len. Like it, this kernel
// keeps the probabilities p in float32 for the PV product.
//
// Bound on the H100: operations. Causal attention does 2*B*Hq*T^2*D
// multiply-adds (QK^T and PV, halved by the mask); its bytes are q, k, v
// and out read or written once. At T = 4096, Hq = 32, D = 128 that is
// 0.139 ms of bf16 tensor-core work against 0.04 ms of bytes.
//
// Design (wgmma with operands staged by cp.async; TMA, a producer warp
// and setmaxnreg are later work):
// - One block of two warpgroups per (128-row query tile, q head, batch
//   row); a warpgroup owns 64 query rows, a warp 16 of them. The
//   query-tile index is reversed and is the grid's slowest axis, so the
//   heaviest causal tiles launch first.
// - Q is loaded once; K and V tiles of 64 keys stream through a
//   two-stage cp.async ring (16-byte copies, rows past T zero-filled),
//   the next tile in flight while this one is computed. Every tile is
//   stored in wgmma's canonical layout: rows of 64 values (32 at D 32)
//   with the 128-byte (64-byte) swizzle, in column blocks of 64. Q 32 KB
//   + 2 x (K 16 + V 16) KB = 96 KB at D 128, so two blocks fit on an SM.
// - S = Q K^T: per warpgroup, D/16 wgmma m64n64k16 with both operands in
//   shared memory and a float32 result in registers. The causal, window,
//   seq_len and kv_start masks are applied to the register fragment only
//   on tiles that cross a boundary for the warp's rows; key tiles that
//   hold no visible key for the block are never loaded, and a warpgroup
//   skips the tiles that none of its rows sees.
// - Online softmax in registers, with scale * log2(e) folded into one
//   ex2 per score.
// - PV: p is split as p_hi = bf16(p), p_lo = bf16(p - p_hi), and O +=
//   p_hi V + p_lo V: two wgmma m64nDk16 per 16 keys with p as the A
//   operand in registers and V as the B operand through the descriptor's
//   transpose (V is stored key by key), both into one float32
//   accumulator. Rounding p to bf16 alone (what library kernels do)
//   parts from the float32-p reference by 6-13x the element gate; the
//   split keeps about 16 bits of p for 1.5x the tensor-core work (QK^T
//   once, PV twice).
// - O is divided by max(l, 1e-20) and stored in bf16 once: a row with no
//   visible key (a left-pad row of a served batch) gives 0.
// kv head = h / (Hq / Hkv), so no repeated K/V tensor exists. D in
// {32, 64, 128}.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 128;          // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kThreads = 256;     // two warpgroups of 64 query rows

// The shared layout of a tile of R rows of D bf16 values: column blocks
// of kW values (64, or 32 at D 32), each R rows of kW * 2 bytes, 16-byte
// chunk c of row r stored at chunk c ^ (r % 8) (128-byte swizzle) or
// c ^ ((r / 2) % 4) (64-byte swizzle): wgmma's canonical K-major layout,
// and, read with the transpose bit, its N-major one.
template <int D>
struct Geo {
  static constexpr int kW = D < 64 ? D : 64;
  static constexpr int kRow = kW * 2;            // bytes per row
  static constexpr int kChunks = kW / 8;         // 16-byte chunks per row
  static constexpr int kMode = kW == 64 ? 1 : 2; // descriptor: 128B / 64B
};

template <int D, int R>
__device__ __forceinline__ int tile_off(int r, int c) {
  using G = Geo<D>;
  const int blk = c / G::kChunks, cc = c % G::kChunks;
  const int pc = G::kChunks == 8 ? (cc ^ (r & 7)) : (cc ^ ((r >> 1) & 3));
  return blk * R * G::kW + r * G::kW + pc * 8;
}

// a wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle mode
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)mode << 62);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem,
                                           bool valid) {
  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// this thread's copies have landed and are visible to wgmma, which reads
// shared memory through the async proxy
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads of an accumulator above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// S (64 x 64, f32) += A (64 x 16, shared, K-major) * B^T, B a 64 x 16
// K-major shared tile: one warpgroup's k step of QK^T
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// O (64 x N, f32) += A (64 x 16 bf16, registers) * B, B a 16 x N tile
// of N-major (transposed) shared rows: one warpgroup's k step of PV
template <int N>
struct WgmmaPV;
template <>
struct WgmmaPV<32> {
  __device__ static void run(float (&d)[16], const uint32_t (&a)[4],
                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct WgmmaPV<64> {
  __device__ static void run(float (&d)[32], const uint32_t (&a)[4],
                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct WgmmaPV<128> {
  __device__ static void run(float (&d)[64], const uint32_t (&a)[4],
                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// 2^x on the special-function unit; -inf gives +0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// p0, p1 (adjacent columns) -> their bf16 high halves and the bf16
// rounding of what the high halves leave out
__device__ __forceinline__ void split(float p0, float p1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(p0 - __low2float(h),
                                    p1 - __high2float(h)));
}

// rows [r0, r0 + R) of a (T, row_stride) bf16 matrix -> the shared tile
// at ``dst``; rows at and past T are zero-filled
template <int D, int R>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src,
                                          int64_t row_stride, int64_t r0,
                                          int64_t T_len, int tid) {
  constexpr int kCh = D / 8;
  for (int c = tid; c < R * kCh; c += kThreads) {
    const int r = c / kCh, ch = c % kCh;
    const int64_t t = r0 + r;
    const bool ok = t < T_len;
    cp_async16(dst + 2 * tile_off<D, R>(r, ch),
               src + (ok ? t : 0) * row_stride + ch * 8, ok);
  }
}

template <int D>
constexpr int smem_bytes() {
  // the tiles, and room to align their base to 1024 bytes
  return (kBQ + 4 * kBK) * D * (int)sizeof(bf16) + 1024;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const int* __restrict__ kv_start,
                bf16* __restrict__ out, int64_t T_len, int64_t Hq,
                int64_t Hkv, int causal, int64_t window, int64_t seq_len,
                float scale_log2) {
  using G = Geo<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ks = qs + kBQ * D * 2;   // two stages of kBK rows
  const uint32_t vs = ks + 2 * kBK * D * 2;
  constexpr int kTileBytes = kBK * D * 2;
  constexpr int kKT = D / 16;             // 16-wide k steps of QK^T
  constexpr int kStepsPerBlk = G::kW / 16;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;               // this thread's warpgroup
  const int g = lane >> 2, tq = lane & 3;
  const int64_t h = blockIdx.x % Hq;
  const int64_t b = blockIdx.x / Hq;
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * kBQ;
  const int64_t hk = h / (Hq / Hkv);
  const int64_t q_row = Hq * D;
  const int64_t k_row = Hkv * D;
  const bf16* qb = q + b * T_len * q_row + h * D;
  const bf16* kb = k + b * T_len * k_row + hk * D;
  const bf16* vb = v + b * T_len * k_row + hk * D;
  const int64_t start = kv_start[b];

  // the key tiles that can hold a visible key for this query tile
  int64_t k_end = seq_len;
  if (causal && q0 + kBQ < k_end) k_end = q0 + kBQ;
  int64_t k_begin = start > 0 ? start : 0;
  if (window && q0 - window + 1 > k_begin) k_begin = q0 - window + 1;
  k_begin = k_begin / kBK * kBK;
  const int n_tiles =
      k_end > k_begin ? (int)((k_end - k_begin + kBK - 1) / kBK) : 0;

  load_rows<D, kBQ>(qs, qb, q_row, q0, T_len, tid);
  if (n_tiles > 0) {
    load_rows<D, kBK>(ks, kb, k_row, k_begin, T_len, tid);
    load_rows<D, kBK>(vs, vb, k_row, k_begin, T_len, tid);
  }
  cp_async_commit();

  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const int64_t qg = q0 + wg * 64;             // the warpgroup's first row
  const int64_t qw = q0 + warp * 16;           // the warp's first row
  const int64_t qr[2] = {qw + g, qw + g + 8};  // this thread's two rows

  for (int it = 0; it < n_tiles; ++it) {
    const int64_t k0 = k_begin + (int64_t)it * kBK;
    const int stage = it & 1;
    // tile it has landed, and every warpgroup is done with tile it - 1,
    // whose stage the next copies overwrite
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_tiles) {
      load_rows<D, kBK>(ks + (stage ^ 1) * kTileBytes, kb, k_row, k0 + kBK,
                        T_len, tid);
      load_rows<D, kBK>(vs + (stage ^ 1) * kTileBytes, vb, k_row, k0 + kBK,
                        T_len, tid);
      cp_async_commit();
    }
    // a warpgroup whose rows see no key of this tile, or lie past T,
    // leaves its (m, l, O) as they are
    if (qg >= T_len || (causal && k0 > qg + 63) ||
        (window && k0 + kBK - 1 <= qg - window))
      continue;
    const uint32_t kst = ks + stage * kTileBytes;
    const uint32_t vst = vs + stage * kTileBytes;

    // S = Q K^T: 64 rows x 64 keys per warpgroup; s[4 j + e] is this
    // thread's entry e of key column tile j (rows g and g + 8)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk) {
      const int blk = kk / kStepsPerBlk, kin = kk % kStepsPerBlk;
      const uint64_t da = desc(qs + blk * kBQ * G::kRow + wg * 64 * G::kRow +
                                   kin * 32,
                               16, 8 * G::kRow, G::kMode);
      const uint64_t db = desc(kst + blk * kBK * G::kRow + kin * 32, 16,
                               8 * G::kRow, G::kMode);
      wgmma_qk(s, da, db);
    }
    wgmma_commit_and_wait();
    fence_regs(s);

    // masks, only where the tile crosses a boundary for the warp's rows
    const bool edge = k0 < start || k0 + kBK > seq_len ||
                      (causal && k0 + kBK - 1 > qw) ||
                      (window && k0 < qw + 16 - window);
    if (edge) {
      // in 32 bits, relative to the tile's first key and the warp's
      // first row: key column c of row r is visible when lo <= c < hi,
      // c - r <= diag (causal) and c - r > diag - window (window)
      const int lo = (int)(start > k0 ? start - k0 : 0);
      const int hi = (int)(seq_len - k0 < kBK ? seq_len - k0 : kBK);
      const int diag = causal ? (int)(qw + kBK - k0 < 2 * kBK
                                          ? qw - k0 : 2 * kBK)
                              : 2 * kBK;
      const int wlo = window ? (int)(qw - k0 - window > -2 * kBK
                                         ? qw - k0 - window : -2 * kBK)
                             : -4 * kBK;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = (i >> 2) * 8 + 2 * tq + (i & 1);
        const int cr = c - g - ((i >> 1) & 1) * 8;
        if (c < lo || c >= hi || cr > diag || cr <= wlo) s[i] = -INFINITY;
      }
    }

    // online softmax; a row that has seen no key keeps m = -inf and
    // subtracts 0, so its p are 2^-inf = 0
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * ri], s[4 * j + 2 * ri + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[ri], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = ex2((m_run[ri] - m_use) * scale_log2);
      const float off = -m_use * scale_log2;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * ri; e < 2 * ri + 2; ++e) {
          const float p = ex2(fmaf(s[4 * j + e], scale_log2, off));
          s[4 * j + e] = p;
          rs += p;
        }
      l_run[ri] = l_run[ri] * alpha + rs;
      m_run[ri] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o_acc[4 * j + 2 * ri] *= alpha;
        o_acc[4 * j + 2 * ri + 1] *= alpha;
      }
    }

    // O += p_hi V + p_lo V, 16 keys at a time; the S fragments of two
    // adjacent key column tiles are the A fragment of one k step. Every
    // A fragment is made before the first product, so the eight run
    // back to back.
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
#pragma unroll
      for (int a = 0; a < 4; ++a)
        split(s[8 * kt + 2 * a], s[8 * kt + 2 * a + 1], hi[kt][a],
              lo[kt][a]);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      // 16 key rows of V; column blocks kBK rows apart
      const uint64_t db = desc(vst + kt * 16 * G::kRow, kBK * G::kRow,
                               8 * G::kRow, G::kMode);
      WgmmaPV<D>::run(o_acc, hi[kt], db);
      WgmmaPV<D>::run(o_acc, lo[kt], db);
    }
    wgmma_commit_and_wait();
    fence_regs(o_acc);
  }

  cp_async_wait_all();  // a block with no key tile still loaded Q
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    float l = l_run[ri];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float den = fmaxf(l, 1e-20f);
    if (qr[ri] >= T_len) continue;
    bf16* o = out + (b * T_len + qr[ri]) * q_row + h * D + 2 * tq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + j * 8) = __floats2bfloat162_rn(
          o_acc[4 * j + 2 * ri] / den, o_acc[4 * j + 2 * ri + 1] / den);
  }
}

template <int D>
int run(const void* q, const void* k, const void* v, const void* kv_start,
        void* out, int64_t B, int64_t T_len, int64_t Hq, int64_t Hkv,
        int64_t causal, int64_t window, int64_t seq_len,
        cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  // 1 / sqrt(D) rounded once to float, as the plain version's scalar,
  // times log2(e) for ex2
  const float scale = (float)(1.0 / sqrt((double)D));
  const float scale_log2 = scale * 1.4426950408889634f;
  const int64_t n_qt = (T_len + kBQ - 1) / kBQ;
  if (n_qt > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(B * Hq), (unsigned)n_qt);
  flash_tc_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(kv_start),
      static_cast<bf16*>(out), T_len, Hq, Hkv, causal ? 1 : 0, window,
      seq_len, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, T, Hq, D), k and v (B, T, Hkv, D) bf16, kv_start (B,) int32 ->
// out (B, T, Hq, D) bf16, all contiguous and 16-byte aligned; D in
// {32, 64, 128}. seq_len (1..T) masks keys at and past it; window 0 means
// none. Returns cudaGetLastError().
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, const void* kv_start,
                                    void* out, int64_t B, int64_t T_len,
                                    int64_t Hq, int64_t Hkv, int64_t D,
                                    int64_t causal, int64_t window,
                                    int64_t seq_len, void* stream) {
  if (B <= 0 || T_len <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || seq_len > T_len)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return run<32>(q, k, v, kv_start, out, B, T_len, Hq, Hkv, causal,
                     window, seq_len, s);
    case 64:
      return run<64>(q, k, v, kv_start, out, B, T_len, Hq, Hkv, causal,
                     window, seq_len, s);
    case 128:
      return run<128>(q, k, v, kv_start, out, B, T_len, Hq, Hkv, causal,
                      window, seq_len, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory that flash_tc_kernel<D> asks for at launch
// (run<D>'s cudaFuncSetAttribute), in bytes; -1 for a head dim the
// kernel does not take.
extern "C" int64_t flash_attention_bf16_smem_bytes(int64_t D) {
  switch (D) {
    case 32: return smem_bytes<32>();
    case 64: return smem_bytes<64>();
    case 128: return smem_bytes<128>();
    default: return -1;
  }
}
