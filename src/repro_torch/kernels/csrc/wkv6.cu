// The RWKV-6 ("Finch") WKV recurrence for the LM zoo's prefill:
//
//   o_t = r_t . (S + diag(u) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T
//
// from a zero state, writing every o_t and the final state S, which the
// prefill hands to decode as its cache.
//
// Replaces: src/repro/kernels/wkv6.py, wkv6 (body _wkv6_kernel), the TPU
// kernel that runs the recurrence in chunks of C tokens as three MXU
// matmuls per chunk, in the log domain (cumulative log-decays, clamped at
// log(max(w, 1e-12))), carrying S in VMEM across a sequential chunk axis.
//
// Bound on the H100: bytes, counted once for the note and for
// chip_smoke.py. Each (b, t, h, k) reads r, k, v (2 bytes each in bf16)
// and w (4) and writes o (4 in float32, the model's call): 14 bytes, so
// at B = 8, T = 4096, H = 32, K = V = 64 (RWKV-6 1.6B) 0.94 GB, 0.282 ms
// at 3.35 TB/s; the operations, 4*K*V a step (a multiply-add for the
// output and one for the decayed state), are 0.256 ms at 67 TFLOP/s of
// float32. What holds a sequential kernel back is neither: each step of
// one (b, h) depends on the last, so the time is steps x the latency of
// one step, unless enough independent work is in flight on every SM.
//
// Design: the sequential form (no log domain, no clamp, any T), with
// each step made short and every operand staged.
// - The thread for (K-slice s, column group c) keeps S[8s:8s+8,
//   Jc:Jc+J] in registers, J = K/16 columns (4 at K 64): a step is
//   3 * 8 * J float32 operations on values it holds (a multiply for
//   k_i v_j, a multiply-add for the state, one for the output), with the
//   slice's r, k, w read from shared memory as float4 broadcasts. A
//   broadcast costs one shared-memory wavefront per float for the warp
//   however many threads read it, so each float must serve J >= 4
//   columns for the float32 pipes, not shared memory, to set the pace
//   (one column per thread measured shared-memory bound, 2.18 ms at B 8,
//   T 4096 on an H100; PERF.md).
// - Slices of 8 rows give four warps per (b, h) at K 64, so at B 8 two
//   warps share each scheduler and one hides the other's latencies
//   (slices of 16 rows, half the warps, measured no faster at B 8 and
//   slower at B 4).
// - o_t[j] = sum_i r_i S_ij + v_j * (sum_i r_i u_i k_i): the bonus term is
//   one scalar per step, computed once per tile by threads that hold u
//   in registers, not per column.
// - Each step writes its partial outputs to shared memory; at the end of
//   a tile of 16 steps the K/8 partials are summed in slice order, plus
//   the bonus term, and stored coalesced. No atomics: every run gives the
//   same bits.
// - Every operand of a tile (r, k, w and v) is staged in shared memory by
//   16-byte cp.async copies into a two-buffer ring: the next tile's loads
//   are in flight while this tile's steps run, and no device-memory load
//   sits on a step's path. bf16 inputs are widened to float once per
//   tile, 8 at a time, not once per column.
// - One block per (b, h). The number of warps on the card is fixed by
//   the work per thread, not by how the columns are split over blocks,
//   so they stay in one block.
// r, k and v are float32 or bfloat16; w and u float32; o in r's type or
// float32 by the symbol; S float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlice = 8;   // state rows per thread
constexpr int kTile = 16;   // steps staged per tile

// four consecutive outputs, rounded to nearest even for bf16 as torch's
// cast rounds
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory of one block, in bytes: a two-buffer landing ring (r, k,
// v in their input type, w float32), the tile widened to float32 (bf16
// inputs only), the per-slice partial outputs and the per-step bonus
// scalars.
template <typename Tin, int K>
struct Layout {
  static constexpr int kNS = K / kSlice;
  static constexpr int kIn = (int)sizeof(Tin);
  static constexpr int kLandR = kTile * K * kIn;   // bytes of r, k and v
  static constexpr int kLandW = kTile * K * 4;
  static constexpr int kLand = 3 * kLandR + kLandW;
  static constexpr bool kWiden = sizeof(Tin) != 4;
  static constexpr int kWide = kWiden ? kTile * 3 * K * 4 : 0;
  static constexpr int kPart = kTile * kNS * K * 4;
  static constexpr int kBytes = 2 * kLand + kWide + kPart + kTile * 4;
};

// J consecutive floats as one 8- or 16-byte access
template <int J>
struct Vec;
template <>
struct Vec<2> {
  __device__ static void get(const float* p, float (&x)[2]) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  }
  __device__ static void put(float* p, const float (&x)[2]) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
};
template <>
struct Vec<4> {
  __device__ static void get(const float* p, float (&x)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
  __device__ static void put(float* p, const float (&x)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

template <typename Tin, typename Tout, int K>
__global__ void __launch_bounds__(K / kSlice * 16)
wkv6_kernel(const Tin* __restrict__ r, const Tin* __restrict__ k,
            const Tin* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, Tout* __restrict__ o,
            float* __restrict__ s_out, int64_t T_len, int64_t H) {
  using L = Layout<Tin, K>;
  constexpr int kNS = L::kNS;
  constexpr int kThreads = kNS * 16;      // kNS slices x 16 column groups
  constexpr int kJ = K / 16;              // columns per thread
  constexpr int kQ = kSlice / 4;          // float4s of a slice's row
  constexpr int kChR = K * L::kIn / 16;   // 16-byte chunks per row of r, k, v
  constexpr int kChW = K * 4 / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem + 2 * L::kLand + L::kWide);
  float* bonus = part + kTile * kNS * K;

  const int tid = threadIdx.x;
  const int s = tid / 16;                 // this thread's K-slice
  const int j0 = (tid % 16) * kJ;         // and first value column
  const int64_t bh = blockIdx.x;
  const int64_t h = bh % H;
  const int64_t step = H * K;             // elements between t and t + 1
  const int64_t base = (bh / H) * T_len * step + h * K;

  // the bonus pre-pass: 8 threads per step, each over K/8 rows of u
  constexpr int kPer = K / 8;
  const int part8 = tid & 7;
  float ur[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) ur[i] = u[h * K + part8 * kPer + i];

  auto land = [&](int buf) { return smem + buf * L::kLand; };
  auto issue = [&](int64_t t0, int buf) {
    const int n = T_len - t0 < kTile ? (int)(T_len - t0) : kTile;
    unsigned char* lr = land(buf);
    unsigned char* lw = lr + 3 * L::kLandR;
    for (int c = tid; c < n * kChR; c += kThreads) {
      const int64_t row = base + (t0 + c / kChR) * step;
      const int off = (c % kChR) * 16;
      cp_async16(lr + c * 16,
                 reinterpret_cast<const unsigned char*>(r + row) + off);
      cp_async16(lr + L::kLandR + c * 16,
                 reinterpret_cast<const unsigned char*>(k + row) + off);
      cp_async16(lr + 2 * L::kLandR + c * 16,
                 reinterpret_cast<const unsigned char*>(v + row) + off);
    }
    for (int c = tid; c < n * kChW; c += kThreads) {
      const int64_t row = base + (t0 + c / kChW) * step;
      cp_async16(lw + c * 16, reinterpret_cast<const unsigned char*>(w + row) +
                                  (c % kChW) * 16);
    }
    cp_async_commit();
  };

  float S[kSlice][kJ];
#pragma unroll
  for (int i = 0; i < kSlice; ++i)
#pragma unroll
    for (int c = 0; c < kJ; ++c) S[i][c] = 0.f;

  const int64_t n_tiles = (T_len + kTile - 1) / kTile;
  if (n_tiles > 0) issue(0, 0);
  for (int64_t tile = 0; tile < n_tiles; ++tile) {
    const int64_t t0 = tile * kTile;
    const int n = T_len - t0 < kTile ? (int)(T_len - t0) : kTile;
    const int buf = (int)(tile & 1);
    cp_async_wait<0>();
    __syncthreads();  // A: this tile landed; the last tile's reads done
    // the next tile's copies fly while this tile runs, into the buffer
    // that every thread finished reading before barrier A
    if (tile + 1 < n_tiles) issue(t0 + kTile, buf ^ 1);

    const Tin* lr = reinterpret_cast<const Tin*>(land(buf));
    const Tin* lk = reinterpret_cast<const Tin*>(land(buf) + L::kLandR);
    const Tin* lv = reinterpret_cast<const Tin*>(land(buf) + 2 * L::kLandR);
    const float* wf =
        reinterpret_cast<const float*>(land(buf) + 3 * L::kLandR);
    const float *rf, *kf, *vf;
    if constexpr (L::kWiden) {
      // 8 bf16 at a time: a bf16 is the top half of its float32
      float* wide = reinterpret_cast<float*>(smem + 2 * L::kLand);
#pragma unroll 2
      for (int e = tid; e < n * K / 8; e += kThreads) {
        const uint4 x[3] = {reinterpret_cast<const uint4*>(lr)[e],
                            reinterpret_cast<const uint4*>(lk)[e],
                            reinterpret_cast<const uint4*>(lv)[e]};
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          float4* dst =
              reinterpret_cast<float4*>(wide + a * kTile * K) + 2 * e;
          dst[0] = make_float4(__uint_as_float(x[a].x << 16),
                               __uint_as_float(x[a].x & 0xffff0000u),
                               __uint_as_float(x[a].y << 16),
                               __uint_as_float(x[a].y & 0xffff0000u));
          dst[1] = make_float4(__uint_as_float(x[a].z << 16),
                               __uint_as_float(x[a].z & 0xffff0000u),
                               __uint_as_float(x[a].w << 16),
                               __uint_as_float(x[a].w & 0xffff0000u));
        }
      }
      rf = wide;
      kf = wide + kTile * K;
      vf = wide + 2 * kTile * K;
      __syncthreads();  // the widened tile is ready for the bonus terms
    } else {
      rf = reinterpret_cast<const float*>(lr);
      kf = reinterpret_cast<const float*>(lk);
      vf = reinterpret_cast<const float*>(lv);
    }
    // bonus[t] = sum_i r_i u_i k_i, summed over the 8 lanes in a fixed
    // order (kThreads is a multiple of 32 and kTile * 8 of kThreads)
    for (int e = tid; e < kTile * 8; e += kThreads) {
      const int t = e >> 3;
      float acc = 0.f;
      if (t < n) {
        const float4* r4 =
            reinterpret_cast<const float4*>(rf + t * K + part8 * kPer);
        const float4* k4 =
            reinterpret_cast<const float4*>(kf + t * K + part8 * kPer);
#pragma unroll
        for (int q = 0; q < kPer / 4; ++q) {
          const float4 rq = r4[q], kq = k4[q];
          acc = fmaf(rq.x * ur[4 * q + 0], kq.x, acc);
          acc = fmaf(rq.y * ur[4 * q + 1], kq.y, acc);
          acc = fmaf(rq.z * ur[4 * q + 2], kq.z, acc);
          acc = fmaf(rq.w * ur[4 * q + 3], kq.w, acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      acc += __shfl_xor_sync(0xffffffffu, acc, 4);
      if (part8 == 0) bonus[t] = acc;
    }
    __syncthreads();  // B: the widened tile and the bonus terms are ready

    for (int t = 0; t < n; ++t) {
      const float4* r4 =
          reinterpret_cast<const float4*>(rf + t * K) + kQ * s;
      const float4* k4 =
          reinterpret_cast<const float4*>(kf + t * K) + kQ * s;
      const float4* w4 =
          reinterpret_cast<const float4*>(wf + t * K) + kQ * s;
      float vj[kJ], acc[kJ];
      Vec<kJ>::get(vf + t * K + j0, vj);
#pragma unroll
      for (int c = 0; c < kJ; ++c) acc[c] = 0.f;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float4 rq = r4[q], kq = k4[q], wq = w4[q];
        const float ri[4] = {rq.x, rq.y, rq.z, rq.w};
        const float ki[4] = {kq.x, kq.y, kq.z, kq.w};
        const float wi[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < kJ; ++c) {
            float& S_ij = S[4 * q + e][c];
            acc[c] = fmaf(ri[e], S_ij, acc[c]);
            S_ij = fmaf(wi[e], S_ij, ki[e] * vj[c]);
          }
      }
      Vec<kJ>::put(part + (t * kNS + s) * K + j0, acc);
    }
    __syncthreads();  // C: every slice's partials of this tile are in

    // four columns at a time: the slices' partials in slice order, then
    // the bonus term
#pragma unroll 2
    for (int e = tid; e < n * K / 4; e += kThreads) {
      const int t = e / (K / 4), jj = (e % (K / 4)) * 4;
      float4 acc = *reinterpret_cast<const float4*>(part + t * kNS * K + jj);
#pragma unroll
      for (int q = 1; q < kNS; ++q) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(part + (t * kNS + q) * K + jj);
        acc.x += p4.x;
        acc.y += p4.y;
        acc.z += p4.z;
        acc.w += p4.w;
      }
      const float4 v4 = *reinterpret_cast<const float4*>(vf + t * K + jj);
      const float bn = bonus[t];
      acc.x = fmaf(v4.x, bn, acc.x);
      acc.y = fmaf(v4.y, bn, acc.y);
      acc.z = fmaf(v4.z, bn, acc.z);
      acc.w = fmaf(v4.w, bn, acc.w);
      store4(o + base + (t0 + t) * step + jj, acc);
    }
  }
  float* sb = s_out + bh * K * K + (int64_t)s * kSlice * K + j0;
#pragma unroll
  for (int i = 0; i < kSlice; ++i) Vec<kJ>::put(sb + i * K, S[i]);
}

template <typename Tin, typename Tout, int K>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* o, void* s_out, int64_t B, int64_t T_len,
           int64_t H, cudaStream_t stream) {
  constexpr int bytes = Layout<Tin, K>::kBytes;
  auto kern = wkv6_kernel<Tin, Tout, K>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)(B * H), K / kSlice * 16, bytes, stream>>>(
      static_cast<const Tin*>(r), static_cast<const Tin*>(k),
      static_cast<const Tin*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<Tout*>(o),
      static_cast<float*>(s_out), T_len, H);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tout>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* o, void* s_out, int64_t B, int64_t T_len,
             int64_t H, int64_t K, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 32:
      return launch<Tin, Tout, 32>(r, k, v, w, u, o, s_out, B, T_len, H, s);
    case 64:
      return launch<Tin, Tout, 64>(r, k, v, w, u, o, s_out, B, T_len, H, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k (B, T, H, K) and v (B, T, H, K) float32 or bfloat16 by the
// symbol's first type, w (B, T, H, K) and u (H, K) float32 -> o (B, T, H,
// K) in the symbol's second type and s_out (B, H, K, K) float32; all
// contiguous and 16-byte aligned; K = V in {32, 64}. Returns
// cudaGetLastError().
#define WKV6_ENTRY(NAME, TIN, TOUT)                                         \
  extern "C" int NAME(const void* r, const void* k, const void* v,          \
                      const void* w, const void* u, void* o, void* s_out,   \
                      int64_t B, int64_t T_len, int64_t H, int64_t K,       \
                      void* stream) {                                       \
    return dispatch<TIN, TOUT>(r, k, v, w, u, o, s_out, B, T_len, H, K,     \
                               stream);                                     \
  }
WKV6_ENTRY(wkv6_f32_f32, float, float)
WKV6_ENTRY(wkv6_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
WKV6_ENTRY(wkv6_bf16_f32, __nv_bfloat16, float)

// The dynamic shared memory that wkv6_kernel asks for at launch
// (launch's cudaFuncSetAttribute), in bytes, for bf16 inputs when
// bf16_in is 1 and float32 when it is 0; -1 for a K the kernel does not
// take. The output type does not change it.
extern "C" int64_t wkv6_smem_bytes(int64_t bf16_in, int64_t K) {
  switch (K) {
    case 32:
      return bf16_in ? Layout<__nv_bfloat16, 32>::kBytes
                     : Layout<float, 32>::kBytes;
    case 64:
      return bf16_in ? Layout<__nv_bfloat16, 64>::kBytes
                     : Layout<float, 64>::kBytes;
    default:
      return -1;
  }
}
