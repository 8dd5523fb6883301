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
// Bound on the H100: bytes. Each (b, h, t) reads K values of r, k and w
// and V of v, writes V of o, and does about 4*K*V float32 operations;
// at B = 8, T = 4096, H = 32, K = V = 64 (RWKV-6 1.6B) that is about
// 0.8 GB, 0.24 ms at 3.35 TB/s, against 0.13 ms of float32 work at
// 67 TFLOP/s.
//
// Design: the sequential form, one block per (b, h) with V threads; the
// thread of value column j keeps S[:, j] (K floats) in registers, so the
// state never leaves the SM. r, k and w of 32 steps at a time are staged
// in shared memory as float32 (each thread loads its own column of each
// row, so a warp reads whole rows), and each thread reads its v_t[j]
// straight from device memory; the 32 steps then run with no barrier.
// The chunked log-domain form exists for the TPU's matrix unit, and the
// 1e-12 clamp for its log; neither is needed here: every step is K
// multiply-adds per thread on values the thread holds. So no padding of
// T to a chunk either: any T >= 0 runs as it is. B*H blocks (256 at
// B = 8, H = 32) leave some of the 132 SMs with one block of two warps:
// latency, not bandwidth, sets the time; splitting K across warps or
// running chunks in parallel is the redesign. r, k and v are float32 or
// bfloat16; w and u float32; o in r's type; S float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;  // steps staged per barrier

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

template <typename T, int K>
__global__ void __launch_bounds__(K)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, T* __restrict__ o,
            float* __restrict__ s_out, int64_t T_len, int64_t H) {
  __shared__ float rs[kTile][K];
  __shared__ float ks[kTile][K];
  __shared__ float ws[kTile][K];
  __shared__ float us[K];
  const int j = threadIdx.x;            // this thread's value column
  const int64_t bh = blockIdx.x;
  const int64_t h = bh % H;
  const int64_t step = H * K;           // elements between t and t + 1
  const int64_t base = (bh / H) * T_len * step + h * K;
  us[j] = u[h * K + j];

  float S[K];
#pragma unroll
  for (int i = 0; i < K; ++i) S[i] = 0.f;

  for (int64_t t0 = 0; t0 < T_len; t0 += kTile) {
    const int n = T_len - t0 < kTile ? (int)(T_len - t0) : kTile;
    __syncthreads();  // the previous tile's reads are done
    for (int s = 0; s < n; ++s) {
      const int64_t idx = base + (t0 + s) * step + j;
      rs[s][j] = to_f32(r[idx]);
      ks[s][j] = to_f32(k[idx]);
      ws[s][j] = w[idx];
    }
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      const int64_t idx = base + (t0 + s) * step + j;
      const float vj = to_f32(v[idx]);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const float kv = ks[s][i] * vj;
        acc[i & 3] += rs[s][i] * (S[i] + us[i] * kv);
        S[i] = ws[s][i] * S[i] + kv;
      }
      store(o + idx, (acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }
  float* sb = s_out + bh * K * K;
#pragma unroll
  for (int i = 0; i < K; ++i) sb[i * K + j] = S[i];
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* o, void* s_out, int64_t B, int64_t T_len,
             int64_t H, int64_t K, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)(B * H));
  const T* r_ = static_cast<const T*>(r);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const float* w_ = static_cast<const float*>(w);
  const float* u_ = static_cast<const float*>(u);
  switch (K) {
    case 32:
      wkv6_kernel<T, 32><<<grid, 32, 0, s>>>(
          r_, k_, v_, w_, u_, static_cast<T*>(o), static_cast<float*>(s_out),
          T_len, H);
      break;
    case 64:
      wkv6_kernel<T, 64><<<grid, 64, 0, s>>>(
          r_, k_, v_, w_, u_, static_cast<T*>(o), static_cast<float*>(s_out),
          T_len, H);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// r, k (B, T, H, K) and v (B, T, H, K) float32 or bfloat16 by the
// symbol, w (B, T, H, K) and u (H, K) float32 -> o (B, T, H, K) in r's
// type and s_out (B, H, K, K) float32; all contiguous; K = V in
// {32, 64}. Returns cudaGetLastError().
extern "C" int wkv6_f32(const void* r, const void* k, const void* v,
                        const void* w, const void* u, void* o, void* s_out,
                        int64_t B, int64_t T_len, int64_t H, int64_t K,
                        void* stream) {
  return dispatch<float>(r, k, v, w, u, o, s_out, B, T_len, H, K, stream);
}

extern "C" int wkv6_bf16(const void* r, const void* k, const void* v,
                         const void* w, const void* u, void* o, void* s_out,
                         int64_t B, int64_t T_len, int64_t H, int64_t K,
                         void* stream) {
  return dispatch<__nv_bfloat16>(r, k, v, w, u, o, s_out, B, T_len, H, K,
                                 stream);
}
