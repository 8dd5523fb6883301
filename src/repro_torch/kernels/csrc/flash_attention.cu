// Blockwise (flash) attention for the LM zoo's prefill: causal and/or
// sliding-window, GQA by index, a per-row first visible key.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention (body
// _flash_kernel), the TPU kernel that walks key blocks of one
// (batch, head, query block) in a sequential grid axis, keeps the running
// (max, denominator, accumulator) in VMEM scratch, and skips key blocks
// outside the causal / window band and past seq_len.
//
// This is the float32 entry point: the model's float32 runs (the parity
// gates) take it. bf16, the served path's type, runs on the tensor cores
// in flash_attention_tc.cu.
//
// Bound on the H100: operations. Causal attention does 2*B*Hq*T^2*D
// multiply-adds (QK^T and PV, halved by the mask); in float32 on the
// CUDA cores (67 TFLOP/s) that is 2.1 ms at T = 4096, Hq = 32, D = 128,
// against 0.08 ms of bytes.
//
// Design: one block of 256 threads per (query tile of 64 rows, q head,
// batch row). The query tile is staged once in shared memory as float32;
// the block then loops over 64-row key tiles, staging K and V (rows past
// T zero-filled), and only over the tiles that can hold a visible key:
// from the tile of max(kv_start[b], first window key) to the last key
// that seq_len and the causal mask allow. A tile the loop skips would
// leave (m, l, acc) unchanged, so the result equals the TPU kernel's
// whatever the tile sizes. Each thread owns 4 query rows x 4 key columns
// of the score tile and 4 rows x D/16 columns of the accumulator; a
// row's max and sum reduce over the 16 threads that share it by
// shuffles. Shared rows are padded to D+1 floats so the QK^T loop reads
// without bank conflicts. Masked scores are NEG and their p is 0, so a
// query row with no visible key (a left-pad row of a served batch)
// writes 0 (the TPU kernel's max(l, 1e-20) clamp). kv head = h / (Hq /
// Hkv), so no repeated K/V tensor exists. Inputs, output and arithmetic
// are float32.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // key rows per tile
constexpr int kThreads = 256;   // 16 x 16: ty picks rows, tx columns
constexpr float kNeg = -1e30f;  // the port's masking sentinel (ref.NEG)

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const int* __restrict__ kv_start,
             float* __restrict__ out, int64_t T_len, int64_t Hq, int64_t Hkv,
             int causal, int64_t window, int64_t seq_len, float scale) {
  extern __shared__ float smem[];
  constexpr int kS = D + 1;       // padded row stride of Q and K tiles
  constexpr int kP = kBK + 1;     // padded row stride of the P tile
  constexpr int kCols = D / 16;   // accumulator columns per thread
  float* qs = smem;
  float* ks = qs + kBQ * kS;
  float* vs = ks + kBK * kS;
  float* ps = vs + kBK * D;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t q0 = (int64_t)blockIdx.x * kBQ;
  const int64_t h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t hk = h / (Hq / Hkv);
  const int64_t q_row = Hq * D;
  const int64_t k_row = Hkv * D;
  const float* qb = q + b * T_len * q_row + h * D;
  const float* kb = k + b * T_len * k_row + hk * D;
  const float* vb = v + b * T_len * k_row + hk * D;
  const int64_t start = kv_start[b];

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int64_t t = q0 + r;
    qs[r * kS + d] = t < T_len ? qb[t * q_row + d] : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  // the key tiles that can hold a visible key for this query tile
  int64_t k_end = seq_len;
  if (causal && q0 + kBQ < k_end) k_end = q0 + kBQ;
  int64_t k_begin = start > 0 ? start : 0;
  if (window && q0 - window + 1 > k_begin) k_begin = q0 - window + 1;
  k_begin = k_begin / kBK * kBK;

  for (int64_t k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's reads of ks, vs, ps are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const int64_t t = k0 + r;
      const bool in = t < T_len;
      ks[r * kS + d] = in ? kb[t * k_row + d] : 0.f;
      vs[r * D + d] = in ? vb[t * k_row + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * kS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[(tx + 16 * j) * kS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qp = q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kp = k0 + tx + 16 * j;
        ok[j] = kp < seq_len && kp >= start && (!causal || kp <= qp) &&
                (!window || kp > qp - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * kP + tx + 16 * j] = p;
        rs += p;
      }
      rs = half_warp_sum(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float vv[kCols];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) vv[jj] = vs[c * D + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty + 16 * i) * kP + c];
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj)
          acc[i][jj] = fmaf(p, vv[jj], acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qp = q0 + ty + 16 * i;
    if (qp >= T_len) continue;
    const float den = fmaxf(l[i], 1e-20f);
    float* o = out + (b * T_len + qp) * q_row + h * D;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj)
      o[tx + 16 * jj] = acc[i][jj] / den;
  }
}

template <int D>
int run(const void* q, const void* k, const void* v, const void* kv_start,
        void* out, int64_t B, int64_t T_len, int64_t Hq, int64_t Hkv,
        int64_t causal, int64_t window, int64_t seq_len,
        cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  // 1 / sqrt(D) rounded once to float, as the plain version's scalar
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid((unsigned)((T_len + kBQ - 1) / kBQ), (unsigned)Hq,
                  (unsigned)B);
  flash_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(kv_start),
      static_cast<float*>(out), T_len, Hq, Hkv, causal ? 1 : 0, window,
      seq_len, scale);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v,
             const void* kv_start, void* out, int64_t B, int64_t T_len,
             int64_t Hq, int64_t Hkv, int64_t D, int64_t causal,
             int64_t window, int64_t seq_len, void* stream) {
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

}  // namespace

// q (B, T, Hq, D), k and v (B, T, Hkv, D) float32, kv_start (B,) int32
// -> out (B, T, Hq, D) float32, all contiguous; D in {32, 64, 128}.
// seq_len (1..T) masks keys at and past it; window 0 means none. Returns
// cudaGetLastError().
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, const void* kv_start,
                                   void* out, int64_t B, int64_t T_len,
                                   int64_t Hq, int64_t Hkv, int64_t D,
                                   int64_t causal, int64_t window,
                                   int64_t seq_len, void* stream) {
  return dispatch(q, k, v, kv_start, out, B, T_len, Hq, Hkv, D, causal,
                  window, seq_len, stream);
}

// The dynamic shared memory that flash_kernel<D> asks for at launch
// (run<D>'s cudaFuncSetAttribute), in bytes; -1 for a head dim the
// kernel does not take.
extern "C" int64_t flash_attention_f32_smem_bytes(int64_t D) {
  switch (D) {
    case 32: return smem_floats<32>() * (int64_t)sizeof(float);
    case 64: return smem_floats<64>() * (int64_t)sizeof(float);
    case 128: return smem_floats<128>() * (int64_t)sizeof(float);
    default: return -1;
  }
}
