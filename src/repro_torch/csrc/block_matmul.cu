// Batched block product C[z] = A[z] @ B[z] with an fp32 accumulator, for sm_90a.
//
// Replaces the TPU kernel kernels/block_matmul/block_matmul.py::block_matmul
// (_matmul_kernel) of the JAX package, which the §2 `mul_a` contraction runs
// once per router block through a vmap. Here the batch is a grid dimension:
// one launch covers all n router blocks.
//
// What bounds it on the H100: at the §2 shapes (n = 256 blocks of 512 x 512)
// the product is 2·n·X³ FLOP against 3·n·X²·4 bytes, far above the card's
// balance point, so it is bounded by arithmetic. Float32 stays in float32
// (no TF32: the §2 contract is exact on integer-valued floats), so the
// ceiling is the FMA units' 67 TFLOP/s, not the tensor cores. The design is
// the classic shared-memory-tiled FFMA product: a 128 x 128 output tile per
// block, 8-deep slices of A and B staged in shared memory, and an 8 x 8
// register tile per thread, so each value read from shared memory feeds 8
// FMAs. Tails are masked (zero-filled on load, skipped on store), so the
// tiny blocks of small grids (X = 2, 3, 4) run through the same kernel.
// wgmma and TMA are later work.
//
// bf16 inputs are widened to float on load, accumulated in float and
// rounded to bf16 (nearest even) on store, as _matmul_kernel does.
//
// Plain C interface for ctypes. Launches on the caller's stream, allocates
// nothing, returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 128;
constexpr int kTileN = 128;
constexpr int kTileK = 8;
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kMaxBatchPerLaunch = 65535;  // gridDim.z limit

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ c, int M, int N, int K) {
  __shared__ __align__(16) float As[kTileK][kTileM];  // A slice, k-major
  __shared__ __align__(16) float Bs[kTileK][kTileN];

  const long long z = blockIdx.z;
  a += z * M * K;
  b += z * K * N;
  c += z * M * N;
  const int m0 = blockIdx.y * kTileM;
  const int n0 = blockIdx.x * kTileN;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  // Load assignments: A slice is 128 rows x 8 k, 4 consecutive k per thread;
  // B slice is 8 k x 128 columns, 4 consecutive columns per thread.
  const int a_row = tid >> 1, a_k = (tid & 1) * 4;
  const int b_k = tid >> 5, b_col = (tid & 31) * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    const int gm = m0 + a_row;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gk = k0 + a_k + q;
      As[a_k + q][a_row] =
          (gm < M && gk < K) ? widen(a[static_cast<long long>(gm) * K + gk]) : 0.0f;
    }
    const int gk = k0 + b_k;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gn = n0 + b_col + q;
      Bs[b_k][b_col + q] =
          (gk < K && gn < N) ? widen(b[static_cast<long long>(gk) * N + gn]) : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      // rows ty*4 .. +3 and 64 + ty*4 .. +3; columns likewise with tx.
      const float4 a_lo = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b_hi = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float bv[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (gn < N) narrow(&c[static_cast<long long>(gm) * N + gn], acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int batch, int M, int N,
           int K, cudaStream_t stream) {
  const dim3 block(kThreads);
  const long long a_step = static_cast<long long>(M) * K;
  const long long b_step = static_cast<long long>(K) * N;
  const long long c_step = static_cast<long long>(M) * N;
  for (int z0 = 0; z0 < batch; z0 += kMaxBatchPerLaunch) {
    const int nz = batch - z0 < kMaxBatchPerLaunch ? batch - z0 : kMaxBatchPerLaunch;
    const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM, nz);
    block_matmul_kernel<T><<<grid, block, 0, stream>>>(
        static_cast<const T*>(a) + z0 * a_step, static_cast<const T*>(b) + z0 * b_step,
        static_cast<T*>(c) + z0 * c_step, M, N, K);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// a: (batch, M, K), b: (batch, K, N), c: (batch, M, N), all contiguous and
// of one dtype: 0 = float32, 1 = bfloat16.
extern "C" int block_matmul_launch(const void* a, const void* b, void* c,
                                   int batch, int M, int N, int K, int dtype,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, c, batch, M, N, K, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, c, batch, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
