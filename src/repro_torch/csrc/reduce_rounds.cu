// Table-driven reduce rounds over an (n, F) buffer, for sm_90a.
//
// Replaces two TPU kernels of the JAX package:
//   K1  runtime/backends/pallas_fused.py::_reduce_rounds_kernel (the §4
//       all-reduce: R rounds of val += Σ_k where(mask[r,k], val[gather[r,k]], 0));
//   K2  runtime/backends/pallas_fused.py::_combine_group_kernel (one §2
//       ReduceCombine group: out = Σ_k where(mask[k], val[gather[k]], 0)).
// K2 is this kernel with R = 1 and no self-add.
//
// What bounds it on the H100: device memory. Every round reads rows of the
// whole buffer by runtime index, so a kernel that went back to device
// memory each round would move the buffer 2·R times. Here each block owns
// a column tile [f0, f0 + block_f) of every row and keeps that (n, block_f)
// slab in shared memory across all R rounds: the buffer is read once and
// written once, 2·n·F times the element size in bytes. Columns are independent (a gather
// only moves rows), so blocks never talk to each other.
//
// Bit-exactness: every thread keeps its elements' values in registers and
// computes each round's new value there — recv starts at +0.0f and adds
// `m ? v : 0.0f` for k in order, then val + recv. A round writes the
// pre-round values to the slab, a barrier, all reads, a barrier: every
// round reads only pre-round values. A select and not a product with the
// mask, so -0.0, inf and NaN behave as jnp.where does. Build without
// fast-math.
//
// Float32 and bfloat16 values. A bf16 buffer is held as float in registers
// and in the slab, and every add is done in float32 and rounded to bf16
// at once (__float2bfloat16, round to nearest even), which is what a torch
// bf16 add does on the card: the kernel stays bit-exact with the plain
// replay in bf16 too. Column tiles are counted in elements either way.
//
// Plain C interface for ctypes. Launches on the caller's stream, allocates
// nothing, returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kPerThread = 16;
// Slab capacity in floats (32 KiB of static shared memory, so two blocks
// share an SM and one block's rounds overlap another's loads);
// repro_torch.runtime.backends.cuda_fused chooses block_f so that
// n * block_f stays within it.
constexpr int kSlabFloats = kThreads * kPerThread;

// The value type's rounding of a float32 sum.
__device__ __forceinline__ float rounded(float x, float) { return x; }
__device__ __forceinline__ float rounded(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
reduce_rounds_kernel(const T* __restrict__ x, T* __restrict__ out,
                     const int32_t* __restrict__ gather,
                     const uint8_t* __restrict__ mask, int rounds, int k_rows,
                     int n, long long features, int shift, bool self_add) {
  __shared__ float slab[kSlabFloats];  // (n, block_f), row-major
  const int block_f = 1 << shift;
  const long long f0 = static_cast<long long>(blockIdx.x) << shift;
  const long long left = features - f0;
  const int width = left < block_f ? static_cast<int>(left) : block_f;
  const int elems = n << shift;

  // Each thread owns elements e = threadIdx.x + j * kThreads and keeps
  // their current values in registers. All loads are issued before the
  // first is used, so a block has its whole slab in flight at once.
  float v[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int i = e >> shift, c = e & (block_f - 1);
    v[j] = (e < elems && c < width) ? to_float(x[static_cast<long long>(i) * features + f0 + c]) : 0.0f;
  }

  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int e = threadIdx.x + j * kThreads;
      if (e < elems) slab[e] = v[j];
    }
    __syncthreads();
    // Rows k outside, elements j inside: the kPerThread gathers of one row
    // are independent, so their table and slab loads overlap.
    float recv[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) recv[j] = 0.0f;
    for (int k = 0; k < k_rows; ++k) {
      const long long row = (static_cast<long long>(r) * k_rows + k) * n;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int e = threadIdx.x + j * kThreads;
        if (e < elems) {
          const int i = e >> shift, c = e & (block_f - 1);
          const float val = slab[(__ldg(gather + row + i) << shift) + c];
          recv[j] = rounded(recv[j] + (__ldg(mask + row + i) ? val : 0.0f), T());
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) v[j] = self_add ? rounded(v[j] + recv[j], T()) : recv[j];
    __syncthreads();  // every read of this round's slab is done
  }

#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int i = e >> shift, c = e & (block_f - 1);
    if (e < elems && c < width) store(out + static_cast<long long>(i) * features + f0 + c, v[j]);
  }
}

}  // namespace

extern "C" int reduce_rounds_slab_floats() { return kSlabFloats; }

// x, out: (n, features) float32 (dtype 0) or bfloat16 (dtype 1), contiguous.
// gather: (rounds, k_rows, n) int32 with entries in [0, n); mask: (rounds,
// k_rows, n) bool bytes. block_f = 1 << shift with n * block_f <= kSlabFloats.
extern "C" int reduce_rounds_launch(const void* x, void* out, const void* gather,
                                    const void* mask, int rounds, int k_rows,
                                    int n, long long features, int shift,
                                    int self_add, int dtype, void* stream) {
  const long long n_blocks = (features + (1LL << shift) - 1) >> shift;
  const dim3 grid(static_cast<unsigned>(n_blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* g = static_cast<const int32_t*>(gather);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (dtype == 0) {
    reduce_rounds_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), g, m, rounds, k_rows, n,
        features, shift, self_add != 0);
  } else if (dtype == 1) {
    reduce_rounds_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), g, m, rounds,
        k_rows, n, features, shift, self_add != 0);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
