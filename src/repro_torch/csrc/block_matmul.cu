// Batched block product C[z] = A[z] @ B[z] with an fp32 accumulator, for sm_90a.
//
// Replaces the TPU kernel kernels/block_matmul/block_matmul.py::block_matmul
// (_matmul_kernel) of the JAX package, which the §2 `mul_a` contraction runs
// once per router block through a vmap. Here the batch is a grid dimension:
// one launch covers all n router blocks.
//
// What bounds it on the H100: at the §2 shapes (n = 256 blocks of 512 x 512)
// the product is 2·n·X³ FLOP against 3·n·X²·4 bytes, far above the card's
// balance point, so it is bounded by arithmetic. In float32 outside the
// tensor cores that is the FMA units' 67 TFLOP/s (1.03 ms at the main
// shape), which no FFMA kernel can beat by much and torch.bmm already
// nears. The card's only route past it is the tensor cores, and in float32
// that means an error-compensated product in TF32 (8 exponent bits, 10 of
// mantissa): each operand x is split into hi = x with its low 13 mantissa
// bits cleared and lo = x - hi (exact in float32), and C = A_hi·B_hi +
// A_hi·B_lo + A_lo·B_hi in float32 accumulation, three TF32 products (bound
// 3 · 2·n·X³ / 495 TFLOP/s = 0.42 ms at the main shape). The dropped
// A_lo·B_lo term is below 2^-20 of each product. On the §2 contract's
// integer-valued inputs lo is 0, every product of TF32 values is exact in
// float32 and every partial sum is an integer below 2^24, so the result is
// bit-exact, as the plain float32 product is; on random normals it stays
// within rtol = atol = 2e-4 of it. This is the idea of the multi-pass
// float32 product that the TPU's matrix unit takes for _matmul_kernel's
// float32 jnp.dot.
//
// Two bodies, chosen by the caller (the wrapper's rule, by dtype and shape):
//
// * tf32x3 (float32, K and N multiples of 4, 16-byte-aligned bases): wgmma
//   on TMA tiles. TF32 wgmma takes only K-major operands from shared
//   memory, and B (K, N) row-major is N-major, so the kernel computes
//   Cᵀ = Bᵀ·Aᵀ: the B tile goes to registers as wgmma's A operand (read
//   transposed out of shared memory and split there), and the A tile,
//   K-major, is wgmma's B operand from shared memory, split in place into
//   hi and a lo copy after it lands. A block owns a 128 x 128 tile of C at
//   a time: two consumer warpgroups of 64 columns each, and a producer
//   warpgroup whose first thread keeps a 4-stage ring of 32-deep A and B
//   tiles in flight (3D tensor maps over (batch, rows, cols), mbarriers
//   for full, split and empty slots) while its other three warps split the
//   A tiles. Ragged edges are zero-filled by TMA and masked on store. Past
//   the tensor cores, its limit is shared memory: every wgmma reads its
//   B operand from there, three times per stage (hi twice, lo once) for
//   each warpgroup, beside the TMA writes, the split and the fragment reads.
// * simt: the shared-memory-tiled FFMA product of the first port, for
//   shapes TMA cannot tile (rows of 8 or 12 bytes at the §2 grids' X = 2, 3)
//   and for bf16: a 128 x 128 output tile per block, 8-deep slices of A
//   and B in shared memory, an 8 x 8 register tile per thread. bf16 inputs
//   are widened to float, accumulated in float and rounded to bf16 (nearest
//   even) on store, as _matmul_kernel does. Float32 here is full float32.
//
// Plain C interface for ctypes. Launches on the caller's stream, allocates
// nothing, returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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
int launch_simt(const void* a, const void* b, void* c, int batch, int M, int N,
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


// ------------------------------------------------------- tf32x3 body
namespace tc {

constexpr int kBM = 128;  // rows of C per tile: wgmma's N
constexpr int kBN = 128;  // columns of C per tile: 64 wgmma rows per consumer warpgroup
constexpr int kBK = 32;   // depth of a stage: one 128-byte swizzle row of float32
constexpr int kStages = 4;
constexpr int kConsumers = 256;               // two warpgroups
constexpr int kThreads = kConsumers + 128;    // and a producer warpgroup (one thread issues)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128·40 + 256·232 <= 65536
constexpr int kTileBytes = kBM * kBK * 4;     // 16 KB, for A, A's lo part and B alike
constexpr int kStageBytes = 3 * kTileBytes;   // A (split in place into hi), A lo, B
constexpr int kSmemBytes = kStages * kStageBytes + 3 * kStages * 8 + 1024;  // + barriers, alignment
constexpr uint32_t kHiMask = 0xffffe000u;     // sign, exponent, 10 mantissa bits: TF32

static_assert(kBM == kBN, "one tile size for A, its lo part and B");

typedef uint32_t Frag[kBK / 8][4];  // one stage's Bᵀ fragments, hi or lo

// x -> (hi, lo), hi = x with its low 13 mantissa bits cleared, lo = x - hi.
// Non-finite x keeps its value in hi and has lo = 0.
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  const uint32_t bits = __float_as_uint(x);
  const bool finite = (bits & 0x7f800000u) != 0x7f800000u;
  hi = finite ? __uint_as_float(bits & kHiMask) : x;
  lo = finite ? x - hi : 0.f;
}

struct Stage {
  float* a_hi;
  float* a_lo;
  const float* b;
};

__device__ __forceinline__ Stage stage_at(uint8_t* smem, int s) {
  float* const a = reinterpret_cast<float*>(smem + s * kStageBytes);
  return {a, a + kBM * kBK, a + 2 * kBM * kBK};
}

// Split the stage's A tile in place into hi and a lo copy (the transform
// threads; the swizzle moves whole 16-byte chunks, so an elementwise split
// keeps the layout) and make it visible to wgmma.
__device__ __forceinline__ void split_a(const Stage& st, int tid, int threads) {
  for (int i = tid; i < kBM * kBK / 4; i += threads) {
    const float4 x = reinterpret_cast<const float4*>(st.a_hi)[i];
    float4 hi, lo;
    split(x.x, hi.x, lo.x);
    split(x.y, hi.y, lo.y);
    split(x.z, hi.z, lo.z);
    split(x.w, hi.w, lo.w);
    reinterpret_cast<float4*>(st.a_hi)[i] = hi;
    reinterpret_cast<float4*>(st.a_lo)[i] = lo;
  }
  hopper::fence_proxy_async();
}

// This warp's Bᵀ fragments, wgmma's A operand: row n (of C's columns),
// column k. B's box j holds columns 32j..32j+31 as 32 rows (k) of 128
// bytes, chunk (n % 32) / 4 of row k stored at chunk ((n % 32) / 4) ^ (k % 8).
__device__ __forceinline__ void load_frags(const Stage& st, Frag& bh, Frag& bl, int n_base, int g,
                                           int t) {
#pragma unroll
  for (int ks = 0; ks < kBK / 8; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n_base + g + 8 * (e & 1), k = 8 * ks + t + 4 * (e >> 1);
      const float x = st.b[(n / 32) * 32 * kBK + k * 32 + ((((n % 32) / 4) ^ (k % 8)) * 4) + n % 4];
      float hi, lo;
      split(x, hi, lo);
      bh[ks][e] = __float_as_uint(hi);
      bl[ks][e] = __float_as_uint(lo);
    }
  }
}

// The three TF32 products of one stage into part (from zero), issued and
// committed, not waited for: 8 of k a step, 32 bytes into each 128-byte row
// of A's hi and lo tiles, the small terms first.
__device__ __forceinline__ void issue(float (&part)[64], const Frag& bh, const Frag& bl,
                                      const Stage& st) {
  hopper::fence_regs(part);
  hopper::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kBK / 8; ++ks) {
    const uint64_t d_hi = hopper::desc_sw128(st.a_hi + 8 * ks, 16, 1024);
    const uint64_t d_lo = hopper::desc_sw128(st.a_lo + 8 * ks, 16, 1024);
    hopper::wgmma_m64n128k8_tf32_rs(part, bl[ks], d_hi, ks > 0);
    hopper::wgmma_m64n128k8_tf32_rs(part, bh[ks], d_lo, 1);
    hopper::wgmma_m64n128k8_tf32_rs(part, bh[ks], d_hi, 1);
  }
  hopper::wgmma_commit();
}

// Persistent: one block per SM walks the output tiles (batch, row tile,
// column tile) in grid order, tile i, i + gridDim.x, ...; the producer
// warpgroup loads the next tile's first stages while the consumers finish
// the current one. Its lane 0 of warp 0 issues the TMA loads; its other
// three warps split each A tile into hi and lo as it lands (the transform
// warps), so the consumers only load their Bᵀ fragments and issue.
// Each stage's products go into a fresh accumulator that is added to the
// tile's sum in float32 (round to nearest). Summing all 1536 TF32 products
// of a 512-deep row on the tensor cores alone lets their truncating adds
// drift past the 2e-4 bound on random normals; summed per stage, the result
// is as near the exact sum as cuBLAS's float32 product (chip_smoke.py
// prints both distances).
__global__ void __launch_bounds__(kThreads, 1)
block_matmul_tf32x3_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_b, float* __restrict__ c,
                           int batch, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* const empty = full + kStages;
  uint64_t* const ready = full + 2 * kStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int n_t = (N + kBN - 1) / kBN, m_t = (M + kBM - 1) / kBM;
  const long long n_items = static_cast<long long>(batch) * m_t * n_t;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers / 32);  // one arrival per consumer warp
      hopper::mbar_init(&ready[s], 3);                 // one per transform warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // producer warpgroup
    hopper::regs_dec<kProducerRegs>();
    long long stage = 0;  // stages loaded (split) so far by this block
    for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int nt = static_cast<int>(item % n_t), mt = static_cast<int>(item / n_t % m_t);
      const int z = static_cast<int>(item / (static_cast<long long>(n_t) * m_t));
      for (int kt = 0; kt < k_tiles; ++kt, ++stage) {
        const int s = static_cast<int>(stage % kStages);
        const uint32_t phase = static_cast<uint32_t>((stage / kStages) & 1);
        if (warp > kConsumers / 32) {  // transform warps
          hopper::mbar_wait(&full[s], phase);
          split_a(stage_at(smem, s), threadIdx.x - kConsumers - 32, 96);
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(&ready[s]);
        } else if (lane == 0) {  // the loader
          hopper::mbar_wait(&empty[s], phase ^ 1);
          uint8_t* const st = smem + s * kStageBytes;
          hopper::mbar_expect_tx(&full[s], 2 * kTileBytes);
          hopper::tma_load_3d(st, &map_a, &full[s], kt * kBK, mt * kBM, z);
          // B in four 32-column boxes: each row of a box is 128 bytes
#pragma unroll
          for (int j = 0; j < kBN / 32; ++j)
            hopper::tma_load_3d(st + 2 * kTileBytes + j * 32 * kBK * 4, &map_b, &full[s],
                                nt * kBN + 32 * j, kt * kBK, z);
        }
      }
    }
    return;
  }

  hopper::regs_inc<kConsumerRegs>();
  const int wg = warp / 4, w = warp % 4, g = lane / 4, t = lane % 4;
  const int n_base = 64 * wg + 16 * w;
  float acc[64], part[64];
  Frag bh, bl;
  long long stage = 0;  // stages consumed so far by this block
  auto wait_ready = [&](long long i) {
    hopper::mbar_wait(&ready[i % kStages], static_cast<uint32_t>((i / kStages) & 1));
  };
  // Wait for the stage in flight, add it to the sum, free its slot.
  auto retire = [&](long long i) {
    hopper::wgmma_wait<0>();
    hopper::fence_regs(part);
    hopper::fence_regs(bh);
    hopper::fence_regs(bl);
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[r] += part[r];
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[i % kStages]);
  };
  for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int nt = static_cast<int>(item % n_t), mt = static_cast<int>(item / n_t % m_t);
    const long long z = item / (static_cast<long long>(n_t) * m_t);
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[r] = 0.f;
    // Stage kt's wait overlaps stage kt - 1's products; its fragments are
    // loaded once those are retired.
    for (int kt = 0; kt < k_tiles; ++kt) {
      const long long i = stage + kt;
      wait_ready(i);
      if (kt > 0) retire(i - 1);
      const Stage st = stage_at(smem, static_cast<int>(i % kStages));
      load_frags(st, bh, bl, n_base, g, t);
      issue(part, bh, bl, st);
    }
    retire(stage + k_tiles - 1);
    stage += k_tiles;

    // acc[4j + e]: row n of Cᵀ = n_base + g + 8 (e / 2), column m = 8j + 2t + e % 2.
    float* const cz = c + z * M * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = nt * kBN + n_base + g + 8 * (e >> 1), m = mt * kBM + 8 * j + 2 * t + (e & 1);
        if (m < M && n < N) cz[static_cast<long long>(m) * N + n] = acc[4 * j + e];
      }
    }
  }
}

int launch(const void* a, const void* b, void* c, int batch, int M, int N, int K,
           cudaStream_t stream) {
  if (K % 4 != 0 || N % 4 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b;
  const uint64_t dims_a[3] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M),
                              static_cast<uint64_t>(batch)};
  const uint64_t strides_a[2] = {static_cast<uint64_t>(K) * 4, static_cast<uint64_t>(M) * K * 4};
  const uint32_t box_a[3] = {kBK, kBM, 1};
  const uint64_t dims_b[3] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K),
                              static_cast<uint64_t>(batch)};
  const uint64_t strides_b[2] = {static_cast<uint64_t>(N) * 4, static_cast<uint64_t>(K) * N * 4};
  const uint32_t box_b[3] = {32, kBK, 1};
  if (!hopper::encode_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, a, dims_a, strides_a, box_a) ||
      !hopper::encode_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, b, dims_b, strides_b, box_b))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(block_matmul_tf32x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = static_cast<long long>(batch) * ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const int grid = static_cast<int>(items < hopper::sm_count() ? items : hopper::sm_count());
  block_matmul_tf32x3_kernel<<<grid, kThreads, kSmemBytes, stream>>>(map_a, map_b,
                                                                     static_cast<float*>(c), batch,
                                                                     M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// a: (batch, M, K), b: (batch, K, N), c: (batch, M, N), all contiguous and
// of one dtype: 0 = float32, 1 = bfloat16. body 0 = simt, 1 = tf32x3
// (float32, K and N multiples of 4, a and b 16-byte aligned; else
// cudaErrorInvalidValue).
extern "C" int block_matmul_launch(const void* a, const void* b, void* c,
                                   int batch, int M, int N, int K, int dtype, int body,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
    return tc::launch(a, b, c, batch, M, N, K, s);
  }
  if (body != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch_simt<float>(a, b, c, batch, M, N, K, s);
  if (dtype == 1) return launch_simt<__nv_bfloat16>(a, b, c, batch, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
