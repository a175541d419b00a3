// Table-driven reduce rounds over an (n, F) buffer, for sm_90a.
//
// Replaces two TPU kernels of the JAX package:
//   K1  runtime/backends/pallas_fused.py::_reduce_rounds_kernel (the §4
//       all-reduce: R rounds of val += Σ_k where(mask[r,k], val[gather[r,k]], 0));
//   K2  runtime/backends/pallas_fused.py::_combine_group_kernel (one §2
//       ReduceCombine group: out = Σ_k where(mask[k], val[gather[k]], 0)),
//       and the add into the accumulator that follows it (`acc + out` in
//       _matmul_executor.combine_fn), fused into the kernel's epilogue.
// K2 is this kernel with R = 1, no self-add and an optional acc operand.
//
// What bounds it on the H100: device memory. Every round reads rows of the
// whole buffer by runtime index, so a kernel that went back to device
// memory each round would move the buffer 2·R times. Here a block owns a
// column tile [f0, f0 + block_f) of every row and keeps that (n, block_f)
// tile on chip across all R rounds: the buffer is read once and written
// once (acc read once more), 2·n·F times the element size in bytes.
// Columns are independent (a gather only moves rows), so blocks never talk
// to each other.
//
// Bit-exactness (both bodies): recv starts at +0.0f and adds `m ? v : 0.0f`
// for k in order, then val + recv (the self-add last), then acc + that.
// Every round reads only pre-round values. A select and not a product with
// the mask, so -0.0, inf and NaN in unselected rows behave as jnp.where
// does. Build without fast-math.
//
// Float32 and bfloat16 values. Every bf16 add is rounded to bf16 at once,
// which is what a torch bf16 add does on the card: the kernel stays
// bit-exact with the plain replay in bf16 too. The slab body adds in
// float32 and rounds with __float2bfloat16; the staged body adds bf16
// pairs with add.rn.bf16x2, the same bits (see Word below). A rounded
// value is a bf16 value, so the staged body keeps its tiles in bf16 in
// shared memory without losing a bit.
//
// Two bodies, chosen by the caller (the wrapper's rule, body_for):
//
// * staged, for Hopper: persistent blocks, two an SM, walk a static
//   stride of column tiles. In each, a producer thread keeps a ring of 2–4
//   stages of (n, block_f) tiles in flight in dynamic shared memory: 2D
//   TMA boxes of up to 256 rows, a full and an empty mbarrier a stage.
//   With acc, each stage holds the acc tile beside x's. While eight
//   consumer warps run tile t's rounds, tiles t+1.. are on their way. The
//   (gather, mask) tables come packed, one int32 an entry (the row, or -1
//   where the mask is false), and are loaded into shared memory once per
//   block. Each consumer thread owns four 16-byte vectors of the tile (4
//   float32 or 8 bf16 columns of a row each) and keeps the same rows in
//   every tile: per round and table row, one table read and one 16-byte
//   shared read per vector, all issued before the adds; an entry whose
//   mask is false reads a row of zeros. Rounds ping-pong between two
//   scratch tiles, so a round needs one barrier among the consumers (the
//   stage is released after round 0); R = 1 needs none. The last round
//   stores from registers, 16 bytes a thread. Takes rows whose byte
//   length and bases are multiples of 16 and tiles whose stages and
//   tables fit the shared memory; refuses anything else. What is left
//   between it and the memory bound at R = 6 is the rounds' shared-memory
//   traffic (the tile is read R + 1 times and written R - 1 times) and
//   their barriers.
// * slab: the first port's body, for every other shape. Each block keeps
//   an (n, block_f) column slab in 32 KiB of static shared memory, 512
//   threads, 16 scalar elements each; two barriers a round.
//
// Plain C interface for ctypes. Launches on the caller's stream, allocates
// nothing, returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for operands the body does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// The value type's rounding of a float32 sum.
__device__ __forceinline__ float rounded(float x, float) { return x; }
__device__ __forceinline__ float rounded(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// ------------------------------------------------------------------- slab

namespace slab {

constexpr int kThreads = 512;
constexpr int kPerThread = 16;
// Slab capacity in floats (32 KiB of static shared memory, so two blocks
// share an SM and one block's rounds overlap another's loads);
// repro_torch.runtime.backends.cuda_fused chooses block_f so that
// n * block_f stays within it.
constexpr int kSlabFloats = kThreads * kPerThread;

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
kernel(const T* __restrict__ x, const T* __restrict__ acc, T* __restrict__ out,
       const int32_t* __restrict__ gather, const uint8_t* __restrict__ mask, int rounds,
       int k_rows, int n, long long features, int shift, bool self_add) {
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
    if (e < elems && c < width) {
      const long long at = static_cast<long long>(i) * features + f0 + c;
      store(out + at, acc != nullptr ? rounded(to_float(acc[at]) + v[j], T()) : v[j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* acc, void* out, const void* gather, const void* mask,
           int rounds, int k_rows, int n, long long features, int shift, int self_add,
           cudaStream_t s) {
  const long long n_blocks = (features + (1LL << shift) - 1) >> shift;
  kernel<T><<<static_cast<unsigned>(n_blocks), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(acc), static_cast<T*>(out),
      static_cast<const int32_t*>(gather), static_cast<const uint8_t*>(mask), rounds, k_rows, n,
      features, shift, self_add != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace slab

// ----------------------------------------------------------------- staged

namespace staged {

constexpr int kConsumers = 256;              // eight consumer warps
constexpr int kThreads = kConsumers + 32;    // and one producer warp
constexpr int kBlocksPerSM = 2;              // one block's barriers overlap the other's rounds
constexpr int kVecs = 4;                     // 16-byte vectors a consumer thread holds per tile
constexpr int kTileBytes = kConsumers * kVecs * 16;
constexpr int kMaxStages = 4;
constexpr int kBoxRows = 256;                // the most rows of a TMA box

// The rounded add of two 32-bit words of T: one float32, or two bf16 added
// by add.rn.bf16x2. That rounds the exact sum once to bf16, which is what
// rounding the float32 sum of two bf16 values gives (that sum is exact or
// lies more than a bf16 half-step from any midpoint), so it has the bits
// of the float32 add and __float2bfloat16 of the plain path. Subnormals
// are kept, NaN comes out canonical, -0.0 + -0.0 is -0.0 either way.
template <typename T> struct Word;
template <> struct Word<float> {
  static constexpr int N = 4;  // values in 16 bytes
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
    return __float_as_uint(__uint_as_float(a) + __uint_as_float(b));
  }
};
template <> struct Word<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
};

// 16-byte shared-memory accesses, spelled out: a warp's 512 contiguous bytes
// are then four conflict-free wavefronts, where four 4-byte accesses
// 16 bytes apart would each conflict four ways.
__device__ __forceinline__ uint4 lds16(const void* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(hopper::smem_addr(p))
               : "memory");
  return v;
}
__device__ __forceinline__ void sts16(void* p, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(hopper::smem_addr(p)),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ void stg16(void* p, uint4 v) { *reinterpret_cast<uint4*>(p) = v; }
template <typename T>
__device__ __forceinline__ uint4 add16(uint4 a, uint4 b) {
  return make_uint4(Word<T>::add(a.x, b.x), Word<T>::add(a.y, b.y), Word<T>::add(a.z, b.z),
                    Word<T>::add(a.w, b.w));
}

// A tile's rows come in TMA boxes of at most kBoxRows rows, all of one
// height; the last box may reach past row n (TMA fills those rows with
// zeros, and no table gathers them). A TMA destination is 128-byte
// aligned, so where there are several boxes their height is a multiple of
// 8 rows (a row is 16 bytes or more).
__host__ __device__ int boxes(int n) { return (n + kBoxRows - 1) / kBoxRows; }
__host__ __device__ int box_rows(int n) {
  return boxes(n) == 1 ? n : ((n + boxes(n) - 1) / boxes(n) + 7) / 8 * 8;
}

// Bytes of one tile in shared memory: its boxes' rows, to 128 bytes.
__host__ __device__ long long tile_bytes(int n, int shift, int esize) {
  const long long bytes = (static_cast<long long>(boxes(n)) * box_rows(n) << shift) * esize;
  return (bytes + 127) / 128 * 128;
}

// Shared-memory layout: the full and empty barriers, a row of zeros (what
// an entry whose mask is false gathers), the packed table, then from a
// 128-byte boundary the stages (each x's tile, then acc's where there is
// one) and, for R > 1, the two scratch tiles.
__host__ __device__ long long header_bytes(int rounds, int k_rows, int n, int shift, int esize) {
  const long long bytes = 2LL * kMaxStages * 8 + (1LL << shift) * esize +
                          4LL * rounds * k_rows * n;
  return (bytes + 127) / 128 * 128;
}

long long smem_bytes(int rounds, int k_rows, int n, int shift, int stages, bool with_acc,
                     int esize) {
  const long long tile = tile_bytes(n, shift, esize);
  return header_bytes(rounds, k_rows, n, shift, esize) + stages * tile * (with_acc ? 2 : 1) +
         (rounds > 1 ? 2 * tile : 0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_acc,
       bool with_acc, T* __restrict__ out, const int32_t* __restrict__ table, int rounds,
       int k_rows, int n, long long features, int shift, int stages, bool self_add) {
  constexpr int V = Word<T>::N;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  T* zeros = reinterpret_cast<T*>(empty + kMaxStages);
  const int block_f = 1 << shift;
  int32_t* tab = reinterpret_cast<int32_t*>(zeros + block_f);
  const int entries = rounds * k_rows * n;
  const int tile = static_cast<int>(tile_bytes(n, shift, sizeof(T)) / sizeof(T));  // elements
  const int stage_elems = with_acc ? 2 * tile : tile;
  T* stage0 = reinterpret_cast<T*>(smem + header_bytes(rounds, k_rows, n, shift, sizeof(T)));
  T* scratch = stage0 + stages * stage_elems;  // two tiles, used when R > 1

  for (int e = threadIdx.x; e < entries; e += kThreads) tab[e] = table[e];
  for (int c = threadIdx.x; c < block_f; c += kThreads) store(zeros + c, 0.0f);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, kConsumers / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const long long n_tiles = (features + block_f - 1) >> shift;
  if (threadIdx.x >= kConsumers) {  // the producer warp; its first thread issues
    if (threadIdx.x != kConsumers) return;
    const int rows = box_rows(n);
    const uint32_t bytes = (static_cast<uint32_t>(boxes(n) * rows) << shift) * sizeof(T) *
                           (with_acc ? 2 : 1);
    int it = 0;
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
      const int s = it % stages;
      const int f0 = static_cast<int>(t << shift);
      hopper::mbar_wait(empty + s, ((it / stages) & 1) ^ 1);
      hopper::mbar_expect_tx(full + s, bytes);
      T* dst = stage0 + s * stage_elems;
      for (int r0 = 0; r0 < n; r0 += rows) {
        hopper::tma_load_2d(dst + (r0 << shift), &map_x, full + s, f0, r0);
        if (with_acc) hopper::tma_load_2d(dst + tile + (r0 << shift), &map_acc, full + s, f0, r0);
      }
    }
    return;
  }

  // A consumer thread owns vectors q = threadIdx.x + j * kConsumers of the
  // tile: row q / (block_f / V), columns V·(q % (block_f / V)) onwards; at
  // (row << shift) + col in a tile. Past the tile's last vector a thread
  // computes on row 0 and stores nothing, so every load of a round is
  // unconditional and independent.
  const int vshift = shift - (V == 4 ? 2 : 3);
  int row[kVecs], col[kVecs], at[kVecs];
  bool mine[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int q = threadIdx.x + j * kConsumers;
    mine[j] = q < (n << vshift);
    row[j] = mine[j] ? q >> vshift : 0;
    col[j] = (q & ((1 << vshift) - 1)) * V;
    at[j] = (row[j] << shift) + col[j];
  }
  const bool lead = threadIdx.x % 32 == 0;

  int ping = 0, it = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    const int s = it % stages;
    const long long f0 = t << shift;
    const int width = features - f0 < block_f ? static_cast<int>(features - f0) : block_f;
    hopper::mbar_wait(full + s, (it / stages) & 1);
    const T* cur = stage0 + s * stage_elems;

    uint4 v[kVecs];
    if (self_add) {
#pragma unroll
      for (int j = 0; j < kVecs; ++j) v[j] = lds16(cur + at[j]);
    }
    for (int r = 0; r < rounds; ++r) {
      uint4 recv[kVecs];
#pragma unroll
      for (int j = 0; j < kVecs; ++j) recv[j] = make_uint4(0, 0, 0, 0);  // +0.0
      for (int k = 0; k < k_rows; ++k) {
        // All table reads, then all gathers (an entry whose mask is false
        // reads the zero row: the select's 0.0), then the adds in order.
        const int32_t* packed = tab + (r * k_rows + k) * n;
        const T* src[kVecs];
#pragma unroll
        for (int j = 0; j < kVecs; ++j) {
          const int g = packed[row[j]];
          src[j] = (g >= 0 ? cur + (g << shift) : zeros) + col[j];
        }
        uint4 w[kVecs];
#pragma unroll
        for (int j = 0; j < kVecs; ++j) w[j] = lds16(src[j]);
#pragma unroll
        for (int j = 0; j < kVecs; ++j) recv[j] = add16<T>(recv[j], w[j]);
      }
#pragma unroll
      for (int j = 0; j < kVecs; ++j) v[j] = self_add ? add16<T>(v[j], recv[j]) : recv[j];
      if (r == 0 && !with_acc) {  // the stage is read: one arrival a warp
        __syncwarp();
        if (lead) hopper::mbar_arrive(empty + s);
      }
      if (r + 1 < rounds) {
        // The next round reads this round's values from a scratch tile. The
        // one barrier also orders every read of the other scratch tile (two
        // rounds back) before this thread's next write into it.
        T* next = scratch + ping * tile;
#pragma unroll
        for (int j = 0; j < kVecs; ++j)
          if (mine[j]) sts16(next + at[j], v[j]);
        hopper::named_barrier(1, kConsumers);
        cur = next;
        ping ^= 1;
      }
    }
    if (with_acc) {
      const T* acc_tile = stage0 + s * stage_elems + tile;
      uint4 a[kVecs];
#pragma unroll
      for (int j = 0; j < kVecs; ++j) a[j] = lds16(acc_tile + at[j]);
#pragma unroll
      for (int j = 0; j < kVecs; ++j) v[j] = add16<T>(a[j], v[j]);
      __syncwarp();
      if (lead) hopper::mbar_arrive(empty + s);
    }
#pragma unroll
    for (int j = 0; j < kVecs; ++j)
      if (mine[j] && col[j] < width)
        stg16(out + static_cast<long long>(row[j]) * features + f0 + col[j], v[j]);
  }
}

// The shared memory a block may take with kBlocksPerSM blocks an SM.
int max_smem() {
  int dev = 0, sm = 0, reserved = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  const int share = sm / kBlocksPerSM - reserved;
  return share < optin ? share : optin;
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// A 2D map over (n, features) values, boxes of (block_f, box_rows(n)),
// landing unswizzled, row after row.
template <typename T>
bool encode(CUtensorMap* map, const void* base, int n, long long features, int shift) {
  const uint64_t dims[2] = {static_cast<uint64_t>(features), static_cast<uint64_t>(n)};
  const uint64_t strides[1] = {static_cast<uint64_t>(features) * sizeof(T)};
  const uint32_t box[2] = {1u << shift, static_cast<uint32_t>(box_rows(n))};
  return hopper::encode_map(map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            2, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <typename T>
int launch(const void* x, const void* acc, void* out, const void* table, int rounds, int k_rows,
           int n, long long features, int shift, int stages, int self_add, cudaStream_t s) {
  constexpr int V = Word<T>::N;
  if (rounds < 1 || k_rows < 1 || n < 1 || features < 1 || features >= (1LL << 31) ||
      shift < (V == 4 ? 2 : 3) || shift > 8 ||
      (static_cast<long long>(n) << shift) * sizeof(T) > kTileBytes || stages < 2 ||
      stages > kMaxStages ||
      (features * static_cast<long long>(sizeof(T))) % 16 != 0 || !aligned(x) || !aligned(out) ||
      (acc != nullptr && !aligned(acc)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = smem_bytes(rounds, k_rows, n, shift, stages, acc != nullptr, sizeof(T));
  if (smem > max_smem()) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_acc;
  if (!encode<T>(&map_x, x, n, features, shift) ||
      !encode<T>(&map_acc, acc != nullptr ? acc : x, n, features, shift))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_tiles = (features + (1LL << shift) - 1) >> shift;
  const long long slots = static_cast<long long>(kBlocksPerSM) * hopper::sm_count();
  const int grid = static_cast<int>(n_tiles < slots ? n_tiles : slots);
  kernel<T><<<grid, kThreads, smem, s>>>(map_x, map_acc, acc != nullptr, static_cast<T*>(out),
                                         static_cast<const int32_t*>(table), rounds, k_rows, n,
                                         features, shift, stages, self_add != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace staged

}  // namespace

extern "C" int reduce_rounds_slab_floats() { return slab::kSlabFloats; }

// The staged body's limits, which the wrapper's tile chooser mirrors: bytes
// of values a tile holds at most (all of them in the consumers' registers),
// stages at most, and the shared memory a block may take on this card.
extern "C" int reduce_rounds_staged_limits(int* tile_bytes, int* max_stages, int* smem) {
  *tile_bytes = staged::kTileBytes;
  *max_stages = staged::kMaxStages;
  *smem = staged::max_smem();
  return 0;
}

// The slab body. x, out (and acc, or null): (n, features) float32 (dtype 0)
// or bfloat16 (dtype 1), contiguous. gather: (rounds, k_rows, n) int32 with
// entries in [0, n); mask: (rounds, k_rows, n) bool bytes. block_f = 1 <<
// shift with n * block_f <= reduce_rounds_slab_floats().
extern "C" int reduce_rounds_launch(const void* x, const void* acc, void* out, const void* gather,
                                    const void* mask, int rounds, int k_rows, int n,
                                    long long features, int shift, int self_add, int dtype,
                                    void* stream) {
  if (rounds < 1 || k_rows < 1 || n < 1 || features < 1 || shift < 0 || shift > 30 ||
      (static_cast<long long>(n) << shift) > slab::kSlabFloats)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return slab::launch<float>(x, acc, out, gather, mask, rounds, k_rows, n, features, shift,
                               self_add, s);
  if (dtype == 1)
    return slab::launch<__nv_bfloat16>(x, acc, out, gather, mask, rounds, k_rows, n, features,
                                       shift, self_add, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The staged body. x, out (and acc, or null): (n, features) as above, with
// features times the element size a multiple of 16 and 16-byte-aligned
// bases, features < 2^31. table: (rounds, k_rows, n) int32, the gathered
// row where the mask holds and -1 where it does not. A tile is block_f = 1
// << shift columns, at least one 16-byte vector wide and at most 256 (a TMA
// box), its n * block_f values within the tile limit, in `stages` stages
// (2..4) whose shared memory a block may take.
extern "C" int reduce_rounds_staged_launch(const void* x, const void* acc, void* out,
                                           const void* table, int rounds, int k_rows, int n,
                                           long long features, int shift, int stages,
                                           int self_add, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return staged::launch<float>(x, acc, out, table, rounds, k_rows, n, features, shift, stages,
                                 self_add, s);
  if (dtype == 1)
    return staged::launch<__nv_bfloat16>(x, acc, out, table, rounds, k_rows, n, features, shift,
                                         stages, self_add, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
