// Flash attention forward for sm_90a: online-softmax attention with float32
// running max m, sum l and accumulator acc, bf16 or float32 in and out.
//
// Replaces the TPU kernel kernels/flash_attention/flash_attention.py::
// flash_attention / _flash_kernel of the JAX package (K4), and computes
// what it computes: s = (q · k) * scale in float32, masked to -1e30 where
// causal (q_pos >= k_pos, both counted from 0, also when Sq != Sk) or the
// sliding window ((q_pos - k_pos) < window) hides the key; per key tile
// m_new = max(m, rowmax s), p = exp(s - m_new), alpha = exp(m - m_new),
// l = l * alpha + Σ p, acc = acc * alpha + p · v with p rounded to v's
// dtype; at the end acc / l with l == 0 -> 1. Two differences of form:
// masked weights are exactly 0 (the Pallas kernel reaches the same numbers
// on every row that sees a key; see the wrapper's docstring), and key tiles
// that no row of the block can see are skipped. Skipping is exact: such a
// tile would add exp(-1e30 - m) = 0 to a row that has seen a key, and 0
// (masked weights) to one that has not.
//
// Layout: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), o (B, Sq, Hq, D), each
// with its own strides and contiguous rows of D. Query head h reads KV
// head h / (Hq / Hkv) in place, so the GQA repeat is never built (it would
// move G = 8 times the K/V bytes at TinyLlama-1.1B). The TPU's grid runs in
// order and carries m, l and acc in scratch from one key tile to the next;
// here one block owns (batch, head, 64-row q tile) and loops over 64-key
// tiles itself, so nothing crosses blocks.
//
// What bounds it on the H100: operations. At the prefill shape (8 × 2048
// tokens, 32 heads of 64, causal) the two products do 4·B·Hq·S²·D/2 =
// 1.4e11 flops over 0.1 GB of q, k, v and o: the bound is 0.14 ms at the
// 989 TFLOP/s of the bf16 tensor cores. The design answers that with
// tensor cores through mma.sync m16n8k16 (bf16 in, float32 accumulate):
// each of the block's four warps owns 16 query rows; S = Q Kᵀ and the
// softmax stay in registers, and P goes from the S accumulators straight
// into the A operand of P V (the FlashAttention-2 register layout), so
// scores never touch shared or device memory. Float32 operands are split
// into bf16 high and low parts and each product is taken as hi·hi + hi·lo
// + lo·hi, about 16 bits of mantissa. Simple first: K/V tiles are loaded
// synchronously (wgmma, TMA and a cp.async pipeline are later work).
//
// Plain C interface for ctypes. Launches on the caller's stream, allocates
// nothing, returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kBlockK = 64;           // keys per tile
constexpr int kKeyTiles = kBlockK / 8;  // n-tiles of S per warp
constexpr float kNegInf = -1e30f;

typedef __nv_bfloat16 bf16;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int sq, sk, hq, group;  // group = Hq / Hkv
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
  int causal, window;  // window 0: none
  float scale;
};

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices, transposed: thread i gets rows 2(i%4), 2(i%4)+1 of
// column i/4 of matrix j in r[j]; threads 8j..8j+7 give matrix j's rows.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [row0, row0 + kRows) of one head's (S, D) slice into shared memory
// (row stride D + 8), zeros past `rows`. bf16 is copied; float32 is split
// into bf16 hi and lo = bf16(x - hi).
template <typename T, int D, int kRows>
__device__ __forceinline__ void load_tile(bf16* hi, bf16* lo, const T* src, long long stride,
                                          int row0, int rows) {
  constexpr int kStride = D + 8;
  if constexpr (sizeof(T) == 2) {
    constexpr int kChunks = D / 8;  // 16 bytes each
    for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row0 + r < rows)
        val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + col);
      *reinterpret_cast<uint4*>(hi + r * kStride + col) = val;
    }
  } else {
    constexpr int kChunks = D / 4;
    for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < rows)
        x = *reinterpret_cast<const float4*>(src + (row0 + r) * stride + col);
      const float e[4] = {x.x, x.y, x.z, x.w};
      uint32_t h[2], l[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bf16 h0 = __float2bfloat16_rn(e[2 * j]), h1 = __float2bfloat16_rn(e[2 * j + 1]);
        h[j] = pack(__bfloat162float(h0), __bfloat162float(h1));
        l[j] = pack(e[2 * j] - __bfloat162float(h0), e[2 * j + 1] - __bfloat162float(h1));
      }
      *reinterpret_cast<uint2*>(hi + r * kStride + col) = make_uint2(h[0], h[1]);
      *reinterpret_cast<uint2*>(lo + r * kStride + col) = make_uint2(l[0], l[1]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(const Params p) {
  constexpr bool kSplit = sizeof(T) == 4;  // float32: hi + lo bf16 parts
  constexpr int kStride = D + 8;           // bf16 per shared row; 16-byte aligned, no bank conflicts
  constexpr int kTile = kBlockK * kStride;
  constexpr int kSteps = D / 16;  // k-steps of Q Kᵀ
  constexpr int kDTiles = D / 8;  // n-tiles of P V
  static_assert(kBlockQ == kBlockK, "Q and K/V tiles share one shared-memory shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const q_hi = reinterpret_cast<bf16*>(smem_raw);
  bf16* const k_hi = q_hi + kTile;
  bf16* const v_hi = k_hi + kTile;
  bf16* const q_lo = v_hi + kTile;  // used when kSplit
  bf16* const k_lo = q_lo + kTile;
  bf16* const v_lo = k_lo + kTile;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group and column pair
  const int bh = blockIdx.x;
  const int b = bh / p.hq, h = bh % p.hq, hk = h / p.group;
  // heaviest causal tiles first, so the last wave of blocks is short
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;

  const T* q = static_cast<const T*>(p.q) + b * p.q_b + h * p.q_h;
  const T* k = static_cast<const T*>(p.k) + b * p.k_b + hk * p.k_h;
  const T* v = static_cast<const T*>(p.v) + b * p.v_b + hk * p.v_h;

  load_tile<T, D, kBlockQ>(q_hi, q_lo, q, p.q_s, q0, p.sq);
  __syncthreads();
  uint32_t qa[kSteps][4], qa_lo[kSplit ? kSteps : 1][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int off = (16 * warp + g) * kStride + 16 * kk + 2 * t;
    qa[kk][0] = lds32(q_hi + off);
    qa[kk][1] = lds32(q_hi + off + 8 * kStride);
    qa[kk][2] = lds32(q_hi + off + 8);
    qa[kk][3] = lds32(q_hi + off + 8 * kStride + 8);
    if constexpr (kSplit) {
      qa_lo[kk][0] = lds32(q_lo + off);
      qa_lo[kk][1] = lds32(q_lo + off + 8 * kStride);
      qa_lo[kk][2] = lds32(q_lo + off + 8);
      qa_lo[kk][3] = lds32(q_lo + off + 8 * kStride + 8);
    }
  }

  // This thread's two query rows: r = 0 for c[0], c[1]; r = 1 for c[2], c[3].
  const int q_pos[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float acc[kDTiles][4];
#pragma unroll
  for (int nd = 0; nd < kDTiles; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  // Key tiles some row of this block can see (the wrapper's _key_tiles).
  int k_begin = 0, k_end = p.sk;
  if (p.causal) k_end = min(p.sk, q0 + kBlockQ);
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1) / kBlockK * kBlockK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D, kBlockK>(k_hi, k_lo, k, p.k_s, k0, p.sk);
    load_tile<T, D, kBlockK>(v_hi, v_lo, v, p.v_s, k0, p.sk);
    __syncthreads();

    // S = Q Kᵀ: B[d][key] = K[key][d], so a B fragment is two bf16 pairs
    // of one K row.
    float s[kKeyTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const int off = (8 * nt + g) * kStride + 16 * kk + 2 * t;
        if constexpr (kSplit) {
          mma(s[nt], qa_lo[kk], lds32(k_hi + off), lds32(k_hi + off + 8));
          mma(s[nt], qa[kk], lds32(k_lo + off), lds32(k_lo + off + 8));
        }
        mma(s[nt], qa[kk], lds32(k_hi + off), lds32(k_hi + off + 8));
      }
    }

    // Scale, mask, and the running max of each row (a row's 64 scores sit
    // in the four threads of a quad).
    uint32_t visible = 0;
    float row_max[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qp = q_pos[j / 2], kp = k0 + 8 * nt + 2 * t + (j & 1);
        const bool ok = kp < p.sk && (!p.causal || qp >= kp) &&
                        (p.window <= 0 || qp - kp < p.window);
        const float x = ok ? s[nt][j] * p.scale : kNegInf;
        s[nt][j] = x;
        visible |= static_cast<uint32_t>(ok) << (4 * nt + j);
        row_max[j / 2] = fmaxf(row_max[j / 2], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(0xffffffffu, row_max[r], 1));
      row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(0xffffffffu, row_max[r], 2));
      const float m_new = fmaxf(m[r], row_max[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = (visible >> (4 * nt + j)) & 1u ? expf(s[nt][j] - m[j / 2]) : 0.f;
        s[nt][j] = e;
        row_sum[j / 2] += e;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + row_sum[r];
#pragma unroll
    for (int nd = 0; nd < kDTiles; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }

    // acc += P V. The S accumulators of key tiles 2j and 2j+1 are the A
    // fragment of k-step j; V's B fragments come transposed by ldmatrix.
    const int mi = lane / 8, mr = lane % 8;
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      // A fragment: {row g, keys 2t..} {row g+8, keys 2t..} {row g, keys
      // 8+2t..} {row g+8, keys 8+2t..} = s[2j][0:2], s[2j][2:4],
      // s[2j+1][0:2], s[2j+1][2:4].
      uint32_t pa[4], pa_lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e0 = s[2 * j + i / 2][2 * (i % 2)], e1 = s[2 * j + i / 2][2 * (i % 2) + 1];
        pa[i] = pack(e0, e1);
        if constexpr (kSplit) {
          const __nv_bfloat162 hi2 = *reinterpret_cast<const __nv_bfloat162*>(&pa[i]);
          pa_lo[i] = pack(e0 - __low2float(hi2), e1 - __high2float(hi2));
        }
      }
#pragma unroll
      for (int nd = 0; nd < kDTiles; nd += 2) {
        const int off = (16 * j + (mi & 1) * 8 + mr) * kStride + (nd + (mi >> 1)) * 8;
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, v_hi + off);
        if constexpr (kSplit) {
          uint32_t vl[4];
          ldmatrix_x4_trans(vl, v_lo + off);
          mma(acc[nd], pa_lo, vb[0], vb[1]);
          mma(acc[nd + 1], pa_lo, vb[2], vb[3]);
          mma(acc[nd], pa, vl[0], vl[1]);
          mma(acc[nd + 1], pa, vl[2], vl[3]);
        }
        mma(acc[nd], pa, vb[0], vb[1]);
        mma(acc[nd + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // Row sums across the quad, l == 0 -> 1, and the store.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (l[r] == 0.f) l[r] = 1.f;
  }
  T* o = static_cast<T*>(p.o) + b * p.o_b + h * p.o_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (q_pos[r] >= p.sq) continue;
    T* row = o + q_pos[r] * p.o_s + 2 * t;
#pragma unroll
    for (int nd = 0; nd < kDTiles; ++nd) {
      const float x0 = acc[nd][2 * r] / l[r], x1 = acc[nd][2 * r + 1] / l[r];
      if constexpr (kSplit) {
        *reinterpret_cast<float2*>(row + 8 * nd) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<uint32_t*>(row + 8 * nd) = pack(x0, x1);
      }
    }
  }
}

template <typename T, int D>
int launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int kTile = kBlockK * (D + 8);
  const int smem = (sizeof(T) == 4 ? 6 : 3) * kTile * static_cast<int>(sizeof(bf16));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(batch) * p.hq, (p.sq + kBlockQ - 1) / kBlockQ);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const Params& p, int batch, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64>(p, batch, stream);
    case 96: return launch<T, 96>(p, batch, stream);
    case 128: return launch<T, 128>(p, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (batch, sq, hq, d), k/v (batch, sk, hkv, d), o (batch, sq, hq, d), each
// given by (batch, seq, head) strides in elements with unit stride over d;
// rows 16-byte aligned. d in {64, 96, 128}; hkv divides hq. window 0: none.
// dtype 0: float32, 1: bfloat16.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int batch, int sq, int sk, int hq, int hkv, int d,
                                      long long q_b, long long q_s, long long q_h,
                                      long long k_b, long long k_s, long long k_h,
                                      long long v_b, long long v_s, long long v_h,
                                      long long o_b, long long o_s, long long o_h,
                                      int causal, int window, float scale, int dtype,
                                      void* stream) {
  Params p{q, k, v, o, sq, sk, hq, hq / hkv, q_b, q_s, q_h, k_b, k_s, k_h,
           v_b, v_s, v_h, o_b, o_s, o_h, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(p, batch, d, s);
  if (dtype == 1) return launch_d<bf16>(p, batch, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
