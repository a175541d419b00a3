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
// Layout: q (B, Sq, Hq, D), k (B, Sk, Hkv, D), v (B, Sk, Hkv, Dv), o
// (B, Sq, Hq, Dv), each with its own strides and contiguous rows. Dv is
// D for the GQA configs (64, 96, 128) and 128 at MLA's D = 192: the JAX
// package pads V to 192 with zeros and slices the output back, and zero
// columns of V touch neither m nor l, so reading V at its own width gives
// the same 128 columns with a third less P V work. Query head h reads KV
// head h / (Hq / Hkv) in place, so the GQA repeat is never built (it would
// move G = 8 times the K/V bytes at TinyLlama-1.1B). The TPU's grid runs in
// order and carries m, l and acc in scratch from one key tile to the next;
// here one block owns (batch, head, q tile) and loops over the key tiles
// itself, so nothing crosses blocks. The grid takes the heaviest causal q
// tiles first, so the last wave of blocks is short.
//
// What bounds it on the H100: operations. At the prefill shape (8 × 2048
// tokens, 32 heads of 64, causal) the two products do 4·B·Hq·S²·D/2 =
// 1.4e11 flops over 0.1 GB of q, k, v and o: the bound is 0.14 ms at the
// 989 TFLOP/s of the bf16 tensor cores, which only wgmma reaches.
//
// Two bodies, chosen by dtype (the wrapper's rule):
//
// * wgmma (bf16, the prefill's): persistent, one block per SM walking the
//   work items (batch, head, 128-row q tile) heaviest first. Two consumer
//   warpgroups own 64 query rows each; a producer warpgroup gives its
//   registers to them (setmaxnreg) and its first thread loads Q into one
//   of two slots (the next item's Q lands during this one; at D = 192 one
//   slot, handed back once the item's last scores are in, see Cfg) and
//   128-key K and V tiles through a ring of 3 (D = 64) or 2 stages in
//   shared memory: TMA over a 4D tensor map of each strided (B, S, H, D)
//   operand (encoded on the host per call, passed as a
//   __grid_constant__), mbarriers for full and empty slots, K and V apart so S = Q Kᵀ starts before V lands.
//   S = Q Kᵀ is a wgmma with both operands K-major in shared memory; O +=
//   P V a wgmma with P from registers (the S accumulators rounded to bf16,
//   FlashAttention-2's register reuse) and V MN-major in shared memory (the
//   transpose bit). In each warpgroup Q K_{j+1}ᵀ and P_j V_j are issued
//   together and the softmax of tile j + 1 runs while P_j V_j is on the
//   tensor cores; the two warpgroups take turns to issue (named barriers),
//   so one's softmax overlaps the other's products (FlashAttention-3's
//   schedule). Tiles land in the 128-byte swizzle, 64 columns of D wide;
//   D = 128 takes two such column blocks, D = 192 three, and D = 96 two,
//   the second zero-filled by TMA past D (Q Kᵀ runs only D/16 steps; the
//   zero columns of P V are not stored); V takes the blocks of its own
//   Dv. Only tiles that cross the causal diagonal, the window's edge or
//   the end of the keys evaluate the mask; softmax runs
//   in the log2 domain (scale · log2 e folded into one FFMA, ex2.approx),
//   masked scores -inf against a finite running max, so masked weights are
//   exactly 0. Rows past Sq are computed on zero-filled Q and not stored.
// * mma.sync (float32; the first port's design, which also took bf16):
//   each of the block's four warps owns 16 of 64 query rows through
//   mma.sync m16n8k16; 64-key tiles are loaded synchronously. Float32
//   operands are split into bf16 high and low parts and each product is
//   taken as hi·hi + hi·lo + lo·hi, about 16 bits of mantissa.
//
// Plain C interface for ctypes. Launches on the caller's stream, allocates
// nothing, returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

// Rows [row0, row0 + kRows) of one head's (S, D) float32 slice into shared
// memory (row stride D + 8), zeros past `rows`, split into bf16 hi and
// lo = bf16(x - hi).
template <int D, int kRows>
__device__ __forceinline__ void load_tile(bf16* hi, bf16* lo, const float* src, long long stride,
                                          int row0, int rows) {
  constexpr int kStride = D + 8;
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

// D: the head dim of q and k, Dv: of v and o.
template <int D, int Dv>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(const Params p) {
  constexpr int kStride = D + 8;    // bf16 per shared row of Q, K; 16-byte aligned, no bank conflicts
  constexpr int kStrideV = Dv + 8;  // and of V
  constexpr int kTile = kBlockK * kStride;
  constexpr int kTileV = kBlockK * kStrideV;
  constexpr int kSteps = D / 16;   // k-steps of Q Kᵀ
  constexpr int kDTiles = Dv / 8;  // n-tiles of P V
  static_assert(kBlockQ == kBlockK, "Q and K tiles share one shared-memory shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const q_hi = reinterpret_cast<bf16*>(smem_raw);
  bf16* const k_hi = q_hi + kTile;
  bf16* const v_hi = k_hi + kTile;
  bf16* const q_lo = v_hi + kTileV;
  bf16* const k_lo = q_lo + kTile;
  bf16* const v_lo = k_lo + kTile;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group and column pair
  const int bh = blockIdx.x;
  const int b = bh / p.hq, h = bh % p.hq, hk = h / p.group;
  // heaviest causal tiles first, so the last wave of blocks is short
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;

  const float* q = static_cast<const float*>(p.q) + b * p.q_b + h * p.q_h;
  const float* k = static_cast<const float*>(p.k) + b * p.k_b + hk * p.k_h;
  const float* v = static_cast<const float*>(p.v) + b * p.v_b + hk * p.v_h;

  load_tile<D, kBlockQ>(q_hi, q_lo, q, p.q_s, q0, p.sq);
  __syncthreads();
  uint32_t qa[kSteps][4], qa_lo[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int off = (16 * warp + g) * kStride + 16 * kk + 2 * t;
    qa[kk][0] = lds32(q_hi + off);
    qa[kk][1] = lds32(q_hi + off + 8 * kStride);
    qa[kk][2] = lds32(q_hi + off + 8);
    qa[kk][3] = lds32(q_hi + off + 8 * kStride + 8);
    qa_lo[kk][0] = lds32(q_lo + off);
    qa_lo[kk][1] = lds32(q_lo + off + 8 * kStride);
    qa_lo[kk][2] = lds32(q_lo + off + 8);
    qa_lo[kk][3] = lds32(q_lo + off + 8 * kStride + 8);
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
    load_tile<D, kBlockK>(k_hi, k_lo, k, p.k_s, k0, p.sk);
    load_tile<Dv, kBlockK>(v_hi, v_lo, v, p.v_s, k0, p.sk);
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
        mma(s[nt], qa_lo[kk], lds32(k_hi + off), lds32(k_hi + off + 8));
        mma(s[nt], qa[kk], lds32(k_lo + off), lds32(k_lo + off + 8));
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
        const __nv_bfloat162 hi2 = *reinterpret_cast<const __nv_bfloat162*>(&pa[i]);
        pa_lo[i] = pack(e0 - __low2float(hi2), e1 - __high2float(hi2));
      }
#pragma unroll
      for (int nd = 0; nd < kDTiles; nd += 2) {
        const int off = (16 * j + (mi & 1) * 8 + mr) * kStrideV + (nd + (mi >> 1)) * 8;
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, v_hi + off);
        uint32_t vl[4];
        ldmatrix_x4_trans(vl, v_lo + off);
        mma(acc[nd], pa_lo, vb[0], vb[1]);
        mma(acc[nd + 1], pa_lo, vb[2], vb[3]);
        mma(acc[nd], pa, vl[0], vl[1]);
        mma(acc[nd + 1], pa, vl[2], vl[3]);
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
  float* o = static_cast<float*>(p.o) + b * p.o_b + h * p.o_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (q_pos[r] >= p.sq) continue;
    float* row = o + q_pos[r] * p.o_s + 2 * t;
#pragma unroll
    for (int nd = 0; nd < kDTiles; ++nd) {
      const float x0 = acc[nd][2 * r] / l[r], x1 = acc[nd][2 * r + 1] / l[r];
      *reinterpret_cast<float2*>(row + 8 * nd) = make_float2(x0, x1);
    }
  }
}

// q, k, v: hi and lo
template <int D, int Dv>
constexpr int smem_bytes() {
  return (4 * kBlockK * (D + 8) + 2 * kBlockK * (Dv + 8)) * static_cast<int>(sizeof(bf16));
}

template <int D, int Dv>
int launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D, Dv>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<D, Dv>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(batch) * p.hq, (p.sq + kBlockQ - 1) / kBlockQ);
  flash_attention_kernel<D, Dv><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------------- wgmma body (bf16)
namespace wg {

constexpr int kBK = 128;  // keys per tile
constexpr int kRegion = kBK * 128;  // bytes of one 64-column block of a K or V tile
constexpr int kProducerRegs = 24;

constexpr int kW = 2;                     // consumer warpgroups, 64 query rows each
constexpr int kBQ = 64 * kW;              // query rows per work item
constexpr int kConsumers = 128 * kW;
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup (one thread issues)
constexpr int kConsumerRegs = 240;          // 128·24 + 256·240 <= 65536
constexpr int kMaxSmem = 232448;            // the most shared memory a block may take
static_assert(kBQ == kBK, "Q, K and V tiles share one shared-memory shape");

// D: the head dim of q and k, Dv: of v and o. A tile is one 64-column block
// (a region) per 64 columns of its head dim, D = 96 padded to 128 with
// zeros. Two Q slots let the next work item's Q load during this one; at
// D = 192 (MLA) two slots and a two-stage ring would take 256 KB, so that
// instance keeps one slot and hands it back as soon as its last scores are
// in (208 KB).
template <int D, int Dv>
struct Cfg {
  static constexpr int kRegions = (D + 63) / 64;    // of a Q or K tile
  static constexpr int kRegionsV = (Dv + 63) / 64;  // of a V tile
  static constexpr int kTile = kRegions * kRegion;
  static constexpr int kTileV = kRegionsV * kRegion;
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kQSlots = D == 192 ? 1 : 2;
  // the Q slots, the K and V rings, the barriers, the 1024-byte alignment
  static constexpr int kSmem = kTile * kQSlots + (kTile + kTileV) * kStages +
                               8 * (2 * kQSlots + 3 * kStages) + 1024;
  static_assert(kSmem <= kMaxSmem, "the tiles do not fit in a block's shared memory");
};

struct Out {
  void* o;
  long long o_b, o_s, o_h;
  int batch, sq, sk, hq, group, dv;
  int causal, window;
  float scale_log2;  // scale · log2(e): scores live in the log2 domain
};

// S = Q Kᵀ for one key tile, issued and committed (not waited for): both
// operands K-major in shared memory, 16 of D a step.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[64], const uint8_t* q, const uint8_t* k) {
  hopper::fence_regs(sc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * kRegion + (kk % 4) * 32;
    hopper::wgmma_m64n128k16_bf16_ss(sc, hopper::desc_sw128(q + off, 16, 1024),
                                     hopper::desc_sw128(k + off, 16, 1024), kk > 0);
  }
  hopper::wgmma_commit();
}

// O += P V for one key tile, issued and committed: P from registers (the
// S accumulators of keys 16kk..16kk+15 are the A fragment of step kk), V
// MN-major in shared memory, one n64 wgmma per 64-column block of D.
template <int R>
__device__ __forceinline__ void issue_pv(float (&o)[R][32], const uint32_t (&pa)[kBK / 16][4],
                                         const uint8_t* v) {
#pragma unroll
  for (int r = 0; r < R; ++r) hopper::fence_regs(o[r]);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < R; ++r)
      hopper::wgmma_m64n64k16_bf16_rs_tb(
          o[r], pa[kk], hopper::desc_sw128(v + r * kRegion + kk * 16 * 128, 1024, 1024), 1);
  hopper::wgmma_commit();
}

// Online softmax of one tile's scores in place: sc becomes p (float32),
// m and l move on, alpha is the factor for the accumulator. Scores stay
// raw; p = 2^(s·c - m·c) with c = scale · log2 e, one FFMA and one ex2. Only
// tiles that cross the causal diagonal, the window's edge or the end of
// the keys evaluate the mask; masked scores are -inf, and m starts finite,
// so their weights are exactly 0.
__device__ __forceinline__ void softmax(float (&sc)[64], float (&m)[2], float (&l)[2],
                                        float (&alpha)[2], const Out& p, int k0, int qw0,
                                        int row0, int t) {
  const bool masked = k0 + kBK > p.sk || (p.causal && k0 + kBK - 1 > qw0) ||
                      (p.window > 0 && qw0 + 63 - k0 >= p.window);
  float mx[2] = {m[0], m[1]};
  if (masked) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int qp = row0 + 8 * ((i % 4) / 2), kp = k0 + 8 * (i / 4) + 2 * t + (i % 2);
      const bool ok = kp < p.sk && (!p.causal || qp >= kp) &&
                      (p.window <= 0 || qp - kp < p.window);
      sc[i] = ok ? sc[i] : -INFINITY;
      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sc[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sc[i]);
  }
  float neg_mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = hopper::ex2((m[r] - mx[r]) * p.scale_log2);
    m[r] = mx[r];
    neg_mc[r] = -mx[r] * p.scale_log2;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    sc[i] = hopper::ex2(fmaf(sc[i], p.scale_log2, neg_mc[(i % 4) / 2]));
    sum[(i % 4) / 2] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

// Persistent: one block per SM walks the work items (batch, head, q tile)
// in the grid order of the mma.sync body, heaviest causal q tiles first,
// item i, i + gridDim.x, ...; the producer loads the next item's Q and
// first K/V tiles while the consumers finish the current one.
template <int D, int Dv>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v, const Out p) {
  using C = Cfg<D, Dv>;
  constexpr int S = C::kStages, R = C::kRegions, RV = C::kRegionsV, Q = C::kQSlots;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* const k_ring = smem + C::kTile * Q;
  uint8_t* const v_ring = k_ring + C::kTile * S;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(v_ring + C::kTileV * S);
  uint64_t* const q_full = bars;
  uint64_t* const q_empty = bars + Q;
  uint64_t* const k_full = bars + 2 * Q;
  uint64_t* const v_full = bars + 2 * Q + S;
  uint64_t* const empty = bars + 2 * Q + 2 * S;
  auto q_tile = [&](int i) { return smem + C::kTile * i; };
  auto k_tile = [&](int s) { return k_ring + C::kTile * s; };
  auto v_tile = [&](int s) { return v_ring + C::kTileV * s; };

  const int n_qt = (p.sq + kBQ - 1) / kBQ, bh_n = p.batch * p.hq;
  const int n_items = n_qt * bh_n;
  // key tiles some row of the item's q tile can see (the wrapper's _key_tiles)
  auto key_range = [&](int q0, int& k_begin, int& n_tiles) {
    int k_end = p.sk;
    k_begin = 0;
    if (p.causal) k_end = min(p.sk, q0 + kBQ);
    if (p.window > 0) k_begin = max(0, q0 - p.window + 1) / kBK * kBK;
    n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < Q; ++i) {
      hopper::mbar_init(&q_full[i], 1);
      hopper::mbar_init(&q_empty[i], kConsumers / 32);
    }
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers / 32);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // producer warpgroup: one thread issues every load
    hopper::regs_dec<kProducerRegs>();
    if (warp == kConsumers / 32 && lane == 0) {
      int tile = 0, n = 0;  // K/V tiles and items loaded so far by this block
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
        const int bh = item % bh_n, q0 = (n_qt - 1 - item / bh_n) * kBQ;
        const int b = bh / p.hq, h = bh % p.hq, hk = h / p.group;
        const int qs = n % Q;
        hopper::mbar_wait(&q_empty[qs], ((n / Q) & 1) ^ 1);
        hopper::mbar_expect_tx(&q_full[qs], C::kTile);
        for (int r = 0; r < R; ++r)
          hopper::tma_load_4d(q_tile(qs) + r * kRegion, &map_q, &q_full[qs], 64 * r, h, q0, b);
        int k_begin, n_tiles;
        key_range(q0, k_begin, n_tiles);
        for (int it = 0; it < n_tiles; ++it, ++tile) {
          const int s = tile % S, k0 = k_begin + it * kBK;
          hopper::mbar_wait(&empty[s], ((tile / S) & 1) ^ 1);
          hopper::mbar_expect_tx(&k_full[s], C::kTile);
          for (int r = 0; r < R; ++r)
            hopper::tma_load_4d(k_tile(s) + r * kRegion, &map_k, &k_full[s], 64 * r, hk, k0, b);
          hopper::mbar_expect_tx(&v_full[s], C::kTileV);
          for (int r = 0; r < RV; ++r)
            hopper::tma_load_4d(v_tile(s) + r * kRegion, &map_v, &v_full[s], 64 * r, hk, k0, b);
        }
      }
    }
    return;
  }

  hopper::regs_inc<kConsumerRegs>();
  const int wgi = warp / 4, w = warp % 4, g = lane / 4, t = lane % 4;
  float o[RV][32];
  float m[2], l[2], alpha[2];
  float sc[64];
  uint32_t pa[kBK / 16][4];
  auto pack_p = [&] {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = pack(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
  };
  auto arrive = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bar);
  };

  // The warpgroups take turns, in order, to issue their products, so one's
  // softmax runs while another's products hold the tensor cores. Named
  // barrier 2 + w is warpgroup w's turn (its 128 threads wait, the previous
  // warpgroup's 128 arrive); the last warpgroup hands warpgroup 0 the first.
  auto my_turn = [&] { hopper::named_barrier(2 + wgi, 256); };
  auto your_turn = [&] { hopper::named_arrive(2 + (wgi + 1) % kW, 256); };
  if (wgi == kW - 1) hopper::named_arrive(2, 256);

  int tile = 0, n = 0;  // K/V tiles and items consumed so far by this block
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
    const int bh = item % bh_n, q0 = (n_qt - 1 - item / bh_n) * kBQ;
    const int b = bh / p.hq, h = bh % p.hq;
    const int qw0 = q0 + 64 * wgi;      // first query row of this warpgroup
    const int row0 = qw0 + 16 * w + g;  // this thread's rows: row0 (e < 2), row0 + 8 (e >= 2)
    const int qs = n % Q;
    const uint8_t* const q_wg = q_tile(qs) + 64 * wgi * 128;
    int k_begin, n_tiles;
    key_range(q0, k_begin, n_tiles);
#pragma unroll
    for (int r = 0; r < RV; ++r)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[r][i] = 0.f;
    m[0] = m[1] = -1e30f;  // finite, so masked scores (-inf) give exp2 = 0
    l[0] = l[1] = 0.f;     // this thread's share of the row sums

    // The products of tile it + 1 overlap the softmax of tile it: Q K_{it+1}ᵀ
    // and P_it V_it are issued together, the scores are waited for, and their
    // softmax runs while P V is still on the tensor cores.
    // With one Q slot, the slot goes back once the item's last scores are in:
    // the next item's Q then loads during this one's last P V and store.
    auto release_q = [&](bool last) {
      if (Q == 1 && last) arrive(&q_empty[qs]);
    };
    hopper::mbar_wait(&q_full[qs], (n / Q) & 1);
    if (n_tiles > 0) {
      const int s = tile % S;
      hopper::mbar_wait(&k_full[s], (tile / S) & 1);
      my_turn();
      issue_qk<D>(sc, q_wg, k_tile(s));
      your_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      release_q(n_tiles == 1);
      softmax(sc, m, l, alpha, p, k_begin, qw0, row0, t);
      pack_p();
    }
    for (int it = 1; it < n_tiles; ++it) {
      const int cur = tile + it, s = cur % S, prev = (cur - 1) % S;
      hopper::mbar_wait(&k_full[s], (cur / S) & 1);
      hopper::mbar_wait(&v_full[prev], ((cur - 1) / S) & 1);
      my_turn();
      issue_qk<D>(sc, q_wg, k_tile(s));
      issue_pv<RV>(o, pa, v_tile(prev));
      your_turn();
      hopper::wgmma_wait<1>();  // the scores; P V may still run
      hopper::fence_regs(sc);
      release_q(it == n_tiles - 1);
      softmax(sc, m, l, alpha, p, k_begin + it * kBK, qw0, row0, t);
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < RV; ++r) hopper::fence_regs(o[r]);
      hopper::fence_regs(pa);
      arrive(&empty[prev]);
#pragma unroll
      for (int r = 0; r < RV; ++r)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[r][i] *= alpha[(i % 4) / 2];
      pack_p();
    }
    if (n_tiles > 0) {
      const int cur = tile + n_tiles - 1, last = cur % S;
      hopper::mbar_wait(&v_full[last], (cur / S) & 1);
      my_turn();
      issue_pv<RV>(o, pa, v_tile(last));
      your_turn();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < RV; ++r) hopper::fence_regs(o[r]);
      hopper::fence_regs(pa);
      arrive(&empty[last]);
    }
    if (Q == 2 || n_tiles == 0) arrive(&q_empty[qs]);
    tile += n_tiles;

    // Row sums across the quad, l == 0 -> 1, and the store of rows < sq.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = l[r] == 0.f ? 1.f : 1.f / l[r];
    }
    bf16* const out = static_cast<bf16*>(p.o) + b * p.o_b + h * p.o_h;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qp = row0 + 8 * half;
      if (qp >= p.sq) continue;
      bf16* const row = out + qp * p.o_s;
#pragma unroll
      for (int r = 0; r < RV; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * r + 8 * j + 2 * t;
          if (col < p.dv)
            *reinterpret_cast<uint32_t*>(row + col) =
                pack(o[r][4 * j + 2 * half] * l[half], o[r][4 * j + 2 * half + 1] * l[half]);
        }
    }
  }
}

// One (B, S, H, D) bf16 operand as a 4D tensor map, tiles of 128 rows of
// one head and 64 columns (128 bytes, the swizzle's width).
inline bool map_bshd(CUtensorMap* map, const void* base, int batch, int seq, int heads, int d,
                     long long s_b, long long s_s, long long s_h) {
  const uint64_t dims[4] = {static_cast<uint64_t>(d), static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(seq), static_cast<uint64_t>(batch)};
  const uint64_t strides[3] = {static_cast<uint64_t>(s_h) * 2, static_cast<uint64_t>(s_s) * 2,
                               static_cast<uint64_t>(s_b) * 2};
  const uint32_t box[4] = {64, 1, kBQ, 1};
  return hopper::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box);
}

template <int D, int Dv>
int launch(const void* q, const void* k, const void* v, const Out& p, int batch, int hkv,
           const long long (&st)[9], cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  using C = Cfg<D, Dv>;
  if (!map_bshd(&mq, q, batch, p.sq, p.hq, D, st[0], st[1], st[2]) ||
      !map_bshd(&mk, k, batch, p.sk, hkv, D, st[3], st[4], st[5]) ||
      !map_bshd(&mv, v, batch, p.sk, hkv, Dv, st[6], st[7], st[8]))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_wgmma_kernel<D, Dv>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = static_cast<long long>(batch) * p.hq * ((p.sq + kBQ - 1) / kBQ);
  const int grid = static_cast<int>(items < hopper::sm_count() ? items : hopper::sm_count());
  flash_attention_wgmma_kernel<D, Dv><<<grid, kThreads, C::kSmem, stream>>>(mq, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

// The (head dim of q and k, of v) pairs both bodies take: the GQA configs'
// 64, 96 and 128, and MLA's (192, 128).
#define FLASH_PAIRS(X) X(64, 64) X(96, 96) X(128, 128) X(192, 128)

// The dynamic shared memory, in bytes, one block of a body (0: mma.sync,
// 1: wgmma) takes at a (d, dv) pair; -1 where either is not supported.
extern "C" int flash_attention_smem_bytes(int d, int dv, int body) {
#define SMEM(D, DV) \
  if (d == D && dv == DV) return body == 1 ? wg::Cfg<D, DV>::kSmem : body == 0 ? smem_bytes<D, DV>() : -1;
  FLASH_PAIRS(SMEM)
#undef SMEM
  return -1;
}

// q (batch, sq, hq, d), k (batch, sk, hkv, d), v (batch, sk, hkv, dv), o
// (batch, sq, hq, dv), each given by (batch, seq, head) strides in elements
// with unit stride over its head dim; rows 16-byte aligned. (d, dv) a pair
// of FLASH_PAIRS; hkv divides hq; sk >= 1. window 0: none. dtype 0: float32,
// 1: bfloat16. body 0: mma.sync (float32 only), 1: wgmma (bf16 only).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int batch, int sq, int sk, int hq, int hkv, int d, int dv,
                                      long long q_b, long long q_s, long long q_h,
                                      long long k_b, long long k_s, long long k_h,
                                      long long v_b, long long v_s, long long v_h,
                                      long long o_b, long long o_s, long long o_h,
                                      int causal, int window, float scale, int dtype, int body,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (dtype != 1 || sk < 1) return static_cast<int>(cudaErrorInvalidValue);
    const wg::Out p{o, o_b, o_s, o_h, batch, sq, sk, hq, hq / hkv, dv, causal, window,
                    scale * 1.4426950408889634f};
    const long long st[9] = {q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h};
#define WG_LAUNCH(D, DV) \
  if (d == D && dv == DV) return wg::launch<D, DV>(q, k, v, p, batch, hkv, st, s);
    FLASH_PAIRS(WG_LAUNCH)
#undef WG_LAUNCH
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (body != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, sq, sk, hq, hq / hkv, q_b, q_s, q_h, k_b, k_s, k_h,
           v_b, v_s, v_h, o_b, o_s, o_h, causal, window, scale};
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
#define LAUNCH(D, DV) \
  if (d == D && dv == DV) return launch<D, DV>(p, batch, s);
  FLASH_PAIRS(LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
