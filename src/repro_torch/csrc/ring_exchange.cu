// The per-shard §4 exchange as a put into the partner's window, for sm_90a.
//
// Replaces the TPU kernel K5 of the JAX package:
//   runtime/backends/pallas_fused.py::_tpu_ring_exchange (body
//   _rdma_exchange_kernel): one remote DMA of this shard's buffer into the
//   partner device's output, with send and receive DMA semaphores; the
//   caller adds the arrival. It runs once per round of
//   PallasFusedBackend.allreduce_shard.
//
// Here each rank of the group is a process with its own CUDA context. Every
// rank allocates one window with cudaMalloc (not from PyTorch's caching
// allocator, whose IPC handle names the allocator's block and not a tensor's
// offset): a control area and one receive slot per round. The 64-byte
// cudaIpcMemHandle of each window goes to every rank (a gloo all_gather in
// the wrapper), and each rank opens its peers' windows with
// cudaIpcOpenMemHandle. Ranks on one card open each other's windows on that
// card; ranks on their own cards reach them over NVLink.
//
// One round r of a call with epoch e (the wrapper counts calls from 1):
//   put     waits until the partner has consumed what this rank put into its
//           slot r in the previous call (ack[r] >= e - 1 in this rank's own
//           control area), then copies x into slot r of the partner's
//           window, 16 bytes per access, grid-stride;
//   signal  after the put (stream order: every block has written), one
//           thread fences at system scope and stores e into the partner's
//           flag[r] with st.release.sys;
//   (where ranks share a card, the wrapper: this rank's stream sync, then a
//   barrier of the group)
//   wait    reads its own flag[r] with ld.acquire.sys, which must hold e,
//           then writes out = x + slot[r] (slot first read after the
//           acquire, through L2 only), and the last block to finish stores e
//           into the partner's ack[r], so the partner may overwrite the slot
//           next call.
// The barrier only where ranks share a card: without MPS their contexts are
// time-sliced, and a wait that spins holds the card while its partner's
// context waits for it to put. On ranks with cards of their own the wait
// spins and the barrier would be pure cost. Measured with 25 MiB a rank
// (experiments/k5_orchestrations.py, PERF.md): 8 ranks on one H100, a call
// took 2.6x as long spinning as with the barrier; 4 ranks on 4 H100s, 1.9x
// as long with the barrier as spinning.
// One slot per round: hypercube partners of later rounds lie outside the
// subcube a rank has synchronised with, so a slot shared across rounds could
// be overwritten while its reader still reads it. Flags carry the call's
// epoch, so a stale flag never satisfies a wait; the ack guards the slot
// across calls. The partner of round r both sends to and receives from this
// rank (the §4 rounds are involutions; the wrapper checks it).
//
// Bits: out = x + recv, one float32 add (bfloat16: the add in float32,
// rounded to nearest even at once, as a torch bf16 add is). No fast-math.
//
// Never hangs: every spin is bounded by a wall-clock deadline read from
// %globaltimer (a block may be preempted and resumed on another SM, whose
// clock64 differs). Past it, the block records (kind << 8 | round) in the
// window's error word and returns; the signal kernel then publishes nothing,
// so the partner fails too. ring_error reads the word after a stream sync,
// and the wrapper raises naming the rank and round. A window that saw an
// error is not reused.
//
// What bounds it on the H100: device memory. Per round a rank reads and
// writes its buffer once for the put and reads two and writes one for the
// add. Ranks that share one card are time-sliced, so a call's time also
// holds context switches and the host's barriers.
//
// Plain C interface for ctypes. Kernels launch on the caller's stream;
// launchers return cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRounds = 32;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // every block resident at once on an H100
constexpr size_t kAlign = 256;

struct Control {
  unsigned long long flag[kMaxRounds];  // epoch of the last put into slot r (written by the partner)
  unsigned long long ack[kMaxRounds];   // epoch of the last slot r the partner consumed
  unsigned int done[kMaxRounds];        // blocks of the running wait that have read slot r
  int error;                            // (kind << 8 | round) of the first timeout, else 0
};

constexpr size_t kControlBytes = (sizeof(Control) + kAlign - 1) / kAlign * kAlign;

enum Kind { kAckTimeout = 1, kDataTimeout = 2, kStaleEpoch = 3 };

struct Window {
  char* base = nullptr;  // this rank's allocation: Control, then `rounds` slots
  size_t slot_bytes = 0;
  int rounds = 0;
  int rank = -1;
  int n = 0;
  char** peers = nullptr;  // every rank's window base as mapped in this process
};

__device__ __forceinline__ unsigned long long load_acquire_sys(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release_sys(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Thread 0 spins until *flag >= want, then the block goes on together.
// False, with `code` recorded, past the deadline or once another block
// has recorded an error.
__device__ bool spin_until(const unsigned long long* flag, unsigned long long want,
                           long long timeout_ns, int* error, int code) {
  __shared__ int ok;
  if (threadIdx.x == 0) {
    ok = 1;
    const unsigned long long start = global_ns();
    while (load_acquire_sys(flag) < want) {
      if (*reinterpret_cast<volatile int*>(error) != 0 ||
          global_ns() - start > static_cast<unsigned long long>(timeout_ns)) {
        atomicCAS(error, 0, code);
        ok = 0;
        break;
      }
      __nanosleep(200);
    }
  }
  __syncthreads();
  return ok != 0;
}

__global__ void __launch_bounds__(kThreads)
put_kernel(const uint4* __restrict__ src, uint4* dst, long long n16,
           const unsigned char* __restrict__ src_tail, unsigned char* dst_tail, int tail,
           const unsigned long long* ack, unsigned long long want_ack, long long timeout_ns,
           int* error, int code) {
  if (!spin_until(ack, want_ack, timeout_ns, error, code)) return;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n16;
       i += stride)
    dst[i] = src[i];
  if (blockIdx.x == 0 && threadIdx.x < tail) dst_tail[threadIdx.x] = src_tail[threadIdx.x];
}

__global__ void signal_kernel(unsigned long long* flag, unsigned long long epoch,
                              const int* error) {
  if (*reinterpret_cast<const volatile int*>(error) != 0) return;  // the put never ran
  __threadfence_system();
  store_release_sys(flag, epoch);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
wait_add_kernel(const T* __restrict__ x, const T* slot, T* __restrict__ out, long long count,
                const unsigned long long* flag, unsigned long long epoch, unsigned int* done,
                unsigned long long* peer_ack, long long timeout_ns, int* error, int code,
                int stale_code) {
  if (!spin_until(flag, epoch, timeout_ns, error, code)) return;
  if (threadIdx.x == 0 && load_acquire_sys(flag) != epoch) atomicCAS(error, 0, stale_code);
  constexpr int kVec = 16 / sizeof(T);
  const long long n_vec = count / kVec;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* sv = reinterpret_cast<const uint4*>(slot);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_vec;
       i += stride) {
    const uint4 a = xv[i];
    const uint4 b = __ldcg(sv + i);  // L2 only: the slot was written from another context
    uint4 c;
    const T* ap = reinterpret_cast<const T*>(&a);
    const T* bp = reinterpret_cast<const T*>(&b);
    T* cp = reinterpret_cast<T*>(&c);
#pragma unroll
    for (int j = 0; j < kVec; ++j) store(cp + j, to_float(ap[j]) + to_float(bp[j]));
    ov[i] = c;
  }
  if (blockIdx.x == 0) {
    for (long long e = n_vec * kVec + threadIdx.x; e < count; e += blockDim.x) {
      store(out + e, to_float(x[e]) + to_float(__ldcg(slot + e)));
    }
  }
  __syncthreads();  // every read of the slot by this block is done
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(done, 1u) == gridDim.x - 1) {  // the last block: the slot is consumed
      *done = 0;
      __threadfence_system();
      store_release_sys(peer_ack, epoch);
    }
  }
}

int grid_for(long long items) {
  const long long blocks = (items + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks));
}

Control* control(char* base) { return reinterpret_cast<Control*>(base); }

char* slot_of(const Window* w, char* base, int round) {
  return base + kControlBytes + static_cast<size_t>(round) * w->slot_bytes;
}

}  // namespace

extern "C" int ring_handle_bytes() { return static_cast<int>(sizeof(cudaIpcMemHandle_t)); }

// Allocate this rank's window (zeroed control area, `rounds` slots of
// slot_bytes each) on the current device and export its IPC handle into
// `handle` (ring_handle_bytes() bytes). *out receives the window.
extern "C" int ring_window_create(long long slot_bytes, int rounds, void** out, void* handle) {
  if (rounds < 1 || rounds > kMaxRounds || slot_bytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Window* w = new Window();
  w->slot_bytes = (static_cast<size_t>(slot_bytes) + kAlign - 1) / kAlign * kAlign;
  w->rounds = rounds;
  cudaError_t err = cudaMalloc(&w->base, kControlBytes + rounds * w->slot_bytes);
  if (err == cudaSuccess) err = cudaMemset(w->base, 0, kControlBytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), w->base);
  if (err != cudaSuccess) {
    if (w->base) cudaFree(w->base);
    delete w;
    return static_cast<int>(err);
  }
  *out = w;
  return 0;
}

// Map every peer's window: handles holds n handles in rank order (this
// rank's own is skipped: a process cannot open its own handle).
extern "C" int ring_window_open(void* window, int rank, int n, const void* handles) {
  Window* w = static_cast<Window*>(window);
  w->rank = rank;
  w->n = n;
  w->peers = new char*[n]();
  const cudaIpcMemHandle_t* h = static_cast<const cudaIpcMemHandle_t*>(handles);
  for (int j = 0; j < n; ++j) {
    if (j == rank) {
      w->peers[j] = w->base;
      continue;
    }
    void* p = nullptr;
    const cudaError_t err = cudaIpcOpenMemHandle(&p, h[j], cudaIpcMemLazyEnablePeerAccess);
    if (err != cudaSuccess) return static_cast<int>(err);
    w->peers[j] = static_cast<char*>(p);
  }
  return 0;
}

// Unmap the peers' windows and free this rank's. Every rank must be done
// with every window first (the wrapper syncs and barriers around it).
extern "C" int ring_window_close(void* window) {
  Window* w = static_cast<Window*>(window);
  cudaError_t first = cudaSuccess;
  for (int j = 0; w->peers && j < w->n; ++j) {
    if (j == w->rank || !w->peers[j]) continue;
    const cudaError_t err = cudaIpcCloseMemHandle(w->peers[j]);
    if (first == cudaSuccess) first = err;
  }
  const cudaError_t err = cudaFree(w->base);
  if (first == cudaSuccess) first = err;
  delete[] w->peers;
  delete w;
  return static_cast<int>(first);
}

// Round `round` of call `epoch`: copy nbytes of x (16-byte aligned) into
// slot `round` of the partner's window once the partner has consumed the
// previous call's.
extern "C" int ring_put(void* window, int round, int partner, const void* x, long long nbytes,
                        long long epoch, long long timeout_ns, void* stream) {
  Window* w = static_cast<Window*>(window);
  if (round < 0 || round >= w->rounds || partner < 0 || partner >= w->n ||
      static_cast<size_t>(nbytes) > w->slot_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n16 = nbytes / 16;
  const int tail = static_cast<int>(nbytes - n16 * 16);
  const unsigned char* src = static_cast<const unsigned char*>(x);
  unsigned char* dst = reinterpret_cast<unsigned char*>(slot_of(w, w->peers[partner], round));
  Control* mine = control(w->base);
  put_kernel<<<grid_for(n16), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(src), reinterpret_cast<uint4*>(dst), n16, src + n16 * 16,
      dst + n16 * 16, tail, &mine->ack[round], static_cast<unsigned long long>(epoch - 1),
      timeout_ns, &mine->error, (kAckTimeout << 8) | round);
  return static_cast<int>(cudaGetLastError());
}

// Publish round `round` of call `epoch` to the partner, after the put.
extern "C" int ring_signal(void* window, int round, int partner, long long epoch, void* stream) {
  Window* w = static_cast<Window*>(window);
  if (round < 0 || round >= w->rounds || partner < 0 || partner >= w->n)
    return static_cast<int>(cudaErrorInvalidValue);
  signal_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      &control(w->peers[partner])->flag[round], static_cast<unsigned long long>(epoch),
      &control(w->base)->error);
  return static_cast<int>(cudaGetLastError());
}

// Wait for the partner's put of round `round` of call `epoch`, then
// out = x + slot; count elements of float32 (dtype 0) or bfloat16 (dtype 1),
// x and out 16-byte aligned.
extern "C" int ring_wait_add(void* window, int round, int partner, const void* x, void* out,
                             long long count, int dtype, long long epoch, long long timeout_ns,
                             void* stream) {
  Window* w = static_cast<Window*>(window);
  if (round < 0 || round >= w->rounds || partner < 0 || partner >= w->n)
    return static_cast<int>(cudaErrorInvalidValue);
  Control* mine = control(w->base);
  unsigned long long* peer_ack = &control(w->peers[partner])->ack[round];
  const unsigned long long e = static_cast<unsigned long long>(epoch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = (kDataTimeout << 8) | round, stale = (kStaleEpoch << 8) | round;
  if (dtype == 0) {
    if (static_cast<size_t>(count) * 4 > w->slot_bytes) return static_cast<int>(cudaErrorInvalidValue);
    wait_add_kernel<float><<<grid_for(count / 4), kThreads, 0, s>>>(
        static_cast<const float*>(x), reinterpret_cast<const float*>(slot_of(w, w->base, round)),
        static_cast<float*>(out), count, &mine->flag[round], e, &mine->done[round], peer_ack,
        timeout_ns, &mine->error, code, stale);
  } else if (dtype == 1) {
    if (static_cast<size_t>(count) * 2 > w->slot_bytes) return static_cast<int>(cudaErrorInvalidValue);
    wait_add_kernel<__nv_bfloat16><<<grid_for(count / 8), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        reinterpret_cast<const __nv_bfloat16*>(slot_of(w, w->base, round)),
        static_cast<__nv_bfloat16*>(out), count, &mine->flag[round], e, &mine->done[round],
        peer_ack, timeout_ns, &mine->error, code, stale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Wait for the stream, then read the window's error word into *code.
extern "C" int ring_error(void* window, void* stream, int* code) {
  Window* w = static_cast<Window*>(window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(code, &control(w->base)->error, sizeof(int),
                                    cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  return static_cast<int>(err);
}
