// Hopper (sm_90a) kernels of the connectivity rounds: the Borůvka hooking
// round and the unsorted segment-min.
//
// They replace two Pallas TPU kernels of the JAX package:
//   boruvka_round_kernel  <- src/repro/kernels/boruvka_round/kernel.py,
//                            boruvka_round_pallas (body _boruvka_round_kernel)
//   segment_min_kernel    <- src/repro/kernels/segment_min/kernel.py,
//                            segment_min_pallas (body _segment_min_kernel)
//
// Design. The TPU kernels run a dense (edge tile x segment tile) masked
// compare, E * n operations, only because the TPU's vector unit has no
// scatter atomics. Hopper has them, and an integer atomicMin is
// order-independent, so one pass over the edges with one thread per slot
// gives the exact, deterministic result of the plain scatter-min. Both
// kernels are bound by the bytes they read (one streamed pass over the
// input arrays); the small per-vertex arrays (labels, the output) stay in
// the 50 MB L2.
//
// Contended atomics: in late Borůvka rounds few components remain and every
// cross edge aims at the same few slots. min_into reads the slot first and
// issues the atomic only when the key is smaller. Min is monotone, so a
// stale read is never below the slot's current value and skipping is exact.
//
// Every entry point returns cudaGetLastError() after its launch; the
// Python wrappers raise on a non-zero code.
#include <cuda_runtime.h>

namespace {

constexpr int kInf32 = 0x7fffffff;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;

__device__ __forceinline__ void min_into(int* slot, int key) {
  if (__ldcg(slot) > key) atomicMin(slot, key);
}

// best[s] = min slot i with mask[i] & src[i] != dst[i] &
// labels[src[i]] != labels[dst[i]] and s in {labels[src[i]],
// labels[dst[i]]}. best is INF32-filled by the caller. Endpoint gathers
// clamp like JAX's; label ids outside [0, num_segments) are dropped like
// jax.ops.segment_min drops them.
__global__ void __launch_bounds__(kThreads) boruvka_round_kernel(
    const int* __restrict__ src, const int* __restrict__ dst,
    const unsigned char* __restrict__ mask, const int* __restrict__ labels,
    int* best, long long e, int n_labels, int num_segments) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < e; i += stride) {
    if (!mask[i]) continue;
    int u = src[i];
    int v = dst[i];
    if (u == v) continue;
    u = min(max(u, 0), n_labels - 1);
    v = min(max(v, 0), n_labels - 1);
    const int lu = __ldg(labels + u);
    const int lv = __ldg(labels + v);
    if (lu == lv) continue;
    const int key = static_cast<int>(i);
    if (static_cast<unsigned>(lu) < static_cast<unsigned>(num_segments))
      min_into(best + lu, key);
    if (static_cast<unsigned>(lv) < static_cast<unsigned>(num_segments))
      min_into(best + lv, key);
  }
}

// out[s] = min keys[i] over ids[i] == s; out is INF32-filled by the caller.
// Ids outside [0, num_segments) are dropped, never written.
__global__ void __launch_bounds__(kThreads) segment_min_kernel(
    const int* __restrict__ keys, const int* __restrict__ ids, int* out,
    long long e, int num_segments) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < e; i += stride) {
    const int key = keys[i];
    if (key == kInf32) continue;
    const int id = ids[i];
    if (static_cast<unsigned>(id) >= static_cast<unsigned>(num_segments))
      continue;
    min_into(out + id, key);
  }
}

unsigned grid_for(long long e) {
  long long blocks = (e + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks);
}

}  // namespace

extern "C" int repro_boruvka_round(const int* src, const int* dst,
                                   const unsigned char* mask,
                                   const int* labels, int* best, long long e,
                                   int n_labels, int num_segments,
                                   void* stream) {
  boruvka_round_kernel<<<grid_for(e), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      src, dst, mask, labels, best, e, n_labels, num_segments);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_segment_min(const int* keys, const int* ids, int* out,
                                 long long e, int num_segments,
                                 void* stream) {
  segment_min_kernel<<<grid_for(e), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      keys, ids, out, e, num_segments);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
