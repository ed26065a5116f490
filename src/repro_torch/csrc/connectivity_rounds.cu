// Hopper (sm_90a) kernels of the connectivity rounds: the Borůvka hooking
// round, the scan-first-search frontier round and the unsorted segment-min.
//
// They replace three Pallas TPU kernels of the JAX package:
//   boruvka_round_kernel  <- src/repro/kernels/boruvka_round/kernel.py,
//                            boruvka_round_pallas (body _boruvka_round_kernel)
//   frontier_round_kernel <- src/repro/kernels/boruvka_round/kernel.py,
//                            frontier_round_pallas (body _frontier_round_kernel)
//   segment_min_kernel    <- src/repro/kernels/segment_min/kernel.py,
//                            segment_min_pallas (body _segment_min_kernel)
//
// Design. The TPU kernels run a dense (edge tile x segment tile) masked
// compare, E * n operations, only because the TPU's vector unit has no
// scatter atomics. Hopper has them, and an integer atomicMin is
// order-independent, so one pass over the edges with one thread per slot
// gives the exact, deterministic result of the plain scatter-min. The
// frontier round's (parent, slot) pair is one lexicographic minimum, so it
// packs into one 64-bit key and one 64-bit atomicMin: the TPU kernel's two
// accumulators merged per chunk have no counterpart here. The kernels are
// bound by the bytes they read (one streamed pass over the input arrays);
// the small per-vertex arrays (labels, frontier, visited, the output) stay
// in the 50 MB L2.
//
// Contended atomics: in late Borůvka rounds few components remain and every
// cross edge aims at the same few slots; in the middle rounds of a BFS many
// frontier arcs aim at each newly reached vertex. min_into reads the slot
// first and issues the atomic only when the key is smaller. Min is
// monotone, so a stale read is never below the slot's current value and
// skipping is exact.
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

__device__ __forceinline__ void min_into(long long* slot, long long key) {
  if (__ldcg(slot) > key) atomicMin(slot, key);
}

// A gather index as JAX takes it: [-n, -1] wraps to n + v, then the index
// is clamped into [0, n).
__device__ __forceinline__ int gather_index(int v, int n) {
  if (v < 0) v += n;
  return min(max(v, 0), n - 1);
}

// best[s] = min slot i with mask[i] & src[i] != dst[i] &
// labels[src[i]] != labels[dst[i]] and s in {labels[src[i]],
// labels[dst[i]]}. best is INF32-filled by the caller. Endpoint gathers
// wrap and clamp like JAX's; label ids outside [0, num_segments) are
// dropped like jax.ops.segment_min drops them.
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
    const int lu = __ldg(labels + gather_index(u, n_labels));
    const int lv = __ldg(labels + gather_index(v, n_labels));
    if (lu == lv) continue;
    const int key = static_cast<int>(i);
    if (static_cast<unsigned>(lu) < static_cast<unsigned>(num_segments))
      min_into(best + lu, key);
    if (static_cast<unsigned>(lv) < static_cast<unsigned>(num_segments))
      min_into(best + lv, key);
  }
}

// One scan-first-search round. For every arc u -> w of a live slot i (both
// orientations of the slot, self-loops skipped) with frontier[u] and not
// visited[w], the candidate key (u, i) packed as u * 2^32 + i is
// atomicMin-ed into best[w]. The minimum packed key is the lexicographic
// minimum: the minimum-id frontier neighbour first, then the minimum slot
// of an arc to it -- the (best_p, best_e) pair of frontier_round_ref.
// i < 2^31 (check_key_space) and |u| < 2^31, so the signed 64-bit order
// is that lexicographic order. best is filled with INF32 * 2^32 + INF32
// by the caller; ids w outside [0, num_segments) are dropped; frontier and
// visited gathers wrap and clamp like JAX's.
__global__ void __launch_bounds__(kThreads) frontier_round_kernel(
    const int* __restrict__ src, const int* __restrict__ dst,
    const unsigned char* __restrict__ mask,
    const unsigned char* __restrict__ frontier,
    const unsigned char* __restrict__ visited, long long* best, long long e,
    int n_nodes, int num_segments) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < e; i += stride) {
    if (!mask[i]) continue;
    const int u = src[i];
    const int w = dst[i];
    if (u == w) continue;
    const int gu = gather_index(u, n_nodes);
    const int gw = gather_index(w, n_nodes);
    const bool fu = __ldg(frontier + gu);
    const bool fw = __ldg(frontier + gw);
    if (!fu && !fw) continue;
    if (fu && static_cast<unsigned>(w) < static_cast<unsigned>(num_segments) &&
        !__ldg(visited + gw))
      min_into(best + w, static_cast<long long>(u) * 4294967296LL + i);
    if (fw && static_cast<unsigned>(u) < static_cast<unsigned>(num_segments) &&
        !__ldg(visited + gu))
      min_into(best + u, static_cast<long long>(w) * 4294967296LL + i);
  }
}

// Split each packed key into best_p (high word) and best_e (low word).
// The INF32 * 2^32 + INF32 fill comes out as INF32, INF32.
__global__ void __launch_bounds__(kThreads) unpack_pairs_kernel(
    const long long* __restrict__ packed, int* best_p, int* best_e, int n) {
  const int stride = gridDim.x * blockDim.x;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < n; s += stride) {
    const long long key = packed[s];
    best_p[s] = static_cast<int>(key >> 32);
    best_e[s] = static_cast<int>(key & 0xffffffffLL);
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

extern "C" int repro_frontier_round(const int* src, const int* dst,
                                    const unsigned char* mask,
                                    const unsigned char* frontier,
                                    const unsigned char* visited,
                                    long long* packed, int* best_p,
                                    int* best_e, long long e, int n_nodes,
                                    int num_segments, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  frontier_round_kernel<<<grid_for(e), kThreads, 0, s>>>(
      src, dst, mask, frontier, visited, packed, e, n_nodes, num_segments);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  unpack_pairs_kernel<<<grid_for(num_segments), kThreads, 0, s>>>(
      packed, best_p, best_e, num_segments);
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
