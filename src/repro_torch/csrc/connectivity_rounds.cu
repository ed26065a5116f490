// Hopper (sm_90a) kernels of the connectivity rounds: the Borůvka hooking
// round, the scan-first-search frontier round and the unsorted segment-min.
//
// They replace three Pallas TPU kernels of the JAX package:
//   boruvka_round_warp_kernel  <- src/repro/kernels/boruvka_round/kernel.py,
//                                 boruvka_round_pallas (body
//                                 _boruvka_round_kernel)
//   frontier_round_warp_kernel <- src/repro/kernels/boruvka_round/kernel.py,
//                                 frontier_round_pallas (body
//                                 _frontier_round_kernel)
//   segment_min_vec_kernel     <- src/repro/kernels/segment_min/kernel.py,
//                                 segment_min_pallas (body
//                                 _segment_min_kernel)
// The first kernel of each (boruvka_round_kernel, frontier_round_kernel,
// segment_min_kernel) stays as a yardstick that no op reaches.
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
// The Borůvka round, redesigned (boruvka_round_warp_kernel). The bridge
// pipeline's buffer is sorted by each slot's smaller endpoint, so the lanes
// of a warp mostly share one endpoint, and from the second round on every
// cross slot aims at one of a few components. Both make many lanes update
// one entry of best. So:
//   (a) a slot's two labels are ordered by its endpoints' ids, so the
//       shared smaller endpoint's label lies on one side in every lane;
//       per side, a lane whose label differs from the previous lane's
//       (one __shfl_up_sync) leads a run of equal labels. Slots ascend
//       with the lane, so the leader holds the run's least key, and it
//       alone updates. Lanes with nothing to update carry kNoLabel and
//       still take part (full mask). (__match_any_sync, which groups
//       every lane of a label, cost 0.055 ms of a 0.2 ms round on the
//       H100: tools/profile_boruvka_round.py);
//   (b) each thread takes four consecutive slots: 16-byte loads of src and
//       dst, a 4-byte load of mask, and scalar slots before the first
//       16-byte boundary and after the last whole group;
//   (c) a persistent grid (the blocks the SMs hold at once) walks the
//       buffer in slot order;
//   (d) each block keeps a shared-memory table of (label, minimum) that
//       takes the run leaders' updates and is flushed into best with
//       min_into at the block's end; a label whose bucket of four
//       entries is full goes straight to best.
// Integer min does not depend on order, so the result is the plain
// scatter-min's, bit for bit. What bounds it (the stage-by-stage profile,
// tools/profile_boruvka_round.py, on an H100 at the bridge pipeline's
// 2^24 slots): the first round, every label distinct, by the rate of the
// run leaders' scattered reads of best in L2 (10.7 M reads, 0.12 ms of
// 0.21; issuing them ahead does not help); later rounds, a few hundred
// labels, by the loads of the slots (0.046 ms of 0.088), since the table
// keeps the hot entries of best off L2. repro_boruvka_round_v1 launches the first
// kernel (boruvka_round_kernel, one thread per slot): the yardstick.
//
// The frontier round, redesigned (frontier_round_warp_kernel) on the
// Borůvka round's layout: (b) four slots per thread with 16-byte loads of
// src and dst, no endpoint loads for four masked slots (the bridge
// pipeline's buffer is 40% padding), scalar slots before the first 16-byte
// boundary and after the last whole group; (c) a persistent grid in slot
// order. Every thread updates best for its own candidate arcs: no run
// leaders, no table and no bitset of frontier in shared memory. On an H100
// at the bridge pipeline's 2^24 slots the stage-by-stage profile
// (tools/profile_frontier_round.py) gives the loads of the slots 0.046 ms
// of a 0.049-0.052 ms round; the frontier gathers add 0.001, the visited
// gathers, the reads of best and the 64-bit atomics (up to 107 k candidate
// arcs) at most 0.004 together. The round is bound by its loads. The
// kernel writes the packed keys only: the wrapper reads best_p and best_e
// as the high and low int32 words of each key (little-endian views), so
// the first kernel's split (unpack_pairs_kernel), one more launch a round,
// is gone from the op. repro_frontier_round_v1 launches the first kernel
// and its split: the yardstick.
//
// The segment min, redesigned (segment_min_vec_kernel<true>). Its bytes
// (8 B a key) take about 1.3 us at the device final's 524 k keys, less
// than one launch. The first op was a PyTorch fill of out, a gap, then the
// body; on an H100 the body, each live key's read of out[id] in L2 and
// its atomicMin where smaller, takes 0.011 of the 0.013 ms, and the fill
// and gap 0.002 when the host has queued both launches, 0.012 when it
// dispatches the second while the card waits (the pipeline's case). So
// one cooperative launch fills out with INF32, waits at one grid-wide
// barrier (it costs less than the fill launch and gap it replaces), then
// reads four keys and four ids per thread with 16-byte loads (scalar slots
// at the ends as above) and min_into-s each live key. The scattered
// updates of out hold it: issuing a thread's four reads before its
// atomics did not help, and atomics without the read help on random keys
// but lose on the pipeline's own (tools/profile_segment_min.py).
// segment_min_vec_kernel<false> is the same body after a fill by the
// caller (the two-launch alternative, measured beside it);
// repro_segment_min_v1 launches the first kernel.
//
// Every entry point returns cudaGetLastError() (the cooperative launch's
// own code) after its launch; the Python wrappers raise on a non-zero
// code.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

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

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kVec = 4;          // slots per thread in the 16-byte part
constexpr int kNoLabel = -1;     // a lane with nothing to update
constexpr int kBucketBits = 8;   // buckets of the per-block table: 2^8
constexpr int kBucketSlots = 4;  // (label, min) entries of one bucket

// A block's (label, min) table: a label lives in one entry of its bucket.
// Entries are only ever claimed, never freed, so a stale read of a label
// entry is safe: a claimed entry never changes, and a free one is claimed
// by atomicCAS, which tells the truth.
struct LabelTable {
  int label[kBucketSlots << kBucketBits];  // kNoLabel where free
  int key[kBucketSlots << kBucketBits];
};

// key into the table's entry of label, or into best[label] when its bucket
// has no entry for it.
template <bool kTable>
__device__ __forceinline__ void update(LabelTable& table, int* best,
                                       int label, int key) {
  if (kTable) {
    const int first =
        kBucketSlots *
        static_cast<int>((static_cast<unsigned>(label) * 0x9E3779B1u) >>
                         (32 - kBucketBits));
    const int4 seen = *reinterpret_cast<const int4*>(table.label + first);
    const int held[kBucketSlots] = {seen.x, seen.y, seen.z, seen.w};
#pragma unroll
    for (int p = 0; p < kBucketSlots; ++p) {
      int h = held[p];
      if (h == kNoLabel) {
        h = atomicCAS(table.label + first + p, kNoLabel, label);
        if (h == kNoLabel) h = label;
      }
      if (h == label) {
        if (table.key[first + p] > key) atomicMin(table.key + first + p, key);
        return;
      }
    }
  }
  min_into(best + label, key);
}

// The warp's lanes each hold one slot's key, ascending with the lane, and
// one label (kNoLabel: nothing to update). A lane whose label differs from
// the previous lane's starts a run of equal labels and holds the run's
// least key: it alone updates. A label that comes back later in the warp
// starts another run and updates again, which min absorbs.
template <bool kTable>
__device__ __forceinline__ void warp_update(LabelTable& table, int* best,
                                            int label, int key, int lane) {
  const int prev = __shfl_up_sync(kFullMask, label, 1);
  if (label != kNoLabel && (lane == 0 || prev != label))
    update<kTable>(table, best, label, key);
}

// The labels one slot updates: kNoLabel on both sides unless the slot is
// live, not a self-loop and crosses two components; then the label of its
// smaller gathered endpoint (lo) and of its larger one (hi), each where it
// lies in [0, num_segments). On a buffer sorted by smaller endpoint, lo
// repeats across neighbouring lanes.
__device__ __forceinline__ void cross_labels(bool live, int u, int v,
                                             const int* __restrict__ labels,
                                             int n_labels, int num_segments,
                                             int& lo, int& hi) {
  lo = kNoLabel;
  hi = kNoLabel;
  if (!live || u == v) return;
  const int gu = gather_index(u, n_labels);
  const int gv = gather_index(v, n_labels);
  const int a = __ldg(labels + min(gu, gv));
  const int b = __ldg(labels + max(gu, gv));
  if (a == b) return;
  if (static_cast<unsigned>(a) < static_cast<unsigned>(num_segments)) lo = a;
  if (static_cast<unsigned>(b) < static_cast<unsigned>(num_segments)) hi = b;
}

// best as boruvka_round_kernel computes it. Slots [0, head) and
// [head + 4 * n_vec, e) one per lane; [head, head + 4 * n_vec) four per
// lane, src + head and dst + head 16-byte aligned and mask + head 4-byte
// aligned. Each warp walks its part in slot order, 32 lanes at a time.
template <bool kTable>
__global__ void __launch_bounds__(kThreads) boruvka_round_warp_kernel(
    const int* __restrict__ src, const int* __restrict__ dst,
    const unsigned char* __restrict__ mask, const int* __restrict__ labels,
    int* best, long long e, long long head, long long n_vec, int n_labels,
    int num_segments) {
  __shared__ LabelTable table;
  if (kTable) {
    for (int s = threadIdx.x; s < (kBucketSlots << kBucketBits);
         s += kThreads) {
      table.label[s] = kNoLabel;
      table.key[s] = kInf32;
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const long long warp =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  const long long tail = head + kVec * n_vec;

  // the scalar slots: [0, head) then [tail, e)
  for (int part = 0; part < 2; ++part) {
    const long long from = part == 0 ? 0 : tail;
    const long long to = part == 0 ? head : e;
    for (long long base = from + warp * 32; base < to; base += warps * 32) {
      const long long i = base + lane;
      const bool in = i < to;
      int lo, hi;
      cross_labels(in && mask[i], in ? src[i] : 0, in ? dst[i] : 0, labels,
                   n_labels, num_segments, lo, hi);
      const int key = static_cast<int>(i);
      warp_update<kTable>(table, best, lo, key, lane);
      warp_update<kTable>(table, best, hi, key, lane);
    }
  }

  // the 16-byte part: lane l of a warp's step takes slots 4l .. 4l + 3 of
  // 128, so in sub-step k the slots ascend with the lane
  const int4* src4 = reinterpret_cast<const int4*>(src + head);
  const int4* dst4 = reinterpret_cast<const int4*>(dst + head);
  const unsigned* mask4 = reinterpret_cast<const unsigned*>(mask + head);
  for (long long g0 = warp * 32; g0 < n_vec; g0 += warps * 32) {
    const long long g = g0 + lane;
    int4 s4 = make_int4(0, 0, 0, 0);
    int4 d4 = s4;
    unsigned m4 = 0;
    if (g < n_vec) m4 = __ldcs(mask4 + g);
    if (m4) {  // the endpoints of four masked slots are never read
      s4 = __ldcs(src4 + g);
      d4 = __ldcs(dst4 + g);
    }
    const int su[kVec] = {s4.x, s4.y, s4.z, s4.w};
    const int sv[kVec] = {d4.x, d4.y, d4.z, d4.w};
    int lo[kVec], hi[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      cross_labels(((m4 >> (8 * k)) & 0xffu) != 0, su[k], sv[k], labels,
                   n_labels, num_segments, lo[k], hi[k]);
    const int key0 = static_cast<int>(head + kVec * g);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      warp_update<kTable>(table, best, lo[k], key0 + k, lane);
      warp_update<kTable>(table, best, hi[k], key0 + k, lane);
    }
  }

  if (kTable) {
    __syncthreads();
    for (int s = threadIdx.x; s < (kBucketSlots << kBucketBits);
         s += kThreads) {
      const int label = table.label[s];
      if (label != kNoLabel) min_into(best + label, table.key[s]);
    }
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

// The packed key of an arc from parent p over slot i: p * 2^32 + i.
__device__ __forceinline__ long long arc_key(int p, long long i) {
  return static_cast<long long>(p) * 4294967296LL + i;
}

// Slot i's updates of best, as frontier_round_kernel makes them: for the
// arc u -> w where frontier[u], w in [0, num_segments) and not visited[w],
// and likewise for w -> u.
__device__ __forceinline__ void frontier_slot(
    bool live, int u, int w, long long i,
    const unsigned char* __restrict__ frontier,
    const unsigned char* __restrict__ visited, long long* best, int n_nodes,
    int num_segments) {
  if (!live || u == w) return;
  const int gu = gather_index(u, n_nodes);
  const int gw = gather_index(w, n_nodes);
  const bool fu = __ldg(frontier + gu);
  const bool fw = __ldg(frontier + gw);
  if (fu && static_cast<unsigned>(w) < static_cast<unsigned>(num_segments) &&
      !__ldg(visited + gw))
    min_into(best + w, arc_key(u, i));
  if (fw && static_cast<unsigned>(u) < static_cast<unsigned>(num_segments) &&
      !__ldg(visited + gu))
    min_into(best + u, arc_key(w, i));
}

// best as frontier_round_kernel computes it (the caller fills it with
// INF32 * 2^32 + INF32). Slots [0, head) and [head + 4 * n_vec, e) one per
// thread; [head, head + 4 * n_vec) four per thread, src + head and
// dst + head 16-byte aligned and mask + head 4-byte aligned. Thread t of
// the grid takes group t, then t + the grid's threads, ...
__global__ void __launch_bounds__(kThreads) frontier_round_warp_kernel(
    const int* __restrict__ src, const int* __restrict__ dst,
    const unsigned char* __restrict__ mask,
    const unsigned char* __restrict__ frontier,
    const unsigned char* __restrict__ visited, long long* best, long long e,
    long long head, long long n_vec, int n_nodes, int num_segments) {
  const long long thread =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  const long long tail = head + kVec * n_vec;
  for (long long i = thread; i < head; i += threads)
    frontier_slot(mask[i], src[i], dst[i], i, frontier, visited, best,
                  n_nodes, num_segments);
  for (long long i = tail + thread; i < e; i += threads)
    frontier_slot(mask[i], src[i], dst[i], i, frontier, visited, best,
                  n_nodes, num_segments);

  const int4* src4 = reinterpret_cast<const int4*>(src + head);
  const int4* dst4 = reinterpret_cast<const int4*>(dst + head);
  const unsigned* mask4 = reinterpret_cast<const unsigned*>(mask + head);
  for (long long g = thread; g < n_vec; g += threads) {
    const unsigned m4 = __ldcs(mask4 + g);
    if (!m4) continue;  // the endpoints of four masked slots are never read
    const int4 s4 = __ldcs(src4 + g);
    const int4 d4 = __ldcs(dst4 + g);
    const int su[kVec] = {s4.x, s4.y, s4.z, s4.w};
    const int sw[kVec] = {d4.x, d4.y, d4.z, d4.w};
    const long long i0 = head + kVec * g;
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      frontier_slot(((m4 >> (8 * k)) & 0xffu) != 0, su[k], sw[k], i0 + k,
                    frontier, visited, best, n_nodes, num_segments);
  }
}

__device__ __forceinline__ void segment_min_key(int key, int id, int* out,
                                                int num_segments) {
  if (key != kInf32 &&
      static_cast<unsigned>(id) < static_cast<unsigned>(num_segments))
    min_into(out + id, key);
}

// out as segment_min_kernel computes it. With kFill the kernel first fills
// out with INF32 and waits for the whole grid (a cooperative launch);
// without, the caller filled it. Keys [0, head) and [head + 4 * n_vec, e)
// one per thread; [head, head + 4 * n_vec) four per thread, keys + head and
// ids + head 16-byte aligned.
template <bool kFill>
__global__ void __launch_bounds__(kThreads) segment_min_vec_kernel(
    const int* __restrict__ keys, const int* __restrict__ ids, int* out,
    long long e, long long head, long long n_vec, int num_segments) {
  const long long thread =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  if (kFill) {
    for (long long s = thread; s < num_segments; s += threads) out[s] = kInf32;
    cooperative_groups::this_grid().sync();
  }
  const long long tail = head + kVec * n_vec;
  for (long long i = thread; i < head; i += threads)
    segment_min_key(keys[i], ids[i], out, num_segments);
  for (long long i = tail + thread; i < e; i += threads)
    segment_min_key(keys[i], ids[i], out, num_segments);
  const int4* keys4 = reinterpret_cast<const int4*>(keys + head);
  const int4* ids4 = reinterpret_cast<const int4*>(ids + head);
  for (long long g = thread; g < n_vec; g += threads) {
    const int4 k4 = __ldcs(keys4 + g);
    const int4 i4 = __ldcs(ids4 + g);
    segment_min_key(k4.x, i4.x, out, num_segments);
    segment_min_key(k4.y, i4.y, out, num_segments);
    segment_min_key(k4.z, i4.z, out, num_segments);
    segment_min_key(k4.w, i4.w, out, num_segments);
  }
}

unsigned grid_for(long long e) {
  long long blocks = (e + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks);
}

// The persistent kernels, each with its own cached grid size.
enum PersistentKernel {
  kBoruvkaTable,
  kBoruvkaNoTable,
  kFrontier,
  kSegmentMinFill,
  kSegmentMinFilled
};

// The blocks of one persistent grid of kernel: as many as the device's SMs
// hold at once, cached per (kernel, device).
template <int kWhich>
long long resident_blocks(const void* kernel) {
  static int cached[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int sms = 0;
  int per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  if (dev < 64) cached[dev] = blocks;
  return blocks;
}

// The first slot from which a and b are 16-byte aligned and c is
// (c_bytes * 4)-byte aligned, c holding c_bytes bytes a slot; e (every
// slot scalar) where the three never align at one slot within the first
// group.
long long vec_head(const void* a, const void* b, const void* c, int c_bytes,
                   long long e) {
  const unsigned long long pa = reinterpret_cast<unsigned long long>(a);
  const unsigned long long pb = reinterpret_cast<unsigned long long>(b);
  const unsigned long long pc = reinterpret_cast<unsigned long long>(c);
  long long head = static_cast<long long>((16 - (pa & 15)) & 15) / 4;
  if (pa % 4 || (pb + 4 * head) % 16 ||
      (pc + c_bytes * head) % (c_bytes * kVec) || head > e)
    head = e;
  return head;
}

}  // namespace

// table: 1 with the per-block (label, min) table, 0 without (a yardstick).
extern "C" int repro_boruvka_round(const int* src, const int* dst,
                                   const unsigned char* mask,
                                   const int* labels, int* best, long long e,
                                   int n_labels, int num_segments, int table,
                                   void* stream) {
  // the 16-byte part starts where src is 16-byte aligned; it needs dst
  // 16-byte and mask 4-byte aligned at the same slot, else every slot is
  // scalar
  const long long head = vec_head(src, dst, mask, 1, e);
  const long long n_vec = (e - head) / kVec;
  const long long steps = (n_vec + 31) / 32 + 2;  // warp steps, + 2 scalar
  const long long wanted = (steps + kThreads / 32 - 1) / (kThreads / 32);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (table) {
    const long long blocks = std::min(
        resident_blocks<kBoruvkaTable>(
            reinterpret_cast<const void*>(boruvka_round_warp_kernel<true>)),
        wanted);
    boruvka_round_warp_kernel<true><<<static_cast<unsigned>(blocks), kThreads,
                                      0, st>>>(src, dst, mask, labels, best, e,
                                               head, n_vec, n_labels,
                                               num_segments);
  } else {
    const long long blocks = std::min(
        resident_blocks<kBoruvkaNoTable>(
            reinterpret_cast<const void*>(boruvka_round_warp_kernel<false>)),
        wanted);
    boruvka_round_warp_kernel<false><<<static_cast<unsigned>(blocks),
                                       kThreads, 0, st>>>(
        src, dst, mask, labels, best, e, head, n_vec, n_labels, num_segments);
  }
  return static_cast<int>(cudaGetLastError());
}

// The first kernel, one thread per slot: a yardstick no op reaches.
extern "C" int repro_boruvka_round_v1(const int* src, const int* dst,
                                      const unsigned char* mask,
                                      const int* labels, int* best,
                                      long long e, int n_labels,
                                      int num_segments, void* stream) {
  boruvka_round_kernel<<<grid_for(e), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      src, dst, mask, labels, best, e, n_labels, num_segments);
  return static_cast<int>(cudaGetLastError());
}

// packed: int64[num_segments], filled with INF32 * 2^32 + INF32 by the
// caller; the result is each key, best_p its high word, best_e its low.
extern "C" int repro_frontier_round(const int* src, const int* dst,
                                    const unsigned char* mask,
                                    const unsigned char* frontier,
                                    const unsigned char* visited,
                                    long long* packed, long long e,
                                    int n_nodes, int num_segments,
                                    void* stream) {
  const long long head = vec_head(src, dst, mask, 1, e);
  const long long n_vec = (e - head) / kVec;
  const long long wanted = (std::max(n_vec, 4LL) + kThreads - 1) / kThreads;
  const long long blocks = std::min(
      resident_blocks<kFrontier>(
          reinterpret_cast<const void*>(frontier_round_warp_kernel)),
      wanted);
  frontier_round_warp_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      src, dst, mask, frontier, visited, packed, e, head, n_vec, n_nodes,
      num_segments);
  return static_cast<int>(cudaGetLastError());
}

// The first kernel and its split into best_p and best_e, one thread per
// slot and per segment: a yardstick no op reaches.
extern "C" int repro_frontier_round_v1(const int* src, const int* dst,
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

// fill: 1 fills out with INF32 in the same (cooperative) launch; 0 takes
// out as the caller filled it (the two-launch alternative).
extern "C" int repro_segment_min(const int* keys, const int* ids, int* out,
                                 long long e, int num_segments, int fill,
                                 void* stream) {
  long long head = vec_head(keys, ids, ids, 4, e);
  long long n_vec = (e - head) / kVec;
  long long work = std::max(n_vec, 4LL);
  if (fill) work = std::max(work, static_cast<long long>(num_segments));
  const long long wanted = (work + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!fill) {
    const long long blocks = std::min(
        resident_blocks<kSegmentMinFilled>(
            reinterpret_cast<const void*>(segment_min_vec_kernel<false>)),
        wanted);
    segment_min_vec_kernel<false><<<static_cast<unsigned>(blocks), kThreads,
                                    0, st>>>(keys, ids, out, e, head, n_vec,
                                             num_segments);
    return static_cast<int>(cudaGetLastError());
  }
  // a cooperative grid holds at most the blocks the SMs hold at once
  const void* kernel = reinterpret_cast<const void*>(
      segment_min_vec_kernel<true>);
  const unsigned blocks = static_cast<unsigned>(
      std::min(resident_blocks<kSegmentMinFill>(kernel), wanted));
  void* args[] = {&keys, &ids, &out, &e, &head, &n_vec, &num_segments};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(blocks), dim3(kThreads), args, 0, st);
  const cudaError_t last = cudaGetLastError();  // clears a launch error
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// The first kernel, one thread per key, on out as the caller filled it: a
// yardstick no op reaches.
extern "C" int repro_segment_min_v1(const int* keys, const int* ids,
                                    int* out, long long e, int num_segments,
                                    void* stream) {
  segment_min_kernel<<<grid_for(e), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      keys, ids, out, e, num_segments);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
