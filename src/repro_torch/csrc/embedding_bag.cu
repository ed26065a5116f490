// Hopper (sm_90a) embedding bag: gather rows of a table and pool each bag
// under its mask (sum, mean or max).
//
// Replaces src/repro/kernels/embedding_bag/kernel.py, embedding_bag_pallas
// (body _bag_kernel). Its contract is the JAX package's oracle,
// src/repro/kernels/embedding_bag/ref.py::embedding_bag_ref:
//   * an id in [-V, -1] reads row V + id; an id outside [-V, V) reads a
//     NaN row (jnp.take's "fill" mode);
//   * sum and mean multiply every gathered row by its mask bit, so a masked
//     NaN or inf still reaches the bag; mean divides by max(count, 1);
//   * max skips masked rows, starts from the dtype's lowest finite value,
//     propagates NaN as jnp.max does, and gives 0 for an empty bag;
//   * the result has the table's dtype; sums are taken in float32.
//
// Design. The TPU kernel stages a tile of indices in SMEM and issues one
// dynamic-slice DMA per row. On Hopper a work item is one (bag, block of 64
// columns); each lane owns columns c0 + lane and c0 + lane + 32, so
// neighbouring lanes read neighbouring elements of a row. Two kernels
// share that layout, and the entry point picks one by the number of work
// items against a threshold its caller passes:
//   * many work items, embedding_bag_kernel (the first kernel): one warp per
//     item. The warp loads 32 (index, mask) pairs at a time, one per lane,
//     and broadcasts them with __shfl_sync, so each bag's indices are read
//     once per column block; eight rows in flight. Bound by bytes: the
//     32-byte sectors of the distinct rows it reads, the B*L indices and
//     mask bytes, and B*D outputs.
//   * few work items, embedding_bag_block_kernel: one block of 8 warps per
//     item. Warp w takes entries w, w + 8, ..., loads their ids and mask
//     bits itself (no shuffle chain) and issues all its row loads before any
//     sum, so a bag of up to 64 entries is one round trip deep. The warps'
//     partial sums, maxima and counts meet in shared memory and are combined
//     in warp order, so a result does not depend on scheduling. At one bag
//     the bytes are a few kB: the case is bound by latency.
// repro_embedding_bag_v1 launches the first kernel at every size: the
// yardstick the smoke and the card tests hold the new branch against.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 64;  // columns of one warp's block: two per lane
constexpr long long kMaxBlocks = 1LL << 20;

enum Mode { kSum = 0, kMean = 1, kMax = 2 };

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// max as jnp.max takes it: NaN wins, whichever side it is on
__device__ __forceinline__ float nan_max(float acc, float v) {
  if (acc != acc) return acc;
  return (v != v || v > acc) ? v : acc;
}

// out[b, c] for every bag b and column c. One warp per (bag, block of 64
// columns), grid-stride over those work items. mask may be null (every
// entry valid). lowest is the table dtype's lowest finite value.
template <typename T>
__global__ void __launch_bounds__(kThreads) embedding_bag_kernel(
    const T* __restrict__ table, const int* __restrict__ idx,
    const unsigned char* __restrict__ mask, T* __restrict__ out, int n_bags,
    int bag_len, int n_rows, int dim, int mode, float lowest) {
  const int lane = threadIdx.x & 31;
  const int col_blocks = (dim + kCols - 1) / kCols;
  const long long items = static_cast<long long>(n_bags) * col_blocks;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const float nan = __int_as_float(0x7fffffff);
  for (long long w = static_cast<long long>(blockIdx.x) * kWarps +
                     (threadIdx.x >> 5);
       w < items; w += warps) {
    const int b = static_cast<int>(w / col_blocks);
    const int c0 = static_cast<int>(w % col_blocks) * kCols + lane;
    const int c1 = c0 + 32;
    const bool has0 = c0 < dim;
    const bool has1 = c1 < dim;
    float acc0 = mode == kMax ? lowest : 0.0f;
    float acc1 = acc0;
    int count = 0;
    const long long bag = static_cast<long long>(b) * bag_len;
    for (int l0 = 0; l0 < bag_len; l0 += 32) {
      int my_id = 0;
      int my_valid = 0;
      if (l0 + lane < bag_len) {
        my_id = __ldg(idx + bag + l0 + lane);
        my_valid = mask == nullptr ? 1 : __ldg(mask + bag + l0 + lane) != 0;
      }
      const int n = min(32, bag_len - l0);
#pragma unroll 8  // eight rows' loads in flight before their sums
      for (int j = 0; j < n; ++j) {
        int id = __shfl_sync(0xffffffffu, my_id, j);
        const int valid = __shfl_sync(0xffffffffu, my_valid, j);
        count += valid;
        if (mode == kMax && !valid) continue;
        if (id < 0) id += n_rows;
        const bool inside = id >= 0 && id < n_rows;
        const T* row = table + static_cast<long long>(id) * dim;
        const float v0 = !has0 ? 0.0f : inside ? load_f32(row + c0) : nan;
        const float v1 = !has1 ? 0.0f : inside ? load_f32(row + c1) : nan;
        if (mode == kMax) {
          acc0 = nan_max(acc0, v0);
          acc1 = nan_max(acc1, v1);
        } else {
          const float m = static_cast<float>(valid);
          acc0 += v0 * m;
          acc1 += v1 * m;
        }
      }
    }
    if (mode == kMean) {
      const float cnt = static_cast<float>(max(count, 1));
      acc0 /= cnt;
      acc1 /= cnt;
    } else if (mode == kMax && count == 0) {
      acc0 = 0.0f;
      acc1 = 0.0f;
    }
    T* dst = out + static_cast<long long>(b) * dim;
    if (has0) store(dst + c0, acc0);
    if (has1) store(dst + c1, acc1);
  }
}

// The same out[b, c] with one block of kWarps warps per (bag, block of 64
// columns). Warp w pools entries w, w + kWarps, ...: kBatch of them per
// pass, their ids, mask bits and rows all loaded before any sum. The
// partials are then combined in warp order 0, 1, ..., kWarps - 1.
template <typename T>
__global__ void __launch_bounds__(kThreads) embedding_bag_block_kernel(
    const T* __restrict__ table, const int* __restrict__ idx,
    const unsigned char* __restrict__ mask, T* __restrict__ out, int n_bags,
    int bag_len, int n_rows, int dim, int mode, float lowest) {
  constexpr int kBatch = 8;  // entries per warp per pass
  __shared__ float part[kWarps][kCols];
  __shared__ int part_count[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col_blocks = (dim + kCols - 1) / kCols;
  const long long items = static_cast<long long>(n_bags) * col_blocks;
  const float nan = __int_as_float(0x7fffffff);
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = static_cast<int>(item / col_blocks);
    const int c0 = static_cast<int>(item % col_blocks) * kCols + lane;
    const int c1 = c0 + 32;
    const bool has0 = c0 < dim;
    const bool has1 = c1 < dim;
    float acc0 = mode == kMax ? lowest : 0.0f;
    float acc1 = acc0;
    int count = 0;
    const long long bag = static_cast<long long>(b) * bag_len;
    for (int l0 = warp; l0 < bag_len; l0 += kWarps * kBatch) {
      int id[kBatch];
      int valid[kBatch];
      bool read[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int l = l0 + j * kWarps;
        const bool present = l < bag_len;
        id[j] = present ? __ldg(idx + bag + l) : 0;
        valid[j] = !present ? 0
                   : mask == nullptr ? 1
                                     : __ldg(mask + bag + l) != 0;
        // sum and mean read every entry's row (a masked NaN still counts);
        // max reads the valid entries' rows only
        read[j] = present && (mode != kMax || valid[j]);
      }
      float v0[kBatch];
      float v1[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        int r = id[j];
        if (r < 0) r += n_rows;
        const bool inside = r >= 0 && r < n_rows;
        const T* row = table + static_cast<long long>(r) * dim;
        v0[j] = !(read[j] && has0) ? 0.0f : inside ? load_f32(row + c0) : nan;
        v1[j] = !(read[j] && has1) ? 0.0f : inside ? load_f32(row + c1) : nan;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        count += valid[j];
        if (mode == kMax) {
          if (valid[j]) {
            acc0 = nan_max(acc0, v0[j]);
            acc1 = nan_max(acc1, v1[j]);
          }
        } else {
          const float m = static_cast<float>(valid[j]);
          acc0 += v0[j] * m;
          acc1 += v1[j] * m;
        }
      }
    }
    part[warp][lane] = acc0;
    part[warp][lane + 32] = acc1;
    if (lane == 0) part_count[warp] = count;
    __syncthreads();
    if (warp == 0) {
      acc0 = part[0][lane];
      acc1 = part[0][lane + 32];
      count = part_count[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        if (mode == kMax) {
          acc0 = nan_max(acc0, part[w][lane]);
          acc1 = nan_max(acc1, part[w][lane + 32]);
        } else {
          acc0 += part[w][lane];
          acc1 += part[w][lane + 32];
        }
        count += part_count[w];
      }
      if (mode == kMean) {
        const float cnt = static_cast<float>(max(count, 1));
        acc0 /= cnt;
        acc1 /= cnt;
      } else if (mode == kMax && count == 0) {
        acc0 = 0.0f;
        acc1 = 0.0f;
      }
      T* dst = out + static_cast<long long>(b) * dim;
      if (has0) store(dst + c0, acc0);
      if (has1) store(dst + c1, acc1);
    }
    __syncthreads();  // part is written again by the next item
  }
}

__global__ void noop_kernel() {}

unsigned grid_of(long long blocks) {
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks);
}

// block_items_max: the most work items (bags x column blocks) that go to
// the block kernel; more go to the warp kernel. Negative: always the warp
// kernel (the v1 entry).
template <typename T>
int launch(const void* table, const int* idx, const unsigned char* mask,
           void* out, int n_bags, int bag_len, int n_rows, int dim, int mode,
           float lowest, long long block_items_max, cudaStream_t stream) {
  const long long items =
      static_cast<long long>(n_bags) * ((dim + kCols - 1) / kCols);
  const T* tab = static_cast<const T*>(table);
  T* o = static_cast<T*>(out);
  if (items <= block_items_max)
    embedding_bag_block_kernel<T><<<grid_of(items), kThreads, 0, stream>>>(
        tab, idx, mask, o, n_bags, bag_len, n_rows, dim, mode, lowest);
  else
    embedding_bag_kernel<T>
        <<<grid_of((items + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
            tab, idx, mask, o, n_bags, bag_len, n_rows, dim, mode, lowest);
  return static_cast<int>(cudaGetLastError());
}

int launch_dtype(const void* table, const int* idx, const unsigned char* mask,
                 void* out, int n_bags, int bag_len, int n_rows, int dim,
                 int mode, int dtype, long long block_items_max,
                 cudaStream_t s) {
  if (mode < kSum || mode > kMax) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(table, idx, mask, out, n_bags, bag_len, n_rows, dim,
                         mode, -FLT_MAX, block_items_max, s);
  if (dtype == 1)  // bfloat16's lowest finite value, -(2 - 2^-7) * 2^127
    return launch<__nv_bfloat16>(table, idx, mask, out, n_bags, bag_len,
                                 n_rows, dim, mode, -3.38953139e38f,
                                 block_items_max, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (table and out). mode: 0 sum, 1 mean,
// 2 max. mask may be null. Up to block_items_max work items (bags x blocks
// of 64 columns) go to the block kernel, more to the warp kernel. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a dtype
// or mode it does not take.
extern "C" int repro_embedding_bag(const void* table, const int* idx,
                                   const unsigned char* mask, void* out,
                                   int n_bags, int bag_len, int n_rows,
                                   int dim, int mode, int dtype,
                                   long long block_items_max, void* stream) {
  return launch_dtype(table, idx, mask, out, n_bags, bag_len, n_rows, dim,
                      mode, dtype, block_items_max,
                      static_cast<cudaStream_t>(stream));
}

// The first kernel (one warp per work item) at every size: a yardstick.
extern "C" int repro_embedding_bag_v1(const void* table, const int* idx,
                                      const unsigned char* mask, void* out,
                                      int n_bags, int bag_len, int n_rows,
                                      int dim, int mode, int dtype,
                                      void* stream) {
  return launch_dtype(table, idx, mask, out, n_bags, bag_len, n_rows, dim,
                      mode, dtype, -1, static_cast<cudaStream_t>(stream));
}

// An empty kernel: its launch interval is the floor under any one-launch
// op's time.
extern "C" int repro_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
