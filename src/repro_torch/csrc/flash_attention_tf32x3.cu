// Hopper (sm_90a) flash attention for float32 on the tensor cores: blocked
// online-softmax attention, causal or not, with grouped-query heads, its
// two products issued as warp-level mma.sync in TF32 with every operand
// split in two (3xTF32), so that the products keep float32's accuracy.
//
// Replaces src/repro/kernels/flash_attention/kernel.py,
// flash_attention_pallas (body _flash_kernel), for float32 q, k and v; bf16
// goes to flash_attention_mma.cu. Its contract is the JAX package's oracle,
// src/repro/kernels/flash_attention/ref.py::attention_ref:
//   * q [B, Sq, Hq, D], k and v [B, Skv, Hkv, D], contiguous, in the JAX
//     layout, D in {16, 32, 64, 128}; query head h reads kv head
//     h / (Hq / Hkv);
//   * causal masking aligns the last query row with the last key: row r
//     sees keys <= r + (Skv - Sq);
//   * masked scores are -inf, so a row that sees no key comes out NaN;
//   * float32 in, float32 out.
//
// Bound: a long prefill is bound by operations, 4 * B * Hq * (visible
// query-key pairs) * D. Exact float32 work has two routes on this card:
// the float32 cores (67 TFLOP/s) or three TF32 products per product on the
// tensor cores (3 x ops at 494.7 TFLOP/s), the faster of the two. Decoding
// is bound by the bytes of K and V. What the design does:
//   * The numbers: one TF32 product rounds each operand to 11 significant
//     bits, which takes the worst element 30-50x past the port's float32 gate
//     (2 ulps + 1e-5 of the largest value). Each operand x is split in
//     registers into hi = tf32(x) and lo = tf32(x - hi), both rounded to
//     nearest with ties away (cvt.rna's rounding), and hi*hi + hi*lo +
//     lo*hi is summed in float32: lo*lo and lo's rounding are ~2^-22 of the
//     product. Both products are split: Q and K for the scores, P and V for
//     the output. The running sum l adds the unsplit float32 P.
//   * The tensor cores' float32 sums lose to truncation: an output summed
//     through one accumulator over 2,048 keys missed the gate by 2x on the
//     H100, as a model that rounds every mma's sum toward zero predicts
//     (tests/test_torch_attention.py::
//     test_tf32x3_short_mma_chains_absorb_truncation). So each mma chain is
//     short: a score tile sums one 16-dim block (6 mma's) into a zeroed
//     accumulator, an output n8 tile one 32-key tile (12 mma's), and the
//     float32 cores add those in, rounding to nearest (s += acc;
//     o = alpha * o + acc, one fma).
//   * FlashAttention-2's structure on mma.sync.m16n8k8 (tf32 in, float32
//     out), as flash_attention_mma.cu: one block of 4 warps per (batch *
//     query head, 64 query rows), each warp owning 16 rows; 32-key tiles of
//     K and V staged with 16-byte cp.async copies, double buffered, rows
//     past Skv zero-filled (src-size 0) and masked.
//   * Q stays in shared memory and each fragment is split when it is used:
//     holding Q's hi and lo in registers would take 128 of them at D = 128
//     beside the 64 of the output accumulators. Shared memory at D = 128:
//     36 KB of Q and 2 x (18 + 16.5) KB of K/V, 105 KB a block, two blocks
//     an SM, which the launch bounds ask of ptxas too (up to 255 registers
//     a thread).
//   * S = Q K^T: the order of the k (head) dimension inside an instruction
//     is free, so k index t of a k8 step reads dim 4t (+2 in the second
//     step of a 16-dim block) and k index t + 4 the dim after it. A lane's
//     four dims of a row are then one 16-byte shared load, for Q's A
//     fragments and K's B fragments alike. Rows are padded to D + 16 floats
//     (D = 16: none), so the 8 lanes of each 16-byte load phase hit 8
//     distinct bank groups.
//   * The online softmax runs on the accumulators in registers: a row lives
//     in the 4 lanes of a quad, so its max and sum need two shuffles. No
//     exp while the running max is -inf, 0 / 0 -> NaN at the end.
//   * P V without shuffles: the score accumulator of an n8 tile holds keys
//     2t and 2t + 1 of rows g and g + 8 in lane (g = lane / 4, t = lane % 4),
//     but m16n8k8's A fragment wants k indices t and t + 4. The order of the
//     keys inside the instruction is free, so k index t is key 2t and k index
//     t + 4 is key 2t + 1: a0 = c0, a1 = c2, a2 = c1, a3 = c3, and V's B
//     fragment is loaded to match, b0 = V[2t][n], b1 = V[2t + 1][n].
//   * V's B fragments are 32-bit shared loads (ldmatrix.trans moves 16-bit
//     elements only). V's rows are padded to D + 4 floats, so rows 2t of
//     the 4 lane columns start 8 banks apart and the warp's 32 loads hit 32
//     distinct banks.
//   * Key tiles wholly above a causal diagonal are skipped, by the block and
//     by each warp; causal query tiles are walked longest first.
// Left for later: wgmma, TMA, a split over the keys for decoding, splitting
// K and V once per block instead of once per warp.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kQTile = kWarps * 16;  // query rows of one block
constexpr int kKTile = 32;           // keys of one shared-memory tile

// Row strides, in floats, of the Q and K tiles (16-byte loads along a row:
// consecutive rows 4 bank groups apart) and of the V tile (32-bit loads down
// a column: rows 2t four banks apart)
template <int D>
__host__ __device__ constexpr int qk_stride() {
  return D % 32 == 16 ? D : D + 16;
}
template <int D>
__host__ __device__ constexpr int v_stride() { return D + 4; }

template <int D>
constexpr int smem_bytes() {  // Q, 2 x K, 2 x V
  return (kQTile * qk_stride<D>() +
          2 * kKTile * (qk_stride<D>() + v_stride<D>())) * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy to shared memory; zero-fills the chunk when !pred
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// x rounded to TF32, to nearest with ties away from zero: what
// cvt.rna.tf32.f32 gives, for which ptxas emits four instructions on sm_90a
// (a compare, a select and two integer ops); half a TF32 ulp added to the
// magnitude bits, then the 13 low bits cleared, is two
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi = tf32(x), lo = tf32(x - hi): x - hi is exact in float32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a * b, m16n8k8, tf32 inputs, float32 accumulator
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32: the small terms first, then hi * hi
__device__ __forceinline__ void mma_3x(float* d, const uint32_t* a_hi,
                                       const uint32_t* a_lo, uint32_t b0_hi,
                                       uint32_t b1_hi, uint32_t b0_lo,
                                       uint32_t b1_lo) {
  mma_tf32(d, a_lo, b0_hi, b1_hi);
  mma_tf32(d, a_hi, b0_lo, b1_lo);
  mma_tf32(d, a_hi, b0_hi, b1_hi);
}

// Issue the copies of rows [row0, row0 + n_rows) of a [rows, D] slab with
// row stride `stride` (elements) into an [n_rows][S] tile; rows at or past
// `limit` are zero-filled.
template <int D, int S, int n_rows>
__device__ __forceinline__ void load_tile(float* tile, const float* base,
                                          long long stride, int row0,
                                          int limit) {
  constexpr int cpr = D / 4;  // 16-byte chunks per row
  const uint32_t dst = smem_addr(tile);
#pragma unroll
  for (int i = threadIdx.x; i < n_rows * cpr; i += kThreads) {
    const int r = i / cpr;
    const int c = i % cpr;
    const bool live = row0 + r < limit;
    const float* src = base + (live ? (row0 + r) * stride + c * 4 : 0);
    cp_async16(dst + (r * S + c * 4) * 4, src, live);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_attention_tf32x3_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int sq, int skv,
    int hq, int hkv, float scale_log2, int causal) {
  constexpr int SQK = qk_stride<D>();
  constexpr int SV = v_stride<D>();
  constexpr int kDimBlocks = D / 16;  // 16-dim blocks (two k8 steps each)
  constexpr int kDimTiles = D / 8;    // n8 tiles of the output
  constexpr int kKeyTiles = kKTile / 8;
  extern __shared__ float4 smem[];
  // Q, then K and V tiles in turn: [Q][K0][V0][K1][V1]
  float* qs = reinterpret_cast<float*>(smem);
  auto ks = [&](int buf) {
    return qs + kQTile * SQK + buf * kKTile * (SQK + SV);
  };
  auto vs = [&](int buf) { return ks(buf) + kKTile * SQK; };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row of the fragment (and row + 8)
  const int t = lane & 3;   // column quad of the fragment
  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int h = bh % hq;
  const int hk = h / (hq / hkv);
  // causal: the last query tiles see the most keys, so they go first
  const int q_tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = q_tile * kQTile;
  const int kv_offset = skv - sq;
  const long long q_stride = static_cast<long long>(hq) * D;
  const long long kv_stride = static_cast<long long>(hkv) * D;
  const float* q_base = q + static_cast<long long>(b) * sq * q_stride + h * D;
  const float* k_base =
      k + static_cast<long long>(b) * skv * kv_stride + hk * D;
  const float* v_base =
      v + static_cast<long long>(b) * skv * kv_stride + hk * D;

  // keys the block, and this warp, must visit (causal: up to the diagonal
  // of its last row)
  const int block_last = min(q0 + kQTile, sq) - 1;
  const int block_keys = causal ? min(skv, block_last + kv_offset + 1) : skv;
  const int n_tiles = block_keys > 0 ? (block_keys + kKTile - 1) / kKTile : 0;
  const int r0 = q0 + warp * 16;  // the warp's first query row
  const bool warp_live = r0 < sq;
  const int warp_last = min(r0 + 16, sq) - 1;
  const int warp_keys = causal ? min(skv, warp_last + kv_offset + 1) : skv;

  load_tile<D, SQK, kQTile>(qs, q_base, q_stride, q0, sq);
  if (n_tiles > 0) {
    load_tile<D, SQK, kKTile>(ks(0), k_base, kv_stride, 0, skv);
    load_tile<D, SV, kKTile>(vs(0), v_base, kv_stride, 0, skv);
  }
  cp_async_commit();

  float o[kDimTiles][4];  // output accumulators: rows g and g + 8
  float m[2] = {-INFINITY, -INFINITY};  // running max, in log2 units
  float l[2] = {0.f, 0.f};  // this lane's share of the running sum
#pragma unroll
  for (int j = 0; j < kDimTiles; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // the warp's rows g and g + 8 of Q, at this lane's column quad
  const float* q_row = qs + (warp * 16 + g) * SQK + 4 * t;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kv0 = tile * kKTile;
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {  // the buffer's last reader synced below
      load_tile<D, SQK, kKTile>(ks(buf ^ 1), k_base, kv_stride,
                                kv0 + kKTile, skv);
      load_tile<D, SV, kKTile>(vs(buf ^ 1), v_base, kv_stride, kv0 + kKTile,
                               skv);
    }
    cp_async_commit();
    cp_async_wait1();  // everything but the newest group has landed
    __syncthreads();
    if (warp_live && kv0 < warp_keys) {  // uniform in the warp
      // S = Q K^T for the warp's 16 rows and the tile's 32 keys; k index t
      // of step st reads dim 16 * db + 4t + 2 * st, k index t + 4 the next
      float s[kKeyTiles][4];
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const float* k_row = ks(buf) + g * SQK + 4 * t;
#pragma unroll 2  // fully unrolled, ptxas hoists loads until it spills
      for (int db = 0; db < kDimBlocks; ++db) {
        const float4 qa = *reinterpret_cast<const float4*>(q_row + 16 * db);
        const float4 qb =
            *reinterpret_cast<const float4*>(q_row + 8 * SQK + 16 * db);
        uint32_t a_hi[2][4], a_lo[2][4];
        split(qa.x, a_hi[0][0], a_lo[0][0]);
        split(qb.x, a_hi[0][1], a_lo[0][1]);
        split(qa.y, a_hi[0][2], a_lo[0][2]);
        split(qb.y, a_hi[0][3], a_lo[0][3]);
        split(qa.z, a_hi[1][0], a_lo[1][0]);
        split(qb.z, a_hi[1][1], a_lo[1][1]);
        split(qa.w, a_hi[1][2], a_lo[1][2]);
        split(qb.w, a_hi[1][3], a_lo[1][3]);
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j) {
          const float4 kb =
              *reinterpret_cast<const float4*>(k_row + 8 * j * SQK + 16 * db);
          uint32_t b_hi[4], b_lo[4];
          split(kb.x, b_hi[0], b_lo[0]);
          split(kb.y, b_hi[1], b_lo[1]);
          split(kb.z, b_hi[2], b_lo[2]);
          split(kb.w, b_hi[3], b_lo[3]);
          float acc[4] = {0.f, 0.f, 0.f, 0.f};  // this block's 16 dims
          mma_3x(acc, a_hi[0], a_lo[0], b_hi[0], b_hi[1], b_lo[0], b_lo[1]);
          mma_3x(acc, a_hi[1], a_lo[1], b_hi[2], b_hi[3], b_lo[2], b_lo[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += acc[e];
        }
      }

      // mask (ragged last tile, causal diagonal), scale, row max
      const bool ragged = kv0 + kKTile > skv;
      const bool diagonal = causal && kv0 + kKTile - 1 > r0 + kv_offset;
      float row_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (ragged || diagonal) {
            const int kpos = kv0 + j * 8 + 2 * t + (e & 1);
            const int qpos = r0 + g + (e >> 1) * 8;
            if (kpos >= skv || (causal && kpos > qpos + kv_offset))
              x = -INFINITY;
          }
          s[j][e] = x;
          row_max[e >> 1] = fmaxf(row_max[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = row_max[i];
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        // no key seen yet: keep everything at 0, compute no exp
        alpha[i] = m_new == -INFINITY ? 1.f : exp2f(m[i] - m_new);
        m[i] = m_new;
      }
      float row_sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mi = m[e >> 1];
          const float p = mi == -INFINITY ? 0.f : exp2f(s[j][e] - mi);
          s[j][e] = p;
          row_sum[e >> 1] += p;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + row_sum[i];

      // O = alpha O + P V, P straight from the accumulators: k index t is
      // key 2t and t + 4 key 2t + 1 of the n8 score tile j
      uint32_t p_hi[kKeyTiles][4], p_lo[kKeyTiles][4];
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        split(s[j][0], p_hi[j][0], p_lo[j][0]);
        split(s[j][2], p_hi[j][1], p_lo[j][1]);
        split(s[j][1], p_hi[j][2], p_lo[j][2]);
        split(s[j][3], p_hi[j][3], p_lo[j][3]);
      }
      const float* v_col = vs(buf) + 2 * t * SV + g;
#pragma unroll
      for (int n = 0; n < kDimTiles; ++n) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};  // this tile's P V
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j) {
          const float* v_key = v_col + 8 * j * SV + 8 * n;
          uint32_t b0_hi, b0_lo, b1_hi, b1_lo;
          split(v_key[0], b0_hi, b0_lo);
          split(v_key[SV], b1_hi, b1_lo);
          mma_3x(acc, p_hi[j], p_lo[j], b0_hi, b1_hi, b0_lo, b1_lo);
        }
        o[n][0] = fmaf(o[n][0], alpha[0], acc[0]);
        o[n][1] = fmaf(o[n][1], alpha[0], acc[1]);
        o[n][2] = fmaf(o[n][2], alpha[1], acc[2]);
        o[n][3] = fmaf(o[n][3], alpha[1], acc[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  cp_async_wait0();

  if (!warp_live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = r0 + g + 8 * i;
    if (qpos >= sq) continue;
    // no key seen: 0 / 0, the oracle's NaN row
    const float inv = l[i] > 0.f ? 1.f / l[i] : __int_as_float(0x7fffffff);
    float* dst = out + static_cast<long long>(b) * sq * q_stride +
                 qpos * q_stride + h * D + 2 * t;
#pragma unroll
    for (int j = 0; j < kDimTiles; ++j)
      *reinterpret_cast<float2*>(dst + j * 8) =
          make_float2(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int sq, int skv, int hq, int hkv, float scale, int causal,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  auto kernel = flash_attention_tf32x3_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(batch) * hq,
                  static_cast<unsigned>((sq + kQTile - 1) / kQTile));
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sq, skv, hq,
      hkv, scale * 1.4426950408889634f, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 q, k, v and out, 16-byte aligned. d in {16, 32, 64, 128}; hq a
// multiple of hkv; batch * hq and ceil(sq / 64) grid-sized. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a head
// size it does not take.
extern "C" int repro_flash_attention_tf32x3(const void* q, const void* k,
                                            const void* v, void* out,
                                            int batch, int sq, int skv,
                                            int hq, int hkv, int d,
                                            float scale, int causal,
                                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(q, k, v, out, batch, sq, skv, hq, hkv, scale, causal, s);
    case 32: return launch<32>(q, k, v, out, batch, sq, skv, hq, hkv, scale, causal, s);
    case 64: return launch<64>(q, k, v, out, batch, sq, skv, hq, hkv, scale, causal, s);
    case 128: return launch<128>(q, k, v, out, batch, sq, skv, hq, hkv, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}
