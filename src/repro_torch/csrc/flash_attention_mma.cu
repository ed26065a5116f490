// Hopper (sm_90a) flash attention for bf16 on the tensor cores: blocked
// online-softmax attention with float32 accumulation, causal or not, with
// grouped-query heads, its products issued as warp-level mma.sync.
//
// Replaces src/repro/kernels/flash_attention/kernel.py,
// flash_attention_pallas (body _flash_kernel), for bf16 q, k and v; float32
// goes to flash_attention.cu, since the tensor cores' float32 path is TF32.
// Its contract is the JAX package's oracle,
// src/repro/kernels/flash_attention/ref.py::attention_ref:
//   * q [B, Sq, Hq, D], k and v [B, Skv, Hkv, D], contiguous, in the JAX
//     layout, D in {16, 32, 64, 128}; query head h reads kv head
//     h / (Hq / Hkv);
//   * causal masking aligns the last query row with the last key: row r
//     sees keys <= r + (Skv - Sq);
//   * masked scores are -inf, so a row that sees no key comes out NaN;
//   * scores and sums are float32, and the output is rounded once to bf16.
//
// Bound: a long prefill is bound by operations, 4 * B * Hq * (visible
// query-key pairs) * D at the tensor cores' bf16 rate; decoding by the
// bytes of K and V. What the design does about each:
//   * FlashAttention-2's structure on mma.sync.m16n8k16 (bf16 in, float32
//     out): one block of 4 warps per (batch * query head, 64 query rows),
//     each warp owning 16 rows, the M of the instruction. The Q tile's A
//     fragments are loaded once with ldmatrix and stay in registers.
//   * 64-key tiles of K and V are staged in shared memory with 16-byte
//     cp.async copies, double buffered, so the next tile's bytes are in
//     flight while this one is computed. Rows past Skv are zero-filled
//     (src-size 0) and masked. The 16-byte chunks of a row are swizzled,
//     chunk ^ f(row), so that every ldmatrix phase hits 8 distinct bank
//     groups. D = 128: 16 KB of Q and 2 x 2 x 16 KB of K/V, 80 KB a block,
//     two blocks an SM.
//   * S = Q K^T: K's B fragments come from ldmatrix without .trans (K is
//     [key][d]). Products of bf16 values are exact in float32, so only the
//     order of the sums differs from the oracle.
//   * The online softmax runs on the accumulators in registers: a row lives
//     in the 4 lanes of a quad, so its max and sum need two shuffles. No
//     exp while the running max is -inf, 0 / 0 -> NaN at the end. The sum l
//     adds the unrounded float32 probabilities.
//   * P V: two adjacent n8 score tiles are the A fragment of one k16 tile,
//     so P never goes through shared memory. P is split there into two bf16
//     halves, hi = bf16(p) and lo = bf16(p - hi), and both are multiplied
//     into the same float32 accumulator: a P rounded once to bf16 (what
//     FlashAttention-2 and SDPA do) puts a relative error of 2^-9 on every
//     probability, which at 8,192 keys and 16 heads takes the worst element
//     past the port's bf16 gate (2 ulps + 1e-3 of the largest value); hi + lo
//     carries p to about 2^-17. It costs 50% more tensor-core work than the
//     bound counts. V's B fragments come from ldmatrix.trans.
//   * Key tiles wholly above a causal diagonal are skipped, by the block and
//     by each warp; a warp whose 16 rows all lie at or past Sq only helps
//     load (decoding, Sq = 1, computes one warp's rows). Causal query tiles
//     are walked longest first, so the heavy blocks start in the first wave.
// Left for later: wgmma, TMA, mbarriers, warp specialisation, a split over
// the keys for decoding, packing a GQA group's rows into M.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kQTile = kWarps * 16;  // query rows of one block
constexpr int kKTile = 64;           // keys of one shared-memory tile

// Index, in 16-byte chunks, of chunk `c` of row `r` of a [rows][D] bf16 tile:
// the chunk is XORed with bits of the row so that the 8 rows an ldmatrix
// phase reads (same logical chunk, rows 8i .. 8i + 7) fall on 8 distinct
// 16-byte bank groups of a 128-byte line.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int cpr = D / 8;                    // chunks per row
  constexpr int rows_per_line = cpr >= 8 ? 1 : 8 / cpr;
  constexpr int mask = (cpr >= 8 ? 8 : cpr) - 1;
  return r * cpr + (c ^ ((r / rows_per_line) & mask));
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a * b, m16n8k16, bf16 inputs, float32 accumulator
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) as a bf16 pair, hi = bf16(x) and lo = bf16(x - hi)
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - __low2float(h),
                                    x1 - __high2float(h)));
}

// Issue the copies of rows [row0, row0 + n_rows) of a [rows, D] slab with
// row stride `stride` (elements) into a swizzled [n_rows][D] tile; rows at
// or past `limit` are zero-filled.
template <int D, int n_rows>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* base,
                                          long long stride, int row0,
                                          int limit) {
  constexpr int cpr = D / 8;
  const uint32_t dst = smem_addr(tile);
#pragma unroll
  for (int i = threadIdx.x; i < n_rows * cpr; i += kThreads) {
    const int r = i / cpr;
    const int c = i % cpr;
    const bool live = row0 + r < limit;
    const __nv_bfloat16* src = base + (live ? (row0 + r) * stride + c * 8 : 0);
    cp_async16(dst + swz<D>(r, c) * 16, src, live);
  }
}

template <int D>
constexpr int smem_bytes() {
  return (kQTile * D + 4 * kKTile * D) * 2;  // Q, 2 x K, 2 x V (bf16)
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int sq, int skv, int hq, int hkv, float scale_log2, int causal) {
  constexpr int kSteps = D / 16;     // k16 steps over the head size
  constexpr int kDimTiles = D / 8;   // n8 tiles of the output
  constexpr int kKeyTiles = kKTile / 8;
  extern __shared__ uint4 smem[];
  // Q, then K and V tiles in turn: [Q][K0][V0][K1][V1]
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  auto ks = [&](int buf) { return qs + (kQTile + 2 * buf * kKTile) * D; };
  auto vs = [&](int buf) { return qs + (kQTile + (2 * buf + 1) * kKTile) * D; };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row of the fragment (and row + 8)
  const int t = lane & 3;   // column pair of the fragment
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
  const __nv_bfloat16* q_base =
      q + static_cast<long long>(b) * sq * q_stride + h * D;
  const __nv_bfloat16* k_base =
      k + static_cast<long long>(b) * skv * kv_stride + hk * D;
  const __nv_bfloat16* v_base =
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

  load_tile<D, kQTile>(qs, q_base, q_stride, q0, sq);
  if (n_tiles > 0) {
    load_tile<D, kKTile>(ks(0), k_base, kv_stride, 0, skv);
    load_tile<D, kKTile>(vs(0), v_base, kv_stride, 0, skv);
  }
  cp_async_commit();

  uint32_t qf[kSteps][4];  // the warp's Q rows as A fragments
  float o[kDimTiles][4];   // output accumulators: rows g and g + 8
  float m[2] = {-INFINITY, -INFINITY};  // running max, in log2 units
  float l[2] = {0.f, 0.f};  // this lane's share of the running sum
#pragma unroll
  for (int j = 0; j < kDimTiles; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kv0 = tile * kKTile;
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {  // the buffer's last reader synced below
      load_tile<D, kKTile>(ks(buf ^ 1), k_base, kv_stride, kv0 + kKTile, skv);
      load_tile<D, kKTile>(vs(buf ^ 1), v_base, kv_stride, kv0 + kKTile, skv);
    }
    cp_async_commit();
    cp_async_wait1();  // everything but the newest group has landed
    __syncthreads();
    if (tile == 0) {
      // A fragments: matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15)
      const int mat = lane >> 3;
      const int row = warp * 16 + (mat & 1) * 8 + (lane & 7);
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        ldmatrix_x4(smem_addr(qs) + swz<D>(row, 2 * s + (mat >> 1)) * 16,
                    qf[s]);
    }
    if (warp_live && kv0 < warp_keys) {  // uniform in the warp
      // S = Q K^T for the warp's 16 rows and the tile's 64 keys
      float s[kKeyTiles][4];
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const uint32_t k_addr = smem_addr(ks(buf));
#pragma unroll
      for (int np = 0; np < kKeyTiles / 2; ++np) {
        // matrices (keys 0-7 | 8-15 of the pair) x (dims 0-7 | 8-15)
        const int mat = lane >> 3;
        const int key = np * 16 + (mat >> 1) * 8 + (lane & 7);
#pragma unroll
        for (int st = 0; st < kSteps; ++st) {
          uint32_t kf[4];
          ldmatrix_x4(k_addr + swz<D>(key, 2 * st + (mat & 1)) * 16, kf);
          mma_bf16(s[2 * np], qf[st], kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qf[st], kf[2], kf[3]);
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
#pragma unroll
      for (int j = 0; j < kDimTiles; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }

      // O += P V, P split into bf16 hi + lo, straight from the accumulators
      const uint32_t v_addr = smem_addr(vs(buf));
#pragma unroll
      for (int kk = 0; kk < kKTile / 16; ++kk) {
        uint32_t p_hi[4], p_lo[4];
        split_pair(s[2 * kk][0], s[2 * kk][1], p_hi[0], p_lo[0]);
        split_pair(s[2 * kk][2], s[2 * kk][3], p_hi[1], p_lo[1]);
        split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], p_hi[2], p_lo[2]);
        split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], p_hi[3], p_lo[3]);
        // matrices (keys 0-7 | 8-15) x (dims 0-7 | 8-15 of the pair)
        const int mat = lane >> 3;
        const int key = kk * 16 + (mat & 1) * 8 + (lane & 7);
#pragma unroll
        for (int dp = 0; dp < kDimTiles / 2; ++dp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(v_addr + swz<D>(key, 2 * dp + (mat >> 1)) * 16, vf);
          mma_bf16(o[2 * dp], p_hi, vf[0], vf[1]);
          mma_bf16(o[2 * dp], p_lo, vf[0], vf[1]);
          mma_bf16(o[2 * dp + 1], p_hi, vf[2], vf[3]);
          mma_bf16(o[2 * dp + 1], p_lo, vf[2], vf[3]);
        }
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
    __nv_bfloat16* dst = out + static_cast<long long>(b) * sq * q_stride +
                         qpos * q_stride + h * D + 2 * t;
#pragma unroll
    for (int j = 0; j < kDimTiles; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
          __floats2bfloat162_rn(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int sq, int skv, int hq, int hkv, float scale, int causal,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  auto kernel = flash_attention_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(batch) * hq,
                  static_cast<unsigned>((sq + kQTile - 1) / kQTile));
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      sq, skv, hq, hkv, scale * 1.4426950408889634f, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v and out, 16-byte aligned. d in {16, 32, 64, 128}; hq a
// multiple of hkv; batch * hq and ceil(sq / 64) grid-sized. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a head
// size it does not take.
extern "C" int repro_flash_attention_mma(const void* q, const void* k,
                                         const void* v, void* out, int batch,
                                         int sq, int skv, int hq, int hkv,
                                         int d, float scale, int causal,
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
