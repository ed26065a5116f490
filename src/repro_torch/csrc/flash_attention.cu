// Hopper (sm_90a) flash attention: blocked online-softmax attention with
// float32 accumulation, causal or not, with grouped-query heads.
//
// Replaces src/repro/kernels/flash_attention/kernel.py,
// flash_attention_pallas (body _flash_kernel). Its contract is the JAX
// package's oracle, src/repro/kernels/flash_attention/ref.py::attention_ref:
//   * q [B, Sq, Hq, D], k and v [B, Skv, Hkv, D], contiguous, in the JAX
//     layout; query head h reads kv head h / (Hq / Hkv);
//   * causal masking aligns the last query row with the last key: row r
//     sees keys <= r + (Skv - Sq);
//   * masked scores are -inf, as in the oracle (the Pallas kernel uses
//     -1e30), so a row that sees no key comes out NaN;
//   * inputs are read as float32 (bf16 converted on load), every product
//     and sum is float32, and the output is rounded once to q's dtype.
//
// Design (simple and right first; tensor cores, TMA and a split over the
// keys for decoding come later). One block of 8 warps per (batch * query
// head, tile of 64 query rows); each warp owns 8 rows. The block stages its
// query tile and each 64-key tile of K and V in shared memory as float32.
// Scores: lane j computes the 8 rows' dot products with keys j and j + 32
// over all of D, reading K from a row stride of D + 1 floats (no bank
// conflicts) and the query rows as float4 broadcasts. The online-softmax
// update runs per row with butterfly reductions across the warp; the
// probabilities go to shared memory, transposed, and lane c accumulates
// output columns c, c + 32, ... in registers: p broadcast as float4, V read
// along its row. Key tiles wholly above a causal diagonal are skipped.
// Bound: 4 * B * Hq * (visible query-key pairs) * D operations at the
// tensor cores' bf16 rate, or the bytes of q, k, v and out; this kernel
// runs on the float32 cores and is far from either.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;               // query rows of one warp
constexpr int kQTile = kWarps * kRows;  // query rows of one block
constexpr int kKTile = 64;             // keys of one shared-memory tile

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
constexpr int smem_floats() {
  // Q tile, K tile (row stride D + 1), V tile, probabilities [warp][key][row]
  return kQTile * D + kKTile * (D + 1) + kKTile * D + kWarps * kKTile * kRows;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int sq, int skv, int hq, int hkv, float scale,
    int causal) {
  constexpr int kCols = (D + 31) / 32;  // output columns per lane
  constexpr int kQuads = D / 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kQTile * D;
  float* vs = ks + kKTile * (D + 1);
  float* ps = vs + kKTile * D;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int h = bh % hq;
  const int hk = h / (hq / hkv);
  const int q0 = blockIdx.y * kQTile;
  const int kv_offset = skv - sq;
  const long long q_stride = static_cast<long long>(hq) * D;
  const long long kv_stride = static_cast<long long>(hkv) * D;
  const T* q_base = q + static_cast<long long>(b) * sq * q_stride + h * D;
  const T* k_base = k + static_cast<long long>(b) * skv * kv_stride + hk * D;
  const T* v_base = v + static_cast<long long>(b) * skv * kv_stride + hk * D;

  for (int i = threadIdx.x; i < kQTile * kQuads; i += kThreads) {
    const int r = i / kQuads;
    const int c = (i % kQuads) * 4;
    const float4 x = q0 + r < sq ? load4(q_base + (q0 + r) * q_stride + c)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(qs + r * D + c) = x;
  }

  // keys the block, and this warp, must visit (causal: up to the diagonal
  // of its last row)
  const int block_last = min(q0 + kQTile, sq) - 1;
  const int block_keys = causal ? min(skv, block_last + kv_offset + 1) : skv;
  const int r0 = warp * kRows;
  const bool warp_live = q0 + r0 < sq;
  const int warp_last = min(q0 + r0 + kRows, sq) - 1;
  const int warp_keys = causal ? min(skv, warp_last + kv_offset + 1) : skv;

  float acc[kRows][kCols];
  float m[kRows];
  float l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }
  float* my_ps = ps + warp * kKTile * kRows;

  for (int kv0 = 0; kv0 < block_keys; kv0 += kKTile) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < kKTile * kQuads; i += kThreads) {
      const int r = i / kQuads;
      const int c = (i % kQuads) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (kv0 + r < skv) {
        kx = load4(k_base + (kv0 + r) * kv_stride + c);
        vx = load4(v_base + (kv0 + r) * kv_stride + c);
      }
      float* kd = ks + r * (D + 1) + c;
      kd[0] = kx.x;
      kd[1] = kx.y;
      kd[2] = kx.z;
      kd[3] = kx.w;
      *reinterpret_cast<float4*>(vs + r * D + c) = vx;
    }
    __syncthreads();
    if (!warp_live || kv0 >= warp_keys) continue;  // uniform in the warp

    // scores of the warp's rows against keys kv0 + lane and kv0 + lane + 32
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    const float* k0 = ks + lane * (D + 1);
    const float* k1 = ks + (lane + 32) * (D + 1);
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float a0 = k0[d], a1 = k0[d + 1], a2 = k0[d + 2], a3 = k0[d + 3];
      const float b0 = k1[d], b1 = k1[d + 1], b2 = k1[d + 2], b3 = k1[d + 3];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(qs + (r0 + r) * D + d);
        s[r][0] = fmaf(x.x, a0, s[r][0]);
        s[r][0] = fmaf(x.y, a1, s[r][0]);
        s[r][0] = fmaf(x.z, a2, s[r][0]);
        s[r][0] = fmaf(x.w, a3, s[r][0]);
        s[r][1] = fmaf(x.x, b0, s[r][1]);
        s[r][1] = fmaf(x.y, b1, s[r][1]);
        s[r][1] = fmaf(x.z, b2, s[r][1]);
        s[r][1] = fmaf(x.w, b3, s[r][1]);
      }
    }

    // mask, scale and the online-softmax update, row by row
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + r0 + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = kv0 + lane + 32 * c;
        const bool seen = kpos < skv && (!causal || kpos <= qpos + kv_offset);
        s[r][c] = seen ? s[r][c] * scale : -INFINITY;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      float alpha = 1.f;
      float p0 = 0.f;
      float p1 = 0.f;
      if (m_new != -INFINITY) {  // some key of the row seen so far
        alpha = expf(m[r] - m_new);
        p0 = expf(s[r][0] - m_new);
        p1 = expf(s[r][1] - m_new);
      }
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
      my_ps[lane * kRows + r] = p0;
      my_ps[(lane + 32) * kRows + r] = p1;
    }
    __syncwarp();

    const int n_keys = min(kKTile, warp_keys - kv0);
    for (int j = 0; j < n_keys; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(my_ps + j * kRows);
      const float4 pb = *reinterpret_cast<const float4*>(my_ps + j * kRows + 4);
      const float p[kRows] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        const float x = col < D ? vs[j * D + col] : 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][c] = fmaf(p[r], x, acc[r][c]);
      }
    }
    __syncwarp();
  }

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + r0 + r;
    if (qpos >= sq) break;
    T* dst = out + static_cast<long long>(b) * sq * q_stride +
             qpos * q_stride + h * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      // no key seen: 0 / 0, the oracle's NaN row
      if (col < D) store(dst + col, l[r] > 0.f ? acc[r][c] / l[r] : __int_as_float(0x7fffffff));
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int sq, int skv, int hq, int hkv, float scale, int causal,
           cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(batch) * hq,
                  static_cast<unsigned>((sq + kQTile - 1) / kQTile));
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, hq, hkv, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dim(const void* q, const void* k, const void* v, void* out,
                 int batch, int sq, int skv, int hq, int hkv, int d,
                 float scale, int causal, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, batch, sq, skv, hq, hkv, scale, causal, s);
    case 32: return launch<T, 32>(q, k, v, out, batch, sq, skv, hq, hkv, scale, causal, s);
    case 64: return launch<T, 64>(q, k, v, out, batch, sq, skv, hq, hkv, scale, causal, s);
    case 128: return launch<T, 128>(q, k, v, out, batch, sq, skv, hq, hkv, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out). d in {16, 32, 64,
// 128}; hq a multiple of hkv; batch * hq and ceil(sq / 64) grid-sized.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a dtype or head size it does not take.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int batch,
                                     int sq, int skv, int hq, int hkv, int d,
                                     float scale, int causal, int dtype,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<float>(q, k, v, out, batch, sq, skv, hq, hkv, d,
                               scale, causal, s);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(q, k, v, out, batch, sq, skv, hq, hkv,
                                       d, scale, causal, s);
  return cudaErrorInvalidValue;
}
