// Flash-decode for Hopper (sm_90a): one new query token per row attends
// over that row's KV cache.
//
// Replaces the Pallas TPU kernel skypilot_tpu/ops/decode_attention.py::
// _decode_kernel (pallas_call at :147 for a bf16 cache, :162 for an int8
// cache). One body serves both modes, as there: a template on QUANT and on
// the element type (bf16, and fp32 for tight checks).
//
//   q        [B, Hkv * G, D]   T (bf16 or fp32)
//   k, v     [B, Hkv, M, D]    T, or int8 codes when QUANT
//   k_s, v_s [B, Hkv, M]       fp32 per-position scales (QUANT only)
//   lengths  [B]               int32: attend positions < lengths[b]
//   out      [B, Hkv * G, D]   T
//
// Bound: memory. Each (row, kv head) reads its K and V rows up to
// lengths[b] (plus the scales in int8 mode) once and does 4*G*D flops per
// position, G = 2..4 for the presets: about one flop per byte, far below
// the ~295 flops per byte where the H100 stops being bound by its 3.35 TB/s.
// So the least time is (K/V/scale bytes up to lengths) / bandwidth.
//
// Design against that bound:
//  * grid (B, Hkv), as the TPU grid: one block per (row, kv head), so the
//    G query heads that share a kv head read its cache once;
//  * the block streams the cache in tiles of 32 positions through shared
//    memory, with 16-byte coalesced loads, and stops at lengths[b]: the
//    bytes read are the bytes the row needs, never all of M;
//  * the next tile's loads are issued into registers before the current
//    tile is computed, so one tile of loads is always in flight;
//  * running max, normaliser and accumulator stay in fp32 on chip (online
//    softmax); no logits tensor is written to device memory.
// A tile that ends past lengths[b] is masked (loads skipped, logits -inf),
// never clamped. Known gap: at B=1 the grid is (1, Hkv) = 8 blocks for 132
// SMs; splitting M across blocks (split-K) is the next step for small B.
//
// Empty rows (lengths[b] <= 0) follow the plain version: every position
// gets the same -1e30 logit, so the output is the mean of V over all M.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // 4 warps
constexpr int kTile = 32;         // cache positions per tile: one per lane
constexpr int kMaxGroup = 8;      // query heads per kv head
constexpr float kMasked = -1e30f;  // the plain version's masked logit

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename C, int kD>
struct Tile {
  static constexpr int kVec = 16 / sizeof(C);          // elements per load
  static constexpr int kRowVecs = kD / kVec;           // loads per row
  static constexpr int kLoads = kTile * kRowVecs / kThreads;  // per thread
  static_assert(kD % kVec == 0, "row must be whole 16-byte vectors");
  static_assert(kTile * kRowVecs % kThreads == 0, "loads must split evenly");

  uint4 k[kLoads];
  uint4 v[kLoads];
  float ks = 0.f, vs = 0.f;

  // Issue this thread's loads of positions [start, start + kTile); rows at
  // or past `span` are zero and are never read from memory.
  template <bool kQuant>
  __device__ __forceinline__ void load(const C* kh, const C* vh,
                                       const float* ksh, const float* vsh,
                                       int start, int span) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int pos = start + idx / kRowVecs;
      const int col = (idx % kRowVecs) * kVec;
      if (pos < span) {
        k[i] = *reinterpret_cast<const uint4*>(kh + (size_t)pos * kD + col);
        v[i] = *reinterpret_cast<const uint4*>(vh + (size_t)pos * kD + col);
      } else {
        k[i] = make_uint4(0, 0, 0, 0);
        v[i] = make_uint4(0, 0, 0, 0);
      }
    }
    if (kQuant && threadIdx.x < kTile) {
      const int pos = start + threadIdx.x;
      ks = pos < span ? ksh[pos] : 0.f;
      vs = pos < span ? vsh[pos] : 0.f;
    }
  }

  // Convert the registers to fp32 in shared memory.
  template <bool kQuant>
  __device__ __forceinline__ void store(float (*k_sm)[kD + 1],
                                        float (*v_sm)[kD], float* ks_sm,
                                        float* vs_sm) const {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int row = idx / kRowVecs;
      const int col = (idx % kRowVecs) * kVec;
      const C* ke = reinterpret_cast<const C*>(&k[i]);
      const C* ve = reinterpret_cast<const C*>(&v[i]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        k_sm[row][col + j] = to_float(ke[j]);
        v_sm[row][col + j] = to_float(ve[j]);
      }
    }
    if (kQuant && threadIdx.x < kTile) {
      ks_sm[threadIdx.x] = ks;
      vs_sm[threadIdx.x] = vs;
    }
  }
};

template <typename T, typename C, bool kQuant, int kD>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const C* __restrict__ k,
              const C* __restrict__ v, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              const int* __restrict__ lengths, T* __restrict__ out,
              int hkv, int group, int max_len, float scale) {
  constexpr int kOut = kMaxGroup * kD / kThreads;  // accumulators / thread
  __shared__ float q_sm[kMaxGroup][kD];
  __shared__ float k_sm[kTile][kD + 1];  // +1: conflict-free row reads
  __shared__ float v_sm[kTile][kD];
  __shared__ float p_sm[kMaxGroup][kTile];
  __shared__ float m_sm[kMaxGroup], l_sm[kMaxGroup], alpha_sm[kMaxGroup];
  __shared__ float ks_sm[kTile], vs_sm[kTile];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t head = (size_t)b * hkv + h;
  const int len = lengths[b];
  const bool empty = len <= 0;
  const int span = empty ? max_len : min(len, max_len);
  const float minus_inf = __int_as_float(0xff800000);

  const T* qh = q + head * group * kD;
  const C* kh = k + head * max_len * kD;
  const C* vh = v + head * max_len * kD;
  const float* ksh = kQuant ? k_scale + head * max_len : nullptr;
  const float* vsh = kQuant ? v_scale + head * max_len : nullptr;

  for (int i = tid; i < group * kD; i += kThreads)
    q_sm[i / kD][i % kD] = to_float(qh[i]);
  if (tid < kMaxGroup) {
    m_sm[tid] = kMasked;
    l_sm[tid] = 0.f;
  }
  float acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.f;

  Tile<C, kD> tile;
  tile.template load<kQuant>(kh, vh, ksh, vsh, 0, span);
  const int n_tiles = (span + kTile - 1) / kTile;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int t = 0; t < n_tiles; ++t) {
    const int start = t * kTile;
    tile.template store<kQuant>(k_sm, v_sm, ks_sm, vs_sm);
    __syncthreads();
    if (t + 1 < n_tiles)
      tile.template load<kQuant>(kh, vh, ksh, vsh, start + kTile, span);

    // Logits: (query g, position j) pairs over the block's threads.
    for (int idx = tid; idx < group * kTile; idx += kThreads) {
      const int g = idx / kTile;
      const int j = idx % kTile;
      float s;
      if (start + j >= span) {
        s = minus_inf;  // past the row's length: weight exactly 0
      } else if (empty) {
        s = kMasked;
      } else {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < kD; ++d) dot = fmaf(q_sm[g][d], k_sm[j][d], dot);
        s = dot * scale;
        if (kQuant) s *= ks_sm[j];
      }
      p_sm[g][j] = s;
    }
    __syncthreads();

    // Online softmax, one warp per query row of the group.
    for (int g = warp; g < group; g += kThreads / 32) {
      const float s = p_sm[g][lane];
      const float m_prev = m_sm[g];
      const float l_prev = l_sm[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      float p = expf(s - m_new);
      const float alpha = expf(m_prev - m_new);
      const float l_new = l_prev * alpha + warp_sum(p);
      if (kQuant) p *= vs_sm[lane];
      // Probabilities enter PV in q's dtype, as in the TPU kernel.
      p_sm[g][lane] = to_float(from_float<T>(p));
      __syncwarp();
      if (lane == 0) {
        m_sm[g] = m_new;
        l_sm[g] = l_new;
        alpha_sm[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V, thread-owned (g, d) outputs.
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < group * kD) {
        const int g = idx / kD;
        const int d = idx % kD;
        float a = acc[i] * alpha_sm[g];
#pragma unroll 8
        for (int j = 0; j < kTile; ++j) a = fmaf(p_sm[g][j], v_sm[j][d], a);
        acc[i] = a;
      }
    }
    __syncthreads();  // the next tile overwrites k_sm, v_sm and p_sm
  }

  T* oh = out + head * group * kD;
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < group * kD)
      oh[idx] = from_float<T>(acc[i] / fmaxf(l_sm[idx / kD], 1e-30f));
  }
}

template <typename T, typename C, bool kQuant, int kD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_s, const void* v_s, const void* lengths,
                   void* out, int batch, int hkv, int group, int max_len,
                   float scale, cudaStream_t stream) {
  const dim3 grid(batch, hkv);
  decode_kernel<T, C, kQuant, kD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(k),
      static_cast<const C*>(v), static_cast<const float*>(k_s),
      static_cast<const float*>(v_s), static_cast<const int*>(lengths),
      static_cast<T*>(out), hkv, group, max_len, scale);
  return cudaGetLastError();
}

template <typename T, typename C, bool kQuant>
cudaError_t launch_d(int head_dim, const void* q, const void* k,
                     const void* v, const void* k_s, const void* v_s,
                     const void* lengths, void* out, int batch, int hkv,
                     int group, int max_len, float scale,
                     cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<T, C, kQuant, 64>(q, k, v, k_s, v_s, lengths, out, batch,
                                      hkv, group, max_len, scale, stream);
    case 128:
      return launch<T, C, kQuant, 128>(q, k, v, k_s, v_s, lengths, out,
                                       batch, hkv, group, max_len, scale,
                                       stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (q, out, and the cache unless quantized).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int skytorch_flash_decode(int dtype, int quantized, const void* q,
                                     const void* k, const void* v,
                                     const void* k_s, const void* v_s,
                                     const void* lengths, void* out,
                                     int batch, int hkv, int group,
                                     int max_len, int head_dim, float scale,
                                     void* stream) {
  if (batch < 1 || hkv < 1 || hkv > 65535 || group < 1 ||
      group > kMaxGroup || max_len < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return quantized
        ? launch_d<float, int8_t, true>(head_dim, q, k, v, k_s, v_s, lengths,
                                        out, batch, hkv, group, max_len,
                                        scale, s)
        : launch_d<float, float, false>(head_dim, q, k, v, k_s, v_s,
                                        lengths, out, batch, hkv, group,
                                        max_len, scale, s);
  }
  if (dtype == 1) {
    return quantized
        ? launch_d<__nv_bfloat16, int8_t, true>(head_dim, q, k, v, k_s, v_s,
                                                lengths, out, batch, hkv,
                                                group, max_len, scale, s)
        : launch_d<__nv_bfloat16, __nv_bfloat16, false>(
              head_dim, q, k, v, k_s, v_s, lengths, out, batch, hkv, group,
              max_len, scale, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* skytorch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
