// Flash attention for training on Hopper (sm_90a): the forward (K1) and the
// two backward kernels (K2: dQ, K3: dK and dV), causal or full, with GQA.
//
// Replace the Pallas TPU kernels of skypilot_tpu/ops/attention.py:
//   K1 flash_fwd_*kernel      <- _flash_fwd_kernel      (pallas_call at :174)
//   K2 flash_bwd_dq_*kernel   <- _flash_bwd_dq_kernel   (pallas_call at :332)
//   K3 flash_bwd_dkv_*kernel  <- _flash_bwd_dkv_kernel  (pallas_call at :373)
// and compute what they compute, with the same casts: q.k and dO.v products
// of input-type values summed in fp32; p rounded to the input type before
// P.V (K1) and before P^T.dO (K3); ds rounded to the input type before
// dS.K (K2) and dS^T.Q (K3).
//
//   q, dO, o, dq     [B, Hkv * G, S, D]   bf16 or fp32, contiguous
//   k, v             [B, Hkv, S, D]       same type, contiguous
//   lse, delta       [B, Hkv * G, S]      fp32 (delta = rowsum(dO * o))
//   dk, dv           [B, Hkv, S, D]       fp32 (cast by the caller)
// Query head h reads kv head h / G. Any S >= 1: tiles that run past S are
// masked (rows loaded as zero, keys excluded, rows past S never written).
//
// Bound: operations. At training shapes (S = 4096, D = 128) a 64-row tile
// does 2 * 64 * D flops per key row it reads, far above the ~295 flops per
// byte where the H100 stops being bound by memory, so the least time is
// flops over the tensor-core rate (989 TFLOP/s dense bf16).
//
// Two bodies of each kernel, chosen by the input type:
//  * bf16 (training): the products run on the tensor cores with fp32 sums.
//    All three are in flash_attention_sm90.cuh: TMA rings fed by a producer
//    warpgroup, wgmma in two consumer warpgroups, 128-row blocks; K1 is
//    persistent, one block per SM (its header says more).
//  * fp32 (tight checks against the plain version, fp32 models): fp32 FMAs
//    on the CUDA cores, 256 threads per tile, each holding a 4 x 4 sub-tile
//    of the logits; tensor cores would round fp32 inputs to TF32.
// The fp32 bodies below:
//  * a block owns one 64-row tile of its own rows (K1, K2: a query tile of
//    one head; K3: a key tile of one kv head) and streams 64-row tiles of
//    the other side through shared memory;
//  * causal: K1 and K2 stop at the diagonal tile and K3 starts there; only
//    the diagonal tile is masked; the longest sweeps are launched first;
//  * K3 owns its dk and dv tile and loops over the GQA group and the query
//    tiles itself, as the TPU grid's sequential sweep did, so no two blocks
//    write the same output and no atomics are needed;
//  * nothing of size S x S reaches device memory: K1 keeps an online
//    softmax (running max, normaliser) in registers and writes o and the
//    log-sum-exp; K2 and K3 recompute p from the log-sum-exp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attention_sm90.cuh"

namespace {

constexpr int kThreads = 256;       // 16 x 16
constexpr int kTile = 64;           // rows per tile, both sides
constexpr int kSub = kTile / 16;    // rows (and columns) per thread
constexpr int kLdP = kTile + 1;     // row stride of a 64 x 64 smem tile
constexpr float kMaskedM = -1e30f;  // the TPU kernel's initial running max

// -- fp32: CUDA-core kernels -----------------------------------------------------
//
// 256 threads as 16 x 16: each holds rows ty + 16 i and columns tx + 16 j of
// the 64 x 64 logits and a 4 x D/16 slice of the accumulator, so a row's 16
// owners sit in one half-warp and its max and sum reduce with four
// shuffles; rows are padded to D + 1 floats so the 16 column owners read 16
// different banks.

// Max and sum over the 16 threads of a half-warp (the owners of one row).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [0, rows) of the [kTile, D] tile at src into dst (row stride
// D + 1); rows at or past `rows` become zero and are never read.
template <int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int rows) {
  constexpr int kRowVecs = D / 4;
  constexpr int kLd = D + 1;
  for (int idx = threadIdx.x; idx < kTile * kRowVecs; idx += kThreads) {
    const int row = idx / kRowVecs;
    const int col = (idx % kRowVecs) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows)
      val = *reinterpret_cast<const float4*>(src + (size_t)row * D + col);
    float* out = dst + row * kLd + col;
    out[0] = val.x;
    out[1] = val.y;
    out[2] = val.z;
    out[3] = val.w;
  }
}

template <int D>
__host__ __device__ constexpr size_t tile_floats() {
  return (size_t)kTile * (D + 1);
}

// -- K1: forward ---------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem() {  // q, k, v tiles + p
  return (3 * tile_floats<D>() + kTile * kLdP) * sizeof(float);
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int hq, int group, int seq,
                 float scale) {
  constexpr int kLd = D + 1;
  constexpr int kCols = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* q_sm = smem;
  float* k_sm = q_sm + tile_floats<D>();
  float* v_sm = k_sm + tile_floats<D>();
  float* p_sm = v_sm + tile_floats<D>();

  const int n_tiles = (seq + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = qt * kTile;
  const int q_rows = min(kTile, seq - q0);
  const size_t row_base = ((size_t)b * hq + h) * seq + q0;
  const size_t kv_base = ((size_t)b * (hq / group) + h / group) * seq * D;
  const float minus_inf = __int_as_float(0xff800000);

  load_tile<D>(q_sm, q + row_base * D, q_rows);

  float m[kSub], l[kSub], acc[kSub][kCols];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    m[i] = kMaskedM;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int kv_tiles = kCausal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < kv_tiles; ++kt) {
    const int k0 = kt * kTile;
    const int kv_rows = min(kTile, seq - k0);
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(k_sm, k + kv_base + (size_t)k0 * D, kv_rows);
    load_tile<D>(v_sm, v + kv_base + (size_t)k0 * D, kv_rows);
    __syncthreads();

    float s[kSub][kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[kSub], kk[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) a[i] = q_sm[(ty + 16 * i) * kLd + d];
#pragma unroll
      for (int j = 0; j < kSub; ++j) kk[j] = k_sm[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

    // Online softmax over this tile's keys, row by row.
    const bool diag = kCausal && kt == qt;
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int r = ty + 16 * i;
      float mx = minus_inf;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int c = tx + 16 * j;
        const bool keep = c < kv_rows && (!diag || c <= r);
        s[i][j] = keep ? s[i][j] * scale : minus_inf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        p_sm[r * kLdP + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float p[kSub], vv[kCols];
#pragma unroll
      for (int i = 0; i < kSub; ++i) p[i] = p_sm[(ty + 16 * i) * kLdP + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = v_sm[j * kLd + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_rows) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = o + (row_base + r) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      orow[tx + 16 * c] = acc[i][c] / den;
    if (tx == 0) lse[row_base + r] = m[i] + logf(den);
  }
}

// -- K2: dQ --------------------------------------------------------------------

template <int D>
constexpr size_t dq_smem() {  // q, dO, k, v tiles + ds
  return (4 * tile_floats<D>() + kTile * kLdP) * sizeof(float);
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int hq, int group, int seq, float scale) {
  constexpr int kLd = D + 1;
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* q_sm = smem;
  float* do_sm = q_sm + tile_floats<D>();
  float* k_sm = do_sm + tile_floats<D>();
  float* v_sm = k_sm + tile_floats<D>();
  float* ds_sm = v_sm + tile_floats<D>();

  const int n_tiles = (seq + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = qt * kTile;
  const int q_rows = min(kTile, seq - q0);
  const size_t row_base = ((size_t)b * hq + h) * seq + q0;
  const size_t kv_base = ((size_t)b * (hq / group) + h / group) * seq * D;

  load_tile<D>(q_sm, q + row_base * D, q_rows);
  load_tile<D>(do_sm, dout + row_base * D, q_rows);
  float lse_r[kSub], delta_r[kSub], acc[kSub][kCols];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = ty + 16 * i;
    lse_r[i] = r < q_rows ? lse[row_base + r] : 0.f;
    delta_r[i] = r < q_rows ? delta[row_base + r] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int kv_tiles = kCausal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < kv_tiles; ++kt) {
    const int k0 = kt * kTile;
    const int kv_rows = min(kTile, seq - k0);
    __syncthreads();
    load_tile<D>(k_sm, k + kv_base + (size_t)k0 * D, kv_rows);
    load_tile<D>(v_sm, v + kv_base + (size_t)k0 * D, kv_rows);
    __syncthreads();

    float s[kSub][kSub], dp[kSub][kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[kSub], g[kSub], kk[kSub], vv[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        a[i] = q_sm[(ty + 16 * i) * kLd + d];
        g[i] = do_sm[(ty + 16 * i) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        kk[j] = k_sm[(tx + 16 * j) * kLd + d];
        vv[j] = v_sm[(tx + 16 * j) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          s[i][j] = fmaf(a[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
        }
    }

    const bool diag = kCausal && kt == qt;
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int c = tx + 16 * j;
        const bool keep = c < kv_rows && (!diag || c <= r);
        const float p = keep ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        const float ds = (p * (dp[i][j] - delta_r[i])) * scale;
        ds_sm[r * kLdP + c] = ds;
      }
    }
    __syncthreads();

    // acc += dS K
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float ds[kSub], kk[kCols];
#pragma unroll
      for (int i = 0; i < kSub; ++i) ds[i] = ds_sm[(ty + 16 * i) * kLdP + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kk[c] = k_sm[j * kLd + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(ds[i], kk[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_rows) continue;
    float* row = dq + (row_base + r) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) row[tx + 16 * c] = acc[i][c];
  }
}

// -- K3: dK and dV -------------------------------------------------------------

template <int D>
constexpr size_t dkv_smem() {  // k, v, q, dO tiles + p^T, ds^T + lse, delta
  return (4 * tile_floats<D>() + 2 * kTile * kLdP + 2 * kTile) *
         sizeof(float);
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int hq,
                     int group, int seq, float scale) {
  constexpr int kLd = D + 1;
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* k_sm = smem;
  float* v_sm = k_sm + tile_floats<D>();
  float* q_sm = v_sm + tile_floats<D>();
  float* do_sm = q_sm + tile_floats<D>();
  float* pt_sm = do_sm + tile_floats<D>();   // [key row][query row]
  float* dst_sm = pt_sm + kTile * kLdP;      // [key row][query row]
  float* lse_sm = dst_sm + kTile * kLdP;
  float* delta_sm = lse_sm + kTile;

  const int n_tiles = (seq + kTile - 1) / kTile;
  const int kt = blockIdx.x;  // longest causal sweeps (kt = 0) first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = hq / group;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int k0 = kt * kTile;
  const int kv_rows = min(kTile, seq - k0);
  const size_t kv_row_base = ((size_t)b * hkv + hk) * seq + k0;

  load_tile<D>(k_sm, k + kv_row_base * D, kv_rows);
  load_tile<D>(v_sm, v + kv_row_base * D, kv_rows);
  float dk_acc[kSub][kCols], dv_acc[kSub][kCols];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int g = 0; g < group; ++g) {
    const size_t head_base = ((size_t)b * hq + hk * group + g) * seq;
    for (int qt = kCausal ? kt : 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kTile;
      const int q_rows = min(kTile, seq - q0);
      __syncthreads();  // the previous tile's readers are done
      load_tile<D>(q_sm, q + (head_base + q0) * D, q_rows);
      load_tile<D>(do_sm, dout + (head_base + q0) * D, q_rows);
      if (threadIdx.x < kTile) {
        const bool in = threadIdx.x < q_rows;
        lse_sm[threadIdx.x] = in ? lse[head_base + q0 + threadIdx.x] : 0.f;
        delta_sm[threadIdx.x] =
            in ? delta[head_base + q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();

      // Transposed tiles: rows are keys (ty + 16 i), columns queries.
      float s[kSub][kSub], dpt[kSub][kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) s[i][j] = dpt[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float kk[kSub], vv[kSub], a[kSub], gg[kSub];
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          kk[i] = k_sm[(ty + 16 * i) * kLd + d];
          vv[i] = v_sm[(ty + 16 * i) * kLd + d];
        }
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          a[j] = q_sm[(tx + 16 * j) * kLd + d];
          gg[j] = do_sm[(tx + 16 * j) * kLd + d];
        }
#pragma unroll
        for (int i = 0; i < kSub; ++i)
#pragma unroll
          for (int j = 0; j < kSub; ++j) {
            s[i][j] = fmaf(kk[i], a[j], s[i][j]);
            dpt[i][j] = fmaf(vv[i], gg[j], dpt[i][j]);
          }
      }

      const bool diag = kCausal && qt == kt;
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int c = ty + 16 * i;  // key row
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          const int r = tx + 16 * j;  // query row
          const bool keep = r < q_rows && (!diag || c <= r);
          const float p = keep ? expf(s[i][j] * scale - lse_sm[r]) : 0.f;
          const float ds = (p * (dpt[i][j] - delta_sm[r])) * scale;
          pt_sm[c * kLdP + r] = p;
          dst_sm[c * kLdP + r] = ds;
        }
      }
      __syncthreads();

      // dv += P^T dO ; dk += dS^T Q
#pragma unroll 2
      for (int r = 0; r < kTile; ++r) {
        float p[kSub], ds[kSub], gg[kCols], a[kCols];
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          p[i] = pt_sm[(ty + 16 * i) * kLdP + r];
          ds[i] = dst_sm[(ty + 16 * i) * kLdP + r];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          gg[c] = do_sm[r * kLd + tx + 16 * c];
          a[c] = q_sm[r * kLd + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < kSub; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            dv_acc[i][c] = fmaf(p[i], gg[c], dv_acc[i][c]);
            dk_acc[i][c] = fmaf(ds[i], a[c], dk_acc[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int c = ty + 16 * i;
    if (c >= kv_rows) continue;
    float* dk_row = dk + (kv_row_base + c) * D;
    float* dv_row = dv + (kv_row_base + c) * D;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      dk_row[tx + 16 * cc] = dk_acc[i][cc];
      dv_row[tx + 16 * cc] = dv_acc[i][cc];
    }
  }
}

// -- launches ------------------------------------------------------------------

using sm90::allow_smem;
using sm90::bf16;

struct Shape {
  int batch, hq, hkv, seq;
  float scale;
};

// bf16 runs the tensor-core kernels (sm90::), fp32 the CUDA-core ones.
template <typename T, int D, bool kCausal>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, void* counter, Shape s,
                       cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return sm90::launch_fwd<D, kCausal>(q, k, v, o, lse, counter, s.batch,
                                        s.hq, s.hkv, s.seq, s.scale, stream);
  } else {
    const dim3 grid((s.seq + kTile - 1) / kTile, s.hq, s.batch);
    const int group = s.hq / s.hkv;
    auto kernel = flash_fwd_kernel<D, kCausal>;
    cudaError_t err = allow_smem(kernel, fwd_smem<D>());
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, fwd_smem<D>(), stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(lse), s.hq, group, s.seq, s.scale);
  }
  return cudaGetLastError();
}

template <typename T, int D, bool kCausal>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, void* counter, Shape s, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return sm90::launch_dq<D, kCausal>(q, k, v, dout, lse, delta, dq, counter,
                                       s.batch, s.hq, s.hkv, s.seq, s.scale,
                                       stream);
  } else {
    const dim3 grid((s.seq + kTile - 1) / kTile, s.hq, s.batch);
    const int group = s.hq / s.hkv;
    auto kernel = flash_bwd_dq_kernel<D, kCausal>;
    cudaError_t err = allow_smem(kernel, dq_smem<D>());
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, dq_smem<D>(), stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq), s.hq, group, s.seq, s.scale);
  }
  return cudaGetLastError();
}

template <typename T, int D, bool kCausal>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, void* counter, Shape s,
                       cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return sm90::launch_dkv<D, kCausal>(q, k, v, dout, lse, delta, dk, dv,
                                        counter, s.batch, s.hq, s.hkv, s.seq,
                                        s.scale, stream);
  } else {
    const dim3 grid((s.seq + kTile - 1) / kTile, s.hkv, s.batch);
    const int group = s.hq / s.hkv;
    auto kernel = flash_bwd_dkv_kernel<D, kCausal>;
    cudaError_t err = allow_smem(kernel, dkv_smem<D>());
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, dkv_smem<D>(), stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv), s.hq, group,
        s.seq, s.scale);
  }
  return cudaGetLastError();
}

template <typename T>
struct Type {
  using type = T;
};

// Calls f(Type<T>{}, integral_constant<int, D>{}, integral_constant<bool,
// causal>{}) for the runtime element type, head_dim and causal flag.
template <typename F>
cudaError_t dispatch(int dtype, int head_dim, int causal, F f) {
  auto by_dim = [&](auto t) -> cudaError_t {
    auto by_causal = [&](auto d) -> cudaError_t {
      if (causal) return f(t, d, std::integral_constant<bool, true>{});
      return f(t, d, std::integral_constant<bool, false>{});
    };
    if (head_dim == 64) return by_causal(std::integral_constant<int, 64>{});
    if (head_dim == 128) return by_causal(std::integral_constant<int, 128>{});
    return cudaErrorInvalidValue;
  };
  if (dtype == 0) return by_dim(Type<float>{});
  if (dtype == 1) return by_dim(Type<__nv_bfloat16>{});
  return cudaErrorInvalidValue;
}

bool valid(Shape s) {
  return s.batch >= 1 && s.batch <= 65535 && s.hkv >= 1 && s.hq >= s.hkv &&
         s.hq <= 65535 && s.hq % s.hkv == 0 && s.seq >= 1;
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (q, k, v, o, dO, dq). Each returns the
// cudaError_t of its launch (0 = launched).
// counter (bf16 only; the fp32 bodies ignore it): one int32 in device
// memory, zero, which no other launch uses at the same time; the kernel
// takes its work tiles from it and leaves it zero.
extern "C" int skytorch_flash_fwd(int dtype, int causal, const void* q,
                                  const void* k, const void* v, void* o,
                                  void* lse, void* counter, int batch,
                                  int hq, int hkv, int seq, int head_dim,
                                  float scale, void* stream) {
  const Shape s{batch, hq, hkv, seq, scale};
  if (!valid(s)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, head_dim, causal, [&](auto t, auto d, auto c) {
    using T = typename decltype(t)::type;
    return launch_fwd<T, decltype(d)::value, decltype(c)::value>(
        q, k, v, o, lse, counter, s, st);
  });
}

extern "C" int skytorch_flash_bwd_dq(int dtype, int causal, const void* q,
                                     const void* k, const void* v,
                                     const void* dout, const void* lse,
                                     const void* delta, void* dq,
                                     void* counter, int batch, int hq,
                                     int hkv, int seq, int head_dim,
                                     float scale, void* stream) {
  const Shape s{batch, hq, hkv, seq, scale};
  if (!valid(s)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, head_dim, causal, [&](auto t, auto d, auto c) {
    using T = typename decltype(t)::type;
    return launch_dq<T, decltype(d)::value, decltype(c)::value>(
        q, k, v, dout, lse, delta, dq, counter, s, st);
  });
}

extern "C" int skytorch_flash_bwd_dkv(int dtype, int causal, const void* q,
                                      const void* k, const void* v,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dk, void* dv,
                                      void* counter, int batch, int hq,
                                      int hkv, int seq, int head_dim,
                                      float scale, void* stream) {
  const Shape s{batch, hq, hkv, seq, scale};
  if (!valid(s)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, head_dim, causal, [&](auto t, auto d, auto c) {
    using T = typename decltype(t)::type;
    return launch_dkv<T, decltype(d)::value, decltype(c)::value>(
        q, k, v, dout, lse, delta, dk, dv, counter, s, st);
  });
}

// The bf16 bodies' launch at this shape (sm90::plan): out[7] = {blocks,
// SMs, query rows a tile, keys a tile, ring stages, shared memory bytes,
// units of a section of the work list} of kernel 0 (K1), 1 (K2) or 2 (K3).
extern "C" int skytorch_flash_plan(int kernel, int head_dim, int batch,
                                   int hq, int hkv, int seq, int* out) {
  const Shape s{batch, hq, hkv, seq, 1.f};
  if (!valid(s) || kernel < 0 || kernel > 2) return cudaErrorInvalidValue;
  if (head_dim == 64) {
    sm90::plan<64>(kernel, batch, hq, hkv, seq, out);
  } else if (head_dim == 128) {
    sm90::plan<128>(kernel, batch, hq, hkv, seq, out);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

extern "C" const char* skytorch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
