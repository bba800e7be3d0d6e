// Flash-decode for Hopper (sm_90a): one new query token per row attends
// over that row's KV cache, with the cache split across blocks.
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
//   part     fp32 scratch, B * Hkv * splits * G * (D + 2): the partials
//
// Bound: memory. Each (row, kv head) reads its K and V rows up to
// lengths[b] (plus the scales in int8 mode) once and does 4*G*D flops per
// position, G = 1..4 for the presets: about one flop per byte, far below
// the ~295 flops per byte where the H100 stops being bound by its 3.35 TB/s.
// So the least time is (K/V/scale bytes up to lengths) / bandwidth, and
// the kernel's job is to keep enough loads in flight on every SM.
//
// Design against that bound (one call = two kernels on one stream):
//  * decode_split_kernel, grid (splits, Hkv, B): block (c, h, b) walks the
//    positions [c * chunk, (c + 1) * chunk) of row b's kv head h for all G
//    query heads of the group, so the G heads read the cache once. The
//    chunk is chosen on the host from (B, Hkv, M) alone
//    (ops/decode_attention.py decode_split), never from the lengths, so no
//    launch reads them back; it is enough chunks that a small batch
//    spreads over the card (B=1, M=1024: 8 kv heads x 8 chunks of 128
//    positions; B=32: 8 x 32 x 4 chunks of 256). A block's work stops at
//    lengths[b]: the bytes read are the bytes the row needs, never all of M.
//  * inside a block, four warps; a lane owns 8 elements (4 in fp32) of one
//    position's K and V rows, so at D = 128 a bf16 position is 16 lanes
//    and a warp step two positions of contiguous 512 bytes. Loads go by
//    cp.async into a 3-stage ring of 32-position tiles in shared memory,
//    so two tiles are in flight while one is computed; each thread reads
//    back only what it copied, so the ring needs no block barrier. q.k is
//    fp32 FMAs on the lane's elements, converted from bf16 or int8 in
//    registers, then a butterfly of shuffles over the position's lanes;
//    P.V adds p times the lane's V elements into its own fp32 sums. No
//    tile is converted to fp32 in shared memory.
//  * online softmax per warp: one max and one rescale per tile; at the end
//    the warps merge in shared memory and the block writes a partial (m,
//    l, acc[G][D], fp32).
//  * decode_combine_kernel, grid (Hkv, B): merges the partials of a row
//    with log-sum-exp weights exp(m_c - max m) and writes
//    out = sum w acc / max(sum w l, 1e-30) in T.
// The roundings are the TPU kernel's: probabilities relative to the
// running max, value scales folded into p in int8 mode, p rounded to q's
// type before P.V.
//
// Two markers are kept apart:
//  * masked but counted: an empty row (lengths[b] <= 0) follows the plain
//    version, every position < M at the same -1e30 logit, so its chunks
//    span all of M and the output is the mean of V over M;
//  * absent: positions at or past a row's length get -inf (weight exactly
//    0), and a chunk that starts there writes m = -inf, l = 0 and no acc;
//    the merge gives it weight 0 and never reads its acc.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;      // cache positions per block per ring stage
constexpr int kStages = 3;
constexpr int kMaxGroup = 8;      // query heads per kv head
constexpr float kMasked = -1e30f;  // the plain version's masked logit

// What a lane loads of one cache row, and its conversion to fp32.
template <typename C>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {  // 8 elements, 16 bytes
  using Raw = uint4;
  static constexpr int kN = 8;
  __device__ static void unpack(const Raw& r, float (&f)[kN]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Vec<int8_t> {  // 8 codes, 8 bytes
  using Raw = uint2;
  static constexpr int kN = 8;
  __device__ static void unpack(const Raw& r, float (&f)[kN]) {
    const uint32_t w[2] = {r.x, r.y};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      f[i] = static_cast<float>(
          static_cast<int32_t>(w[i / 4] << (24 - 8 * (i % 4))) >> 24);
  }
};

template <>
struct Vec<float> {  // 4 elements, 16 bytes
  using Raw = uint4;
  static constexpr int kN = 4;
  __device__ static void unpack(const Raw& r, float (&f)[kN]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copy `Bytes` from global to shared memory asynchronously; when !valid
// nothing is read and the destination is zero-filled.
template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? Bytes : 0;
  if constexpr (Bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(Bytes), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The lane layout of one cache type and head width.
template <typename C, bool kQuant, int kD, int kG>
struct Split {
  using V = Vec<C>;
  using Raw = typename V::Raw;
  static constexpr int kVec = V::kN;                  // elements per lane
  static constexpr int kLanes = kD / kVec;            // lanes per position
  static constexpr int kPosPerStep = 32 / kLanes;     // per warp step
  static constexpr int kSteps = kTile / (kWarps * kPosPerStep);  // per tile
  static constexpr int kSlots = kStages * kSteps * kThreads;     // ring
  static_assert(kLanes <= 32 && kSteps * kWarps * kPosPerStep == kTile,
                "a tile must split evenly over the warps");
  static constexpr size_t kRingBytes =
      kSlots * (2 * sizeof(Raw) + (kQuant ? 2 * sizeof(float) : 0));
  static constexpr size_t kMergeBytes =
      (2 * kWarps * kG + kWarps * kG * kD) * sizeof(float);
  static constexpr size_t kSmem =
      kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes;
};

// Partials: acc [B * Hkv * splits, G, D], then m and l [B * Hkv * splits, G].
template <typename F>  // float, or const float for the merge
struct Partials {
  F* acc;
  F* m;
  F* l;
  __device__ Partials(F* part, size_t n_blocks, int group, int d)
      : acc(part),
        m(part + n_blocks * group * d),
        l(part + n_blocks * group * d + n_blocks * group) {}
};

template <typename T, typename C, bool kQuant, int kD, int kG>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const C* __restrict__ k,
                    const C* __restrict__ v, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ lengths, float* __restrict__ part,
                    int hkv, int group, int max_len, int chunk,
                    float scale) {
  using S = Split<C, kQuant, kD, kG>;
  using Raw = typename S::Raw;
  constexpr int kVec = S::kVec;
  constexpr int kLanes = S::kLanes;
  constexpr int kSteps = S::kSteps;
  extern __shared__ __align__(16) uint8_t smem[];
  Raw* k_ring = reinterpret_cast<Raw*>(smem);
  Raw* v_ring = k_ring + S::kSlots;
  float* ks_ring = reinterpret_cast<float*>(v_ring + S::kSlots);
  float* vs_ring = ks_ring + S::kSlots;

  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t head = (size_t)b * hkv + h;
  const size_t blk = head * gridDim.x + c;
  const Partials<float> out(part, (size_t)gridDim.z * hkv * gridDim.x,
                            group, kD);
  const float minus_inf = __int_as_float(0xff800000);

  const int len = lengths[b];
  const bool empty = len <= 0;
  const int span = empty ? max_len : min(len, max_len);
  const int start = c * chunk;
  if (start >= span) {  // absent chunk: weight 0 in the merge
    if (tid < group) {
      out.m[blk * group + tid] = minus_inf;
      out.l[blk * group + tid] = 0.f;
    }
    return;
  }
  const int end = min(start + chunk, span);
  const int n_tiles = (end - start + kTile - 1) / kTile;

  const int col = (lane % kLanes) * kVec;  // this lane's columns
  const int slot = lane / kLanes;          // its position in a warp step
  const C* kh = k + head * max_len * kD + col;
  const C* vh = v + head * max_len * kD + col;
  const float* ksh = kQuant ? k_scale + head * max_len : nullptr;
  const float* vsh = kQuant ? v_scale + head * max_len : nullptr;
  auto position = [&](int tile, int step) {
    return start + tile * kTile + (warp * kSteps + step) * S::kPosPerStep +
           slot;
  };
  // Issue this thread's copies of one tile into its ring stage; positions
  // at or past `end` are zero-filled and never read from memory.
  auto issue = [&](int tile) {
    const int st = tile % kStages;
#pragma unroll
    for (int step = 0; step < kSteps; ++step) {
      const int pos = position(tile, step);
      const bool ok = pos < end;
      const size_t src = ok ? pos : start;
      const int i = (st * kSteps + step) * kThreads + tid;
      cp_async<sizeof(Raw)>(&k_ring[i], kh + src * kD, ok);
      cp_async<sizeof(Raw)>(&v_ring[i], vh + src * kD, ok);
      if (kQuant) {
        cp_async<4>(&ks_ring[i], ksh + src, ok);
        cp_async<4>(&vs_ring[i], vsh + src, ok);
      }
    }
  };
#pragma unroll
  for (int tile = 0; tile < kStages - 1; ++tile) {
    if (tile < n_tiles) issue(tile);
    cp_commit();
  }

  // This lane's columns of the group's queries; heads past the group (kG
  // rounds it up to a power of two) are zero and never written.
  float qf[kG][kVec];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      qf[g][e] = g < group ? to_float(q[(head * group + g) * kD + col + e])
                           : 0.f;
  float m[kG], l[kG], acc[kG][kVec];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = kMasked;
    l[g] = 0.f;  // this lane's positions only, until the end
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + kStages - 1 < n_tiles) issue(tile + kStages - 1);
    cp_commit();
    cp_wait<kStages - 1>();  // this thread's copies of `tile` landed
    const int st = tile % kStages;

    // Logits of this lane's positions.
    float s[kSteps][kG];
#pragma unroll
    for (int step = 0; step < kSteps; ++step) {
      const int i = (st * kSteps + step) * kThreads + tid;
      float kf[kVec];
      S::V::unpack(k_ring[i], kf);
      float dot[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        dot[g] = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) dot[g] = fmaf(qf[g][e], kf[e], dot[g]);
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off /= 2)
#pragma unroll
        for (int g = 0; g < kG; ++g)
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
      const int pos = position(tile, step);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float x = dot[g] * scale;
        if (kQuant) x *= ks_ring[i];
        s[step][g] = pos >= end ? minus_inf : empty ? kMasked : x;
      }
    }

    // One max and one rescale per tile, over the warp's positions.
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int step = 1; step < kSteps; ++step) mx = fmaxf(mx, s[step][g]);
#pragma unroll
      for (int off = kLanes; off < 32; off *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      m[g] = m_new;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[g][e] *= alpha;
    }

    // acc += P V; p enters in q's type, with the value scale folded in.
#pragma unroll
    for (int step = 0; step < kSteps; ++step) {
      const int i = (st * kSteps + step) * kThreads + tid;
      float vf[kVec];
      S::V::unpack(v_ring[i], vf);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float p = expf(s[step][g] - m[g]);
        l[g] += p;
        if (kQuant) p *= vs_ring[i];
        p = to_float(from_float<T>(p));
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }

  // Sum the warp's position slots, then merge the warps.
#pragma unroll
  for (int off = kLanes; off < 32; off *= 2)
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
    }
  cp_wait<0>();
  __syncthreads();  // every warp is done with the ring: it becomes scratch
  float* m_sm = reinterpret_cast<float*>(smem);  // [kWarps][kG]
  float* l_sm = m_sm + kWarps * kG;              // [kWarps][kG]
  float* acc_sm = l_sm + kWarps * kG;            // [kWarps][kG][kD]
  if (slot == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        acc_sm[(warp * kG + g) * kD + col + e] = acc[g][e];
      if (col == 0) {
        m_sm[warp * kG + g] = m[g];
        l_sm[warp * kG + g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < group * kD; idx += kThreads) {
    const int g = idx / kD;
    float mx = m_sm[g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, m_sm[w * kG + g]);
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(m_sm[w * kG + g] - mx);
      sum = fmaf(wt, l_sm[w * kG + g], sum);
      a = fmaf(wt, acc_sm[(w * kG + g) * kD + idx % kD], a);
    }
    out.acc[blk * group * kD + idx] = a;
    if (idx % kD == 0) {
      out.m[blk * group + g] = mx;
      out.l[blk * group + g] = sum;
    }
  }
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                      int hkv, int group, int splits) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t head = (size_t)b * hkv + h;
  const Partials<const float> in(part, (size_t)gridDim.y * hkv * splits,
                                 group, kD);
  const size_t blk0 = head * splits;
  T* oh = out + head * group * kD;
  for (int idx = threadIdx.x; idx < group * kD; idx += kThreads) {
    const int g = idx / kD;
    float mx = __int_as_float(0xff800000);
    for (int c = 0; c < splits; ++c)
      mx = fmaxf(mx, in.m[(blk0 + c) * group + g]);
    float sum = 0.f, a = 0.f;
    for (int c = 0; c < splits; ++c) {
      const float w = expf(in.m[(blk0 + c) * group + g] - mx);
      if (w > 0.f) {  // absent chunks (m = -inf) wrote no acc
        sum = fmaf(w, in.l[(blk0 + c) * group + g], sum);
        a = fmaf(w, in.acc[(blk0 + c) * group * kD + idx], a);
      }
    }
    oh[idx] = from_float<T>(a / fmaxf(sum, 1e-30f));
  }
}

template <typename T, typename C, bool kQuant, int kD, int kG>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_s, const void* v_s, const void* lengths,
                   void* out, void* part, int batch, int hkv, int group,
                   int max_len, int chunk, float scale, cudaStream_t stream) {
  using S = Split<C, kQuant, kD, kG>;
  const int splits = (max_len + chunk - 1) / chunk;
  auto split = decode_split_kernel<T, C, kQuant, kD, kG>;
  if (S::kSmem > 48 * 1024) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
    if (attr != cudaSuccess) return attr;
  }
  split<<<dim3(splits, hkv, batch), kThreads, S::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(k),
      static_cast<const C*>(v), static_cast<const float*>(k_s),
      static_cast<const float*>(v_s), static_cast<const int*>(lengths),
      static_cast<float*>(part), hkv, group, max_len, chunk, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, kD><<<dim3(hkv, batch), kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), hkv, group,
      splits);
  return cudaGetLastError();
}

template <int V>
using Int = std::integral_constant<int, V>;

// Calls f(Int<D>{}, Int<kG>{}) with kG the group rounded up to a power of
// two (the extra heads are zero and never written).
template <typename F>
cudaError_t dispatch(int head_dim, int group, F f) {
  auto by_group = [&](auto d) -> cudaError_t {
    if (group <= 1) return f(d, Int<1>{});
    if (group <= 2) return f(d, Int<2>{});
    if (group <= 4) return f(d, Int<4>{});
    return f(d, Int<8>{});
  };
  if (head_dim == 64) return by_group(Int<64>{});
  if (head_dim == 128) return by_group(Int<128>{});
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (q, out, and the cache unless quantized).
// chunk: cache positions per block, a multiple of 32; part: fp32 scratch of
// B * Hkv * ceil(M / chunk) * G * (D + 2). Launches the split and the
// combine kernels and returns the first cudaError_t of the two (0 =
// launched).
extern "C" int skytorch_flash_decode(int dtype, int quantized, const void* q,
                                     const void* k, const void* v,
                                     const void* k_s, const void* v_s,
                                     const void* lengths, void* out,
                                     void* part, int batch, int hkv,
                                     int group, int max_len, int head_dim,
                                     int chunk, float scale, void* stream) {
  if (batch < 1 || batch > 65535 || hkv < 1 || hkv > 65535 || group < 1 ||
      group > kMaxGroup || max_len < 1 || chunk < kTile || chunk % kTile)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(head_dim, group, [&](auto d, auto g) -> cudaError_t {
    constexpr int kD = decltype(d)::value;
    constexpr int kG = decltype(g)::value;
    if (dtype == 0) {
      return quantized
          ? launch<float, int8_t, true, kD, kG>(q, k, v, k_s, v_s, lengths,
                                                out, part, batch, hkv, group,
                                                max_len, chunk, scale, s)
          : launch<float, float, false, kD, kG>(q, k, v, k_s, v_s, lengths,
                                                out, part, batch, hkv, group,
                                                max_len, chunk, scale, s);
    }
    if (dtype == 1) {
      return quantized
          ? launch<__nv_bfloat16, int8_t, true, kD, kG>(
                q, k, v, k_s, v_s, lengths, out, part, batch, hkv, group,
                max_len, chunk, scale, s)
          : launch<__nv_bfloat16, __nv_bfloat16, false, kD, kG>(
                q, k, v, k_s, v_s, lengths, out, part, batch, hkv, group,
                max_len, chunk, scale, s);
    }
    return cudaErrorInvalidValue;
  });
}

extern "C" const char* skytorch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
