// Swin attention softmax with the relative-position bias and shift mask added,
// for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the Pallas kernel of rba_tpu/ops/pallas/masked_softmax.py
// (masked_softmax_bf16: _kernel with a mask, _kernel_nomask without).  For each
// row i of window w and head h:
//     out[w, h, i, :] = softmax(s[w, h, i, :] + rel_bias[h, i, :] + mask[w % nW, i, :])
// The adds are fp32 in that order, the max-subtracted softmax is fp32 with
// expf (not __expf) and the correctly rounded quotient by the row sum, as
// jax.nn.softmax gives, and the probability is rounded once to the output type
// (bf16 or fp32) when it is stored.
//
// Bound on the H100: bytes.  At Swin-B 1024x2048 stage 0 one call reads 314 MB
// of fp32 scores and writes 157 MB of bf16 probabilities, plus 78 MB of fp32
// mask when shifted (0.14-0.16 ms at 3.35 TB/s), for a few operations per
// element.  What the design does about it:
//   - A warp keeps one (head, row i) and walks the windows, so rel_bias[h, i, :]
//     is loaded into registers once per warp and not once per window.  The grid
//     is a few waves of resident blocks: blockIdx.x names the row and the group
//     of heads, blockIdx.y a group of windows.
//   - The warps of a block hold the heads of one row and walk the same windows,
//     so the mask row mask[w % nW, i, :], which all heads of a window share, is
//     read from L2 by one of them and from L1 by the others.  Without a mask
//     nothing is read for it.
//   - Where N % 4 == 0 and the tensors are 16-byte aligned, a lane holds 4
//     consecutive keys of the first 128 (one 16-byte load, one 8-byte bf16 or
//     16-byte fp32 store) and one key of the rest, so N = 144 keeps 90 % of a
//     warp's lanes busy; scores and probabilities stream past L1.  Any other
//     N <= 160 takes the scalar layout (lane l holds keys l, l + 32, ...).  The
//     launch picks the layout from the shape and the pointers.
//   - kUnroll windows are in flight per warp: the loads of all of them are
//     started before the first reduction.
//   - One reciprocal per row and the one-fma residual correction give each
//     quotient correctly rounded without a division per element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarps = 8;    // warps per block: heads of one row x lanes of windows
constexpr int kUnroll = 2;   // windows in flight per warp
constexpr int kWaves = 4;    // waves of resident blocks in the grid
constexpr int kMaxTokens = 160;
constexpr int kMaxDevices = 64;  // cards whose resident-block count is remembered

// e / sum, correctly rounded, from r = 1 / sum (itself correctly rounded): one fma
// step on the exact residual e - sum (e r) rounds e r to the quotient (Markstein's
// theorem) wherever the quotient is a normal float.  Below 2^-126, where the
// shift mask's -100 sends a probability, it may be one subnormal fp32 ulp off.
__device__ __forceinline__ float quotient(float e, float sum, float r) {
  const float q = e * r;
  return fmaf(fmaf(-sum, q, e), r, q);
}

// The keys of one row that a lane holds, 5 in both layouts.  VEC: the 4 consecutive
// keys 4 lane .. 4 lane + 3 and key 128 + lane (N = 144 fills 144 of a warp's 160
// slots).  Scalar: keys lane, lane + 32, ..., lane + 128.
template <bool VEC>
struct Lane {
  static constexpr int KEYS = 5;
  // row[key(e)] into v[e], `pad` where the key is beyond n; STREAM reads past L1
  template <bool STREAM>
  static __device__ __forceinline__ void load(float (&v)[KEYS], const float* __restrict__ row, int lane, int n,
                                              float pad) {
    if constexpr (VEC) {
      float4 x = make_float4(pad, pad, pad, pad);
      if (4 * lane < n) x = STREAM ? __ldcs(reinterpret_cast<const float4*>(row) + lane)
                                   : __ldg(reinterpret_cast<const float4*>(row) + lane);
      v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
      v[4] = 128 + lane < n ? (STREAM ? __ldcs(row + 128 + lane) : __ldg(row + 128 + lane)) : pad;
    } else {
#pragma unroll
      for (int e = 0; e < KEYS; ++e) {
        const int j = lane + 32 * e;
        v[e] = j < n ? (STREAM ? __ldcs(row + j) : __ldg(row + j)) : pad;
      }
    }
  }
  static __device__ __forceinline__ void store(float* __restrict__ row, const float (&v)[KEYS], int lane, int n) {
    if constexpr (VEC) {
      if (4 * lane < n) __stcs(reinterpret_cast<float4*>(row) + lane, make_float4(v[0], v[1], v[2], v[3]));
      if (128 + lane < n) __stcs(row + 128 + lane, v[4]);
    } else {
#pragma unroll
      for (int e = 0; e < KEYS; ++e)
        if (lane + 32 * e < n) row[lane + 32 * e] = v[e];
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* __restrict__ row, const float (&v)[KEYS], int lane, int n) {
    if constexpr (VEC) {
      if (4 * lane < n) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
        uint2 p;
        p.x = *reinterpret_cast<const uint32_t*>(&lo);
        p.y = *reinterpret_cast<const uint32_t*>(&hi);
        __stcs(reinterpret_cast<uint2*>(row) + lane, p);
      }
      if (128 + lane < n) row[128 + lane] = __float2bfloat16(v[4]);
    } else {
#pragma unroll
      for (int e = 0; e < KEYS; ++e)
        if (lane + 32 * e < n) row[lane + 32 * e] = __float2bfloat16(v[e]);
    }
  }
};

// Block: kWarps warps = hpb heads of row i x (kWarps / hpb) lanes of windows.
// blockIdx.x = i * head_groups + head group; blockIdx.y = group of window lanes.
template <typename T, bool VEC, bool MASKED>
__global__ void __launch_bounds__(32 * kWarps)
masked_softmax_walk_kernel(const float* __restrict__ scores, const float* __restrict__ rel_bias,
                           const float* __restrict__ mask, T* __restrict__ out,
                           int bw, int n, int nh, int n_mask, int hpb) {
  using L = Lane<VEC>;
  constexpr int KEYS = L::KEYS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int head_groups = (nh + hpb - 1) / hpb;
  const int i = blockIdx.x / head_groups;
  const int head = (blockIdx.x % head_groups) * hpb + warp % hpb;
  if (head >= nh) return;
  const int subs = kWarps / hpb;
  const int stride = gridDim.y * subs;  // window lanes of the whole grid
  const size_t row_len = (size_t)n;

  float bias[KEYS];
  L::template load<false>(bias, rel_bias + ((size_t)head * n + i) * row_len, lane, n, 0.f);

  for (int w0 = blockIdx.y * subs + warp / hpb; w0 < bw; w0 += kUnroll * stride) {
    float v[kUnroll][KEYS];
    // every load of the kUnroll rows first; a padded key holds -inf and so adds 0 to the sum
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = w0 + u * stride;
      if (w < bw) {
        L::template load<true>(v[u], scores + (((size_t)w * nh + head) * n + i) * row_len, lane, n, -INFINITY);
      } else {
#pragma unroll
        for (int e = 0; e < KEYS; ++e) v[u][e] = 0.f;
      }
    }
    if constexpr (MASKED) {
      float m[kUnroll][KEYS];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int w = min(w0 + u * stride, bw - 1);
        L::template load<false>(m[u], mask + ((size_t)(w % n_mask) * n + i) * row_len, lane, n, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int e = 0; e < KEYS; ++e) v[u][e] = (v[u][e] + bias[e]) + m[u][e];
    } else {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int e = 0; e < KEYS; ++e) v[u][e] += bias[e];
    }

    float mx[kUnroll], sum[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      mx[u] = v[u][0];
#pragma unroll
      for (int e = 1; e < KEYS; ++e) mx[u] = fmaxf(mx[u], v[u][e]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], o));
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      sum[u] = 0.f;
#pragma unroll
      for (int e = 0; e < KEYS; ++e) {
        v[u][e] = expf(v[u][e] - mx[u]);
        sum[u] += v[u][e];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], o);

#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = w0 + u * stride;
      if (w >= bw) break;
      const float r = __frcp_rn(sum[u]);
#pragma unroll
      for (int e = 0; e < KEYS; ++e) v[u][e] = quotient(v[u][e], sum[u], r);
      L::store(out + (((size_t)w * nh + head) * n + i) * row_len, v[u], lane, n);
    }
  }
}

template <typename T, bool VEC, bool MASKED>
int launch(const float* scores, const float* rel_bias, const float* mask, void* out, int bw, int n, int nh,
           int n_mask, cudaStream_t stream) {
  auto kernel = masked_softmax_walk_kernel<T, VEC, MASKED>;
  // blocks the current card holds at once, asked once per card and instantiation
  static std::atomic<int> remembered[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int resident = dev < kMaxDevices ? remembered[dev].load(std::memory_order_relaxed) : 0;
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * kWarps, 0);
    if (err != cudaSuccess) return (int)err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < kMaxDevices) remembered[dev].store(resident, std::memory_order_relaxed);
  }
  const int hpb = nh >= 8 ? 8 : nh >= 4 ? 4 : nh >= 2 ? 2 : 1;  // heads per block, a divisor of kWarps
  const int subs = kWarps / hpb;
  const long long gx = (long long)n * ((nh + hpb - 1) / hpb);
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // window groups: blocks for at most kWaves whole waves, and no more than there are windows to walk
  long long gy = kWaves * (long long)resident / gx;
  const long long most = ((long long)bw + subs - 1) / subs;
  if (gy > most) gy = most;
  if (gy > 65535) gy = 65535;
  if (gy < 1) gy = 1;
  kernel<<<dim3((unsigned)gx, (unsigned)gy), 32 * kWarps, 0, stream>>>(
      scores, rel_bias, mask, static_cast<T*>(out), bw, n, nh, n_mask, hpb);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const float* scores, const float* rel_bias, const float* mask, void* out, int bw, int n, int nh,
             int n_mask, cudaStream_t s) {
  // 4 keys per load where every row of every tensor starts on 16 bytes (8 for bf16 output)
  const uintptr_t ptrs = (uintptr_t)scores | (uintptr_t)rel_bias | (uintptr_t)mask | (uintptr_t)out;
  const bool vec = n % 4 == 0 && ptrs % 16 == 0;
  if (vec)
    return mask ? launch<T, true, true>(scores, rel_bias, mask, out, bw, n, nh, n_mask, s)
                : launch<T, true, false>(scores, rel_bias, mask, out, bw, n, nh, n_mask, s);
  return mask ? launch<T, false, true>(scores, rel_bias, mask, out, bw, n, nh, n_mask, s)
              : launch<T, false, false>(scores, rel_bias, mask, out, bw, n, nh, n_mask, s);
}

}  // namespace

extern "C" {

const char* rba_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// scores (bw, nh, n, n) fp32; rel_bias (nh, n, n) fp32; mask (n_mask, n, n) fp32 or
// null, window w taking mask[w % n_mask]; out (bw, nh, n, n) bf16 (out_bf16 = 1) or
// fp32.  Returns a cudaError_t.
int rba_masked_softmax(const float* scores, const float* rel_bias, const float* mask, void* out,
                       int bw, int nh, int n, int n_mask, int out_bf16, void* stream) {
  if (n < 1 || n > kMaxTokens || bw < 1 || nh < 1 || n_mask < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? dispatch<__nv_bfloat16>(scores, rel_bias, mask, out, bw, n, nh, n_mask, s)
                  : dispatch<float>(scores, rel_bias, mask, out, bw, n, nh, n_mask, s);
}

}  // extern "C"
