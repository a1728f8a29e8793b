// Swin attention softmax with the relative-position bias and shift mask added,
// for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the Pallas kernel of rba_tpu/ops/pallas/masked_softmax.py
// (masked_softmax_bf16: _kernel with a mask, _kernel_nomask without).  For each
// row i of window w and head h:
//     out[w, h, i, :] = softmax(s[w, h, i, :] + rel_bias[h, i, :] + mask[w % nW, i, :])
// The adds are fp32 in that order, the max-subtracted softmax is fp32 with
// expf (not __expf) and a division by the row sum, as jax.nn.softmax does, and
// the probability is rounded once to the output type (bf16 or fp32) when it is
// stored.
//
// Bound on the H100: bytes.  At Swin-B 1024x2048 stage 0 one call reads 314 MB
// of fp32 scores and writes 157 MB of bf16 probabilities, plus 78 MB of fp32
// mask when shifted (0.14-0.16 ms at 3.35 TB/s), for a few operations per
// element.  The design reads each input once and writes each output once: one
// warp per row (N <= 160 keys), lane l holding keys l, l + 32, ... in
// registers, so a warp's loads of a row are coalesced; max and sum are warp
// shuffles.  The bias (nh x N x N) and mask (nW x N x N) are re-read by every
// window and head, which the 50 MB L2 mostly serves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kKeysPerLane = 5;  // N <= 32 * 5 = 160

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
masked_softmax_kernel(const float* __restrict__ scores, const float* __restrict__ rel_bias,
                      const float* __restrict__ mask, T* __restrict__ out,
                      long long rows, int n, int nh, int n_mask) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int i = (int)(row % n);
  const long long wh = row / n;  // window * nh + head
  const int head = (int)(wh % nh);
  const long long win = wh / nh;

  const float* s_row = scores + row * n;
  const float* b_row = rel_bias + ((size_t)head * n + i) * n;
  const float* m_row = mask ? mask + ((size_t)(win % n_mask) * n + i) * n : nullptr;

  float v[kKeysPerLane];
  float mx = -INFINITY;
#pragma unroll
  for (int t = 0; t < kKeysPerLane; ++t) {
    const int j = lane + 32 * t;
    v[t] = -INFINITY;
    if (j < n) {
      float x = s_row[j] + b_row[j];
      if (m_row) x += m_row[j];
      v[t] = x;
      mx = fmaxf(mx, x);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));

  float sum = 0.f;
#pragma unroll
  for (int t = 0; t < kKeysPerLane; ++t) {
    if (lane + 32 * t < n) {
      v[t] = expf(v[t] - mx);
      sum += v[t];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);

  T* o_row = out + row * n;
#pragma unroll
  for (int t = 0; t < kKeysPerLane; ++t) {
    const int j = lane + 32 * t;
    if (j < n) store(o_row + j, v[t] / sum);
  }
}

template <typename T>
int launch(const float* scores, const float* rel_bias, const float* mask, void* out, long long rows,
           int n, int nh, int n_mask, cudaStream_t stream) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  masked_softmax_kernel<T><<<(unsigned)blocks, 32 * kWarps, 0, stream>>>(
      scores, rel_bias, mask, static_cast<T*>(out), rows, n, nh, n_mask);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rba_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// scores (bw, nh, n, n) fp32; rel_bias (nh, n, n) fp32; mask (n_mask, n, n) fp32 or
// null, window w taking mask[w % n_mask]; out (bw, nh, n, n) bf16 (out_bf16 = 1) or
// fp32.  Returns a cudaError_t.
int rba_masked_softmax(const float* scores, const float* rel_bias, const float* mask, void* out,
                       int bw, int nh, int n, int n_mask, int out_bf16, void* stream) {
  if (n < 1 || n > 32 * kKeysPerLane || bw < 1 || nh < 1 || n_mask < 1) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)bw * nh * n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch<__nv_bfloat16>(scores, rel_bias, mask, out, rows, n, nh, n_mask, s)
                  : launch<float>(scores, rel_bias, mask, out, rows, n, nh, n_mask, s);
}

}  // extern "C"
