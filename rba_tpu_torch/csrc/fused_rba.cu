// Fused RbA score for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the Pallas kernel rba_tpu/ops/pallas/fused_rba.py fused_rba_score
// (body _make_pair_kernel).  For each output pixel (y, x) of a (B, 4h, 4w) map:
//     m_q   = bilinear x4 upsample of the low-res mask logits, align_corners=False
//             (src = (dst + 0.5) / 4 - 0.5, clamped to the edge, torch's rule)
//     s_q   = sigmoid(m_q)
//     sem_k = sum_q s_q * cls[q, k]        cls = softmax(class logits)[:, :K]
//     out   = -sum_k tanh(sem_k)
// The (Q, 4h, 4w) upsampled tensor never exists: only the low-res masks in the
// bhwq layout (Q contiguous per low-res pixel) are read, and the score map is
// written.  The Pallas version's phase-planar output and de-interleave
// transpose were TPU tiling artefacts and are not carried over.
//
// Bound on the H100: operations.  At Q = 100, K = 19, 1024x2048 the contraction
// alone is 2 * Q * K flops per pixel, about 8 GFLOP of fp32 on CUDA cores,
// against about 61 MB of traffic.  Simple design: one thread per output pixel,
// the block's batch row of cls (Q x K fp32) in shared memory, read as
// broadcasts; the K sums live in registers, in chunks of 32 classes, so any K
// works (a chunk beyond the first recomputes the upsample and sigmoid).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;

__global__ void __launch_bounds__(kThreads)
fused_rba_kernel(const float* __restrict__ cls, const float* __restrict__ masks,
                 float* __restrict__ out, int nq, int nk, int h, int w) {
  extern __shared__ float cls_s[];  // nq x nk
  const int b = blockIdx.z;
  const int oy = blockIdx.y;
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const float* cls_b = cls + (size_t)b * nq * nk;
  for (int i = threadIdx.x; i < nq * nk; i += blockDim.x) cls_s[i] = cls_b[i];
  __syncthreads();
  const int ow = 4 * w;
  if (ox >= ow) return;

  // torch's area_pixel_compute_source_index for align_corners=False, scale 1/4
  const float sy = fmaxf((oy + 0.5f) * 0.25f - 0.5f, 0.f);
  const float sx = fmaxf((ox + 0.5f) * 0.25f - 0.5f, 0.f);
  const int y0 = (int)sy, x0 = (int)sx;
  const float fy = sy - y0, fx = sx - x0;
  const int y1 = y0 + (y0 < h - 1), x1 = x0 + (x0 < w - 1);
  const float* m = masks + (size_t)b * h * w * nq;
  const float* p00 = m + ((size_t)y0 * w + x0) * nq;
  const float* p01 = m + ((size_t)y0 * w + x1) * nq;
  const float* p10 = m + ((size_t)y1 * w + x0) * nq;
  const float* p11 = m + ((size_t)y1 * w + x1) * nq;

  float score = 0.f;
  for (int k0 = 0; k0 < nk; k0 += kChunk) {
    const int kc = min(kChunk, nk - k0);
    float acc[kChunk];
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) acc[kk] = 0.f;
    for (int q = 0; q < nq; ++q) {
      const float top = (1.f - fx) * __ldg(p00 + q) + fx * __ldg(p01 + q);
      const float bot = (1.f - fx) * __ldg(p10 + q) + fx * __ldg(p11 + q);
      const float v = (1.f - fy) * top + fy * bot;
      const float s = 1.f / (1.f + expf(-v));
      const float* c = cls_s + q * nk + k0;
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk)
        if (kk < kc) acc[kk] = fmaf(s, c[kk], acc[kk]);
    }
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk)
      if (kk < kc) score -= tanhf(acc[kk]);
  }
  out[((size_t)b * 4 * h + oy) * ow + ox] = score;
}

}  // namespace

extern "C" {

const char* rba_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// cls (b, nq, nk) fp32, softmaxed with the no-object class dropped; masks
// (b, h, w, nq) fp32; out (b, 4h, 4w) fp32.  Returns a cudaError_t.
int rba_fused_rba_score(const float* cls, const float* masks, float* out, int b, int nq, int nk,
                        int h, int w, void* stream) {
  if (b < 1 || b > 65535 || nq < 1 || nk < 1 || h < 1 || w < 1 || 4 * h > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)nq * nk;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(fused_rba_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((4 * w + kThreads - 1) / kThreads, 4 * h, b);
  fused_rba_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(cls, masks, out, nq, nk, h, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
