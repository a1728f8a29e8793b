// Multi-scale deformable attention sampling, forward (Kernel F), for Hopper
// (sm_90a), with a plain C interface for ctypes.
//
// Replaces no Pallas kernel: rba_tpu samples with a jnp gather
// (rba_tpu/ops/deform_sampling.py), which XLA fuses into a few loops, while
// eager PyTorch runs the same gather as about 100 small operations per level
// (rba_tpu_torch/ops/deform_sampling.py _sample_level).  The original RbA ran
// Deformable DETR's CUDA op ms_deformable_im2col_gpu_kernel, one thread per
// (batch, query, head, channel).  This kernel computes the port's gather form,
// summed over levels, in one launch per call:
//     x = loc_x * W - 0.5,  y = loc_y * H - 0.5   (each rounded, no fma)
//     x0 = floor(x), y0 = floor(y), tx = x - x0, ty = y - y0
//     corner (dy, dx): valid when x0 + dx, y0 + dy lie in the map (tested
//         before any clamp: zero padding), weight (wx * wy) * attn with
//         wx = tx or 1 - tx, wy = ty or 1 - ty, and 0 where not valid
//     out[n, q, m, :] = sum over levels, points and corners of
//         weight * value[n, start_l + (y0 + dy) * W + (x0 + dx), m, :]
// in fp32.  Only the order of the fp32 sums differs from the plain version.
//
// Bound on the H100: the gather through L2, not HBM.  At R50's three levels
// (Lq = S = 43,008, M = 8, D = 32, L = 3, P = 4) one call reads 44 MB of
// values, 33 MB of locations and 16.5 MB of attention weights and writes 44 MB
// once, 41 us at 3.35 TB/s; its 1.3 GFLOP are nothing.  But each of the 4.13 M
// samples reads four 128-byte value rows, about 2.1 GB of gathers per call,
// which L2 (the 44 MB of values stay resident in its 50 MB) and L1 serve.  What
// the design does about it:
//   - One warp per (batch, query, head).  Lane c of a chunk of 32 computes
//     corner c % 4 of point c / 4 (its level, location and weight read once),
//     so L·P points take ceil(4·L·P / 32) chunks (two on R50).
//   - A value row (D = 32 fp32, 128 bytes, in every served config) is read as
//     float4 by 8 lanes, so the warp's 4 lane groups have 4 corner rows in
//     flight per load instruction; each group takes its corner's pixel and
//     weight from the lane that computed them with __shfl_sync, and all 8 loads
//     of a chunk are issued before the first fma.  A corner outside the map
//     (weight 0) is not read.  D = 16 (the tests' tiny config) takes 4 lanes per row.
//   - The four groups' partial sums meet by __shfl_xor_sync; lanes 0..7 store
//     the head's 128 bytes of output in one coalesced store, straight into the
//     (N, Lq, M·D) layout.
//   - Warps walk (query, head) in order, and the queries of the encoder are
//     the pixels of each level in raster order, so neighbouring warps sample
//     neighbouring pixels and L1 catches their overlap.  No shared memory.
//   - Level sizes and starts are kernel arguments, from the host's shapes.
//     Offsets into the values are 64-bit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kWarps = 8;  // warps per block (WARPS in kernels/ms_deform_attn.py)
constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

template <int D>
__global__ void __launch_bounds__(32 * kWarps) ms_deform_attn_kernel(
    const float* __restrict__ value,  // (N, S, M, D)
    const float* __restrict__ loc,    // (N, Lq, M, L, P, 2)
    const float* __restrict__ attn,   // (N, Lq, M, L, P)
    float* __restrict__ out,          // (N, Lq, M, D)
    Levels lv, int nlevels, int npoints, int s, int m, long long lq_m, long long warps) {
  static_assert(D % 4 == 0 && 32 % (D / 4) == 0, "a value row is read as float4 by a power-of-two share of a warp");
  constexpr int kRowLanes = D / 4;         // lanes that read one value row as float4
  constexpr int kGroups = 32 / kRowLanes;  // corner rows per load instruction
  constexpr int kSteps = 32 / kGroups;     // load instructions per chunk of 32 corners
  const int lane = threadIdx.x & 31;
  const long long wid = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);  // (n * Lq + q) * M + head
  if (wid >= warps) return;
  const int head = (int)(wid % m);
  const long long n = wid / lq_m;
  const float* base = value + ((long long)n * s * m + head) * D;  // pixel 0 of head `head`
  const long long row = (long long)m * D;                          // floats between pixels
  const int npt = nlevels * npoints;
  const float* locw = loc + wid * npt * 2;
  const float* attnw = attn + wid * npt;
  const int group = lane / kRowLanes, sub = lane % kRowLanes;

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int cb = 0; cb < 4 * npt; cb += 32) {  // uniform over the warp
    const int c = cb + lane, k = c & 3, j = c >> 2;
    float wgt = 0.f;
    int pix = 0;
    if (j < npt) {
      const int l = j / npoints;
      int h = 0, w = 0, start = 0;
#pragma unroll
      for (int i = 0; i < kMaxLevels; ++i) {  // a constant index keeps the arguments out of local memory
        if (i == l) {
          h = lv.h[i];
          w = lv.w[i];
          start = lv.start[i];
        }
      }
      const float2 xy = reinterpret_cast<const float2*>(locw)[j];
      const float x = __fsub_rn(__fmul_rn(xy.x, (float)w), 0.5f);
      const float y = __fsub_rn(__fmul_rn(xy.y, (float)h), 0.5f);
      const float x0 = floorf(x), y0 = floorf(y);
      const float tx = __fsub_rn(x, x0), ty = __fsub_rn(y, y0);
      const int dx = k & 1, dy = k >> 1;  // corners (dy, dx) in the order (0, 0), (0, 1), (1, 0), (1, 1)
      const float xc = x0 + dx, yc = y0 + dy;  // exact: integers, and NaN fails every test below
      if (xc >= 0.f && xc < (float)w && yc >= 0.f && yc < (float)h) {
        const float wx = dx ? tx : __fsub_rn(1.f, tx);
        const float wy = dy ? ty : __fsub_rn(1.f, ty);
        wgt = __fmul_rn(__fmul_rn(wx, wy), attnw[j]);
        pix = start + (int)yc * w + (int)xc;
      }
    }
    float ws[kSteps];
    float4 v[kSteps];
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      const int src = t * kGroups + group;
      ws[t] = __shfl_sync(kFull, wgt, src);
      const int p = __shfl_sync(kFull, pix, src);
      v[t] = ws[t] != 0.f ? __ldg(reinterpret_cast<const float4*>(base + p * row) + sub)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      acc.x = fmaf(ws[t], v[t].x, acc.x);
      acc.y = fmaf(ws[t], v[t].y, acc.y);
      acc.z = fmaf(ws[t], v[t].z, acc.z);
      acc.w = fmaf(ws[t], v[t].w, acc.w);
    }
  }
#pragma unroll
  for (int off = kRowLanes; off < 32; off <<= 1) {
    acc.x += __shfl_xor_sync(kFull, acc.x, off);
    acc.y += __shfl_xor_sync(kFull, acc.y, off);
    acc.z += __shfl_xor_sync(kFull, acc.z, off);
    acc.w += __shfl_xor_sync(kFull, acc.w, off);
  }
  if (lane < kRowLanes) reinterpret_cast<float4*>(out + wid * D)[lane] = acc;
}

}  // namespace

extern "C" {

const char* rba_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// value (n, s, m, d) fp32, 16-byte aligned; loc (n, lq, m, nlevels, npoints, 2) fp32,
// 8-byte aligned; attn (n, lq, m, nlevels, npoints) fp32; out (n, lq, m, d) fp32,
// 16-byte aligned; level_hw the (h, w) of each level on the host, in order, their
// h * w summing to s.  d is 16 or 32 and nlevels 1 to 4; the Python wrapper
// (kernels/ms_deform_attn.py) checks these and the sizes.  Returns a cudaError_t.
int rba_ms_deform_attn(const float* value, const float* loc, const float* attn, float* out, int n, int s, int m,
                       int d, int lq, const int* level_hw, int nlevels, int npoints, void* stream) {
  Levels lv = {};
  for (int i = 0, start = 0; i < nlevels; ++i) {
    lv.h[i] = level_hw[2 * i], lv.w[i] = level_hw[2 * i + 1], lv.start[i] = start;
    start += lv.h[i] * lv.w[i];
  }
  const long long warps = (long long)n * lq * m;
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long lq_m = (long long)lq * m;
  switch (d) {
    case 16:
      ms_deform_attn_kernel<16><<<blocks, 32 * kWarps, 0, st>>>(value, loc, attn, out, lv, nlevels, npoints, s, m,
                                                                lq_m, warps);
      break;
    case 32:
      ms_deform_attn_kernel<32><<<blocks, 32 * kWarps, 0, st>>>(value, loc, attn, out, lv, nlevels, npoints, s, m,
                                                                lq_m, warps);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
