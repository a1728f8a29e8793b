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
// against about 61 MB of traffic.  What the design does about it:
//   - Patches.  The 4 x 4 output pixels (4k+2 .. 4k+5, 4j+2 .. 4j+5) blend the
//     same four low-res pixels (k, k+1) x (j, j+1), with the weights 1/8, 3/8,
//     5/8, 7/8 by position (the phase weights of rba_tpu's PHASE_W, seen from the
//     patch).  k runs from -1 to h-1 and j from -1 to w-1 with the low-res index
//     clamped, which is torch's edge rule; pixels outside the map are not stored.
//   - The contraction runs on the tensor cores at fp32 accuracy.  A patch is the
//     16 rows of an mma.sync m16n8k8 TF32 tile, 8 queries its depth and 8 classes
//     its width.  One TF32 pass (10 mantissa bits) would put the score near the
//     1e-4 it is held to, so s and cls are each split into two TF32 terms and
//     three products are summed in fp32: s_lo c_hi + s_hi c_lo + s_hi c_hi.
//   - A thread computes s directly in the A-fragment layout: lane (g, t) has the
//     pixels g and g + 8 of the patch (same column, rows two apart) and the
//     queries 8 ks + 2t and 8 ks + 2t + 1 of the step, so the four low-res values
//     come as 8-byte shared loads, the horizontal blend is shared by its two
//     pixels, and no shuffle is needed.  (The step's query order is a
//     permutation of the mma's k index; cls is laid out to match.)
//   - Low-res rows are staged in shared memory by tile: a block owns one patch
//     row and 32 patches (2 rows x 33 low-res pixels x Q), copied with 16-byte
//     cp.async into one of two buffers while the other is computed.  Blocks are
//     persistent: one or two per SM walk the tiles.  Each low-res value leaves
//     global memory twice per image (once per patch row that uses it).
//   - A warp takes 4 neighbouring patches, keeps the shared column between two
//     of them in registers, and reuses each B fragment (cls, split once per block
//     into shared memory, one 16-byte load per lane) for all 4.
//   - sigmoid is 1 / (1 + 2^(-v log2 e)) and tanh is 1 - 2 / (2^(2x log2 e) + 1)
//     with ex2.approx and rcp.approx (about 1e-7 relative each).
//   - K > 24 classes take further passes of 24 that recompute s.  Any Q: it is
//     padded to a multiple of 8 with zero cls rows; a Q that is not a multiple of
//     4 is staged with 4-byte copies.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using namespace rba;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocksPerSM = 2;                      // resident blocks the register count is held to
constexpr int kWarpPatches = 4;                      // patches per warp, side by side
constexpr int kTilePatches = kWarps * kWarpPatches;  // patches per tile
constexpr int kTileCols = kTilePatches + 1;          // low-res pixels per staged row
constexpr int kPassTiles = 3;                        // 8-class tiles per pass: 24 classes
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// 2^(-v log2 e) overflows to inf for v < -88 and the reciprocal of inf is 0
__device__ __forceinline__ float sigmoid_approx(float v) { return rcp_approx(1.f + ex2_approx(-kLog2e * v)); }
__device__ __forceinline__ float tanh_approx(float x) {
  return fmaf(-2.f, rcp_approx(1.f + ex2_approx(2.f * kLog2e * x)), 1.f);
}

struct Geometry {
  int nq, nk, h, w;
  int qp;       // nq padded to a multiple of 8: the staged pixel's stride in floats
  int ksteps;   // qp / 8
  int passes;   // passes of 24 classes
  int tiles_x;  // tiles per patch row
  int tiles;    // tiles per image: (h + 1) patch rows
};

// The two low-res rows of tile `tile` into `dst` ([2][kTileCols][qp] floats), with
// cp.async; low-res indices clamped to the map.
template <bool VEC>
__device__ __forceinline__ void stage_tile(float* dst, const float* __restrict__ masks_b, const Geometry& g, int tile) {
  const int k = tile / g.tiles_x - 1;
  const int j0 = (tile % g.tiles_x) * kTilePatches - 1;
  const int row_lo = max(k, 0), row_hi = min(k + 1, g.h - 1);
  const int per_pixel = VEC ? g.nq / 4 : g.nq;  // copies per low-res pixel
  const int total = 2 * kTileCols * per_pixel;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int pixel = idx / per_pixel, part = idx - pixel * per_pixel;
    const int r = pixel / kTileCols, c = pixel - r * kTileCols;
    const int col = min(max(j0 + c, 0), g.w - 1);
    const float* src = masks_b + ((size_t)(r ? row_hi : row_lo) * g.w + col) * g.nq;
    float* d = dst + (size_t)pixel * g.qp;
    if (VEC)
      cp_async16(d + 4 * part, src + 4 * part);
    else
      cp_async4(d + part, src + part);
  }
}

// One tile: each warp's 4 patches, all queries, all classes; stores the score map.
__device__ __forceinline__ void compute_tile(const float* __restrict__ stage, const float4* __restrict__ frag,
                                             float* __restrict__ out_b, const Geometry& geo, int tile) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k = tile / geo.tiles_x - 1;
  const int j0 = (tile % geo.tiles_x) * kTilePatches - 1 + warp * kWarpPatches;  // the warp's first patch
  if (j0 > geo.w - 1) return;  // every patch of this warp lies beyond the map
  const int rx = g % 4, ry = g / 4;  // the lane's pixels: (ry, rx) and (ry + 2, rx) of the patch
  const float wx = 0.125f + 0.25f * rx, wy0 = 0.125f + 0.25f * ry, wy1 = wy0 + 0.5f;
  const int qp = geo.qp, ntiles = geo.passes * kPassTiles;
  const float* row0 = stage + (size_t)(warp * kWarpPatches) * qp + 2 * t;
  const float* row1 = row0 + (size_t)kTileCols * qp;

  float score[kWarpPatches][2];
#pragma unroll
  for (int p = 0; p < kWarpPatches; ++p) score[p][0] = score[p][1] = 0.f;

  for (int pass = 0; pass < geo.passes; ++pass) {
    float acc[kWarpPatches][kPassTiles][4];
#pragma unroll
    for (int p = 0; p < kWarpPatches; ++p)
#pragma unroll
      for (int nt = 0; nt < kPassTiles; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[p][nt][c] = 0.f;

    for (int ks = 0; ks < geo.ksteps; ++ks) {
      float4 b[kPassTiles];  // (c_hi[2t], c_hi[2t+1], c_lo[2t], c_lo[2t+1]) for class 8 nt + g
#pragma unroll
      for (int nt = 0; nt < kPassTiles; ++nt) b[nt] = frag[((size_t)ks * ntiles + pass * kPassTiles + nt) * 32 + lane];
      float2 l0 = *reinterpret_cast<const float2*>(row0 + 8 * ks);
      float2 l1 = *reinterpret_cast<const float2*>(row1 + 8 * ks);
#pragma unroll
      for (int p = 0; p < kWarpPatches; ++p) {
        const float2 n0 = *reinterpret_cast<const float2*>(row0 + (size_t)(p + 1) * qp + 8 * ks);
        const float2 n1 = *reinterpret_cast<const float2*>(row1 + (size_t)(p + 1) * qp + 8 * ks);
        // horizontal blend of both rows, then the vertical one for the two pixels
        const float tx = fmaf(wx, n0.x - l0.x, l0.x), ty = fmaf(wx, n0.y - l0.y, l0.y);
        const float dx = fmaf(wx, n1.x - l1.x, l1.x) - tx, dy = fmaf(wx, n1.y - l1.y, l1.y) - ty;
        const float s[4] = {sigmoid_approx(fmaf(wy0, dx, tx)), sigmoid_approx(fmaf(wy1, dx, tx)),
                            sigmoid_approx(fmaf(wy0, dy, ty)), sigmoid_approx(fmaf(wy1, dy, ty))};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          hi[c] = to_tf32(s[c]);
          lo[c] = to_tf32(s[c] - __uint_as_float(hi[c]));
        }
#pragma unroll
        for (int nt = 0; nt < kPassTiles; ++nt) {
          mma_tf32(acc[p][nt], lo, __float_as_uint(b[nt].x), __float_as_uint(b[nt].y));
          mma_tf32(acc[p][nt], hi, __float_as_uint(b[nt].z), __float_as_uint(b[nt].w));
          mma_tf32(acc[p][nt], hi, __float_as_uint(b[nt].x), __float_as_uint(b[nt].y));
        }
        l0 = n0, l1 = n1;
      }
    }
    // a padded class has cls = 0, so its sum is 0 and its tanh adds nothing
#pragma unroll
    for (int p = 0; p < kWarpPatches; ++p)
#pragma unroll
      for (int nt = 0; nt < kPassTiles; ++nt) {
        score[p][0] -= tanh_approx(acc[p][nt][0]) + tanh_approx(acc[p][nt][1]);
        score[p][1] -= tanh_approx(acc[p][nt][2]) + tanh_approx(acc[p][nt][3]);
      }
  }

  // sum over the 4 lanes that hold a pixel's classes; lane t then stores patch t, so a
  // warp writes 16 consecutive floats per output row
  float o0 = 0.f, o1 = 0.f;
#pragma unroll
  for (int p = 0; p < kWarpPatches; ++p)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v = score[p][i];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (p == t) (i ? o1 : o0) = v;
    }
  const int ow = 4 * geo.w, oh = 4 * geo.h;
  const int ox = 4 * (j0 + t) + 2 + rx, oy = 4 * k + 2 + ry;
  if (ox >= 0 && ox < ow) {
    if (oy >= 0 && oy < oh) out_b[(size_t)oy * ow + ox] = o0;
    if (oy + 2 >= 0 && oy + 2 < oh) out_b[(size_t)(oy + 2) * ow + ox] = o1;
  }
}

// Persistent blocks: blockIdx.y is the batch element, blockIdx.x walks its tiles.
template <bool VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
fused_rba_mma_kernel(const float* __restrict__ cls, const float* __restrict__ masks, float* __restrict__ out,
                     Geometry geo) {
  extern __shared__ __align__(16) float smem[];
  const int ntiles = geo.passes * kPassTiles;
  float4* frag = reinterpret_cast<float4*>(smem);           // [ksteps][ntiles][32 lanes]
  float* stage = smem + (size_t)geo.ksteps * ntiles * 128;  // [2 buffers][2 rows][kTileCols][qp]
  const int buffer = 2 * kTileCols * geo.qp;
  const int b = blockIdx.y;
  const float* masks_b = masks + (size_t)b * geo.h * geo.w * geo.nq;
  float* out_b = out + (size_t)b * 16 * geo.h * geo.w;

  int tile = blockIdx.x;
  if (tile < geo.tiles) stage_tile<VEC>(stage, masks_b, geo, tile);
  cp_async_commit();

  // cls of this batch element, split into two TF32 terms, in B-fragment order; rows
  // beyond Q and classes beyond K are 0
  const float* cls_b = cls + (size_t)b * geo.nq * geo.nk;
  for (int idx = threadIdx.x; idx < geo.ksteps * ntiles * 32; idx += kThreads) {
    const int lane = idx % 32, nt = (idx / 32) % ntiles, ks = idx / (32 * ntiles);
    const int q = 8 * ks + 2 * (lane % 4), kk = 8 * nt + lane / 4;
    const float c0 = (q < geo.nq && kk < geo.nk) ? cls_b[(size_t)q * geo.nk + kk] : 0.f;
    const float c1 = (q + 1 < geo.nq && kk < geo.nk) ? cls_b[(size_t)(q + 1) * geo.nk + kk] : 0.f;
    const float h0 = __uint_as_float(to_tf32(c0)), h1 = __uint_as_float(to_tf32(c1));
    frag[idx] = make_float4(h0, h1, __uint_as_float(to_tf32(c0 - h0)), __uint_as_float(to_tf32(c1 - h1)));
  }
  // the padded queries of both buffers: no copy writes them
  const int pad = geo.qp - geo.nq;
  for (int idx = threadIdx.x; idx < 4 * kTileCols * pad; idx += kThreads)
    stage[(size_t)(idx / pad) * geo.qp + geo.nq + idx % pad] = 0.f;

  for (int cur = 0; tile < geo.tiles; tile += gridDim.x, cur ^= 1) {
    const int next = tile + gridDim.x;
    if (next < geo.tiles) stage_tile<VEC>(stage + (cur ^ 1) * buffer, masks_b, geo, next);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed; the next tile's may be in flight
    __syncthreads();
    compute_tile(stage + cur * buffer, frag, out_b, geo, tile);
    __syncthreads();  // before the next round's copies overwrite this buffer
  }
  cp_async_wait<0>();
}

template <bool VEC>
int launch(const float* cls, const float* masks, float* out, int b, const Geometry& geo, size_t smem,
           cudaStream_t stream) {
  auto kernel = fused_rba_mma_kernel<VEC>;
  // the shared-memory opt-in and the blocks the current card holds at once: both belong
  // to the card and the size, and are asked at every launch (host calls, no synchronisation)
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  // one wave of resident blocks, shared by the batch elements
  int gx = (sms * per_sm + b - 1) / b;
  if (gx > geo.tiles) gx = geo.tiles;
  kernel<<<dim3(gx, b), kThreads, smem, stream>>>(cls, masks, out, geo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rba_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// cls (b, nq, nk) fp32, softmaxed with the no-object class dropped; masks
// (b, h, w, nq) fp32; out (b, 4h, 4w) fp32.  Returns a cudaError_t.
int rba_fused_rba_score(const float* cls, const float* masks, float* out, int b, int nq, int nk,
                        int h, int w, void* stream) {
  if (b < 1 || b > 65535 || nq < 1 || nk < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  Geometry geo;
  geo.nq = nq, geo.nk = nk, geo.h = h, geo.w = w;
  geo.qp = (nq + 7) / 8 * 8;
  geo.ksteps = geo.qp / 8;
  geo.passes = (nk + 8 * kPassTiles - 1) / (8 * kPassTiles);
  geo.tiles_x = (w + 1 + kTilePatches - 1) / kTilePatches;
  const long long tiles = (long long)geo.tiles_x * (h + 1);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  geo.tiles = (int)tiles;
  // the cls fragments and two staging buffers; the wrapper refuses a shape that needs
  // more than a block can have
  const long long smem = 4LL * (geo.ksteps * geo.passes * kPassTiles * 128 + 4 * kTileCols * geo.qp);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies where every low-res pixel's Q floats start on 16 bytes
  const bool vec = nq % 4 == 0 && (uintptr_t)masks % 16 == 0;
  return vec ? launch<true>(cls, masks, out, b, geo, (size_t)smem, s)
             : launch<false>(cls, masks, out, b, geo, (size_t)smem, s);
}

}  // extern "C"
