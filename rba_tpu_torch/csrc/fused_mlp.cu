// Fused Swin MLP block tail for Hopper (sm_90a), with a plain C interface for ctypes:
//     out = x + fc2(gelu(fc1(LayerNorm(x))))
// with the (T, 4C) hidden tensor never written to device memory.
//
// Replaces the Pallas kernel of rba_tpu/ops/pallas/fused_mlp.py
// (fused_mlp_residual -> _fused_mlp_flat, body _kernel).  Its dtype placement
// is kept, with the compute dtype x's (bf16 or fp32):
//   - LayerNorm moments E[x] and E[x^2] in fp32, variance clamped at >= 0,
//     eps 1e-5; gamma, beta and every weight and bias rounded to the compute
//     dtype, as the Pallas wrapper casts them; the normalised row rounded;
//   - each product accumulated in fp32 and rounded before its bias add, the add
//     done in the compute dtype;
//   - exact gelu, 0.5 h (1 + erff(h / sqrt 2)) in fp32, rounded (the Pallas
//     kernel's polynomial erf was a Mosaic workaround);
//   - the residual add in the compute dtype.
// Only the order of the fp32 sums differs from the plain version.
//
// Bound on the H100: operations.  At Swin-B 1024x2048 stage 0 (T = 131072,
// C = 128) and stage 1 (T = 32768, C = 256) one call is 2 * 2 * T * C * 4C =
// 34.4 GFLOP against 67 MB (stage 0, bf16) of x read and out written: 35 us at
// the bf16 tensor-core peak, 20 us at 3.35 TB/s.
//
// bf16, the serving dtype: tensor cores (fused_mlp_mma_kernel).  w1 and w2 come
// as bf16 copies in nn.Linear's (out, in) layout (the wrapper rounds the fp32
// parameters with .to(bfloat16), the rounding of the plain version); the
// LayerNorm parameters and biases stay fp32 and are rounded here.
//   - A block of 8 warps takes TM tokens: 128 (8 warps x 16 rows) at C <= 256,
//     64 at C = 384 and 512.  It normalises them, one warp per row, into shared
//     memory as bf16.
//   - It walks the 4C hidden units in chunks of HC (64 at C = 256, else 32, so
//     that at C = 128 two blocks fit an SM: 128 registers a thread, 71 KB).
//     A chunk's HC rows of w1 and HC columns of w2 are staged as bf16 by 16-byte
//     cp.async, double-buffered, so the next chunk's loads run under this
//     chunk's products.  Shared rows are padded by 8 values (16 bytes), so the 8
//     rows of one ldmatrix fall in 8 different bank groups.
//   - fc1 of the chunk on mma.sync m16n8k16 (bf16 in, fp32 sums): each warp a
//     (16, HC) tile.  Then, in registers: round, add b1 in bf16, exact gelu in
//     fp32, round; the (16, HC) result is repacked as the A fragments of fc2
//     and never touches shared memory.
//   - fc2 accumulates into the warp's (16, C / NS) fp32 output tile in
//     registers: C / 2 / NS floats a thread.  At C = 384 and 512 the output
//     columns are split across NS = 2 warps on the same rows (96 and 128 floats
//     a thread, no spills), each of which computes the chunk's fc1 itself.
//   - Epilogue: round, add b2 in bf16, add the residual in bf16, store.
//
// fp32 keeps the CUDA-core kernel (fused_mlp_kernel): the tensor cores take fp32
// only as TF32, which keeps about three decimal digits and would break the 1e-4
// kernel check.  One block of 256 threads per tile of 64 tokens (C = 128) or 32
// normalises its rows into shared memory, then walks the hidden units in chunks
// of 32: it stages the chunk's 32 rows of w1 and 32 columns of w2, computes the
// hidden chunk with bias and gelu into shared memory, and adds its product with
// the w2 columns to the fp32 output tile in registers, all with float4 fmaf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float gelu(float h) { return 0.5f * h * (1.f + erff(h * 0.70710678118654752f)); }

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kHC = 32;   // hidden units per chunk, one per lane
constexpr int kPad = 4;   // floats of padding per shared-memory row

template <int C>
__host__ __device__ constexpr int tile_tokens() { return C <= 128 ? 64 : 32; }

template <int C>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(tile_tokens<C>() + kHC) * (C + kPad) + (size_t)(C + tile_tokens<C>()) * (kHC + kPad));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const float* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
                 const float* __restrict__ w1, const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, float* __restrict__ out, long long t_total) {
  constexpr int TM = tile_tokens<C>();
  constexpr int H = 4 * C;
  constexpr int YS = C + kPad;    // row stride of ys and w1s
  constexpr int HS = kHC + kPad;  // row stride of w2s and hs
  constexpr int RPT = TM / kWarps;  // rows per thread: warp, warp + 8, ...
  constexpr int CPT = C / 32;       // columns per thread: lane, lane + 32, ...

  extern __shared__ float4 smem4[];
  float* ys = reinterpret_cast<float*>(smem4);  // TM x YS: LayerNorm(x)
  float* w1s = ys + TM * YS;                    // kHC x YS: rows h0 .. h0 + 31 of w1
  float* w2s = w1s + kHC * YS;                  // C x HS: columns h0 .. h0 + 31 of w2
  float* hs = w2s + C * HS;                     // TM x HS: gelu(fc1) of the chunk

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row0 = (long long)blockIdx.x * TM;

  // LayerNorm, one warp per row
  for (int r = warp; r < TM; r += kWarps) {
    const long long tok = row0 + r;
    float xv[CPT];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      xv[u] = tok < t_total ? x[tok * C + lane + 32 * u] : 0.f;
      s1 += xv[u];
      s2 = fmaf(xv[u], xv[u], s2);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mean = s1 / C;
    const float inv = rsqrtf(fmaxf(s2 / C - mean * mean, 0.f) + kEps);
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const int c = lane + 32 * u;
      ys[r * YS + c] = (xv[u] - mean) * inv * gamma[c] + beta[c];
    }
  }

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int u = 0; u < CPT; ++u) acc[i][u] = 0.f;

  for (int h0 = 0; h0 < H; h0 += kHC) {
    for (int idx = threadIdx.x; idx < kHC * C / 4; idx += kThreads) {
      const int j = idx / (C / 4), k4 = idx % (C / 4);
      *reinterpret_cast<float4*>(w1s + j * YS + 4 * k4) = reinterpret_cast<const float4*>(w1 + (size_t)(h0 + j) * C)[k4];
    }
    for (int idx = threadIdx.x; idx < C * kHC / 4; idx += kThreads) {
      const int n = idx / (kHC / 4), k4 = idx % (kHC / 4);
      *reinterpret_cast<float4*>(w2s + n * HS + 4 * k4) = reinterpret_cast<const float4*>(w2 + (size_t)n * H + h0)[k4];
    }
    __syncthreads();

    // fc1 chunk: lane j computes hidden unit h0 + j of the thread's rows
    {
      float hacc[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) hacc[i] = 0.f;
      const float* wrow = w1s + lane * YS;
#pragma unroll 4
      for (int k = 0; k < C; k += 4) {
        const float4 w = *reinterpret_cast<const float4*>(wrow + k);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          hacc[i] = dot4(*reinterpret_cast<const float4*>(ys + (warp + kWarps * i) * YS + k), w, hacc[i]);
      }
      const float bias = b1[h0 + lane];
#pragma unroll
      for (int i = 0; i < RPT; ++i) hs[(warp + kWarps * i) * HS + lane] = gelu(hacc[i] + bias);
    }
    __syncthreads();

    // fc2: add the chunk's hidden units times w2's columns to the thread's outputs
#pragma unroll
    for (int k = 0; k < kHC; k += 4) {
      float4 hv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) hv[i] = *reinterpret_cast<const float4*>(hs + (warp + kWarps * i) * HS + k);
#pragma unroll
      for (int u = 0; u < CPT; ++u) {
        const float4 w = *reinterpret_cast<const float4*>(w2s + (lane + 32 * u) * HS + k);
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][u] = dot4(hv[i], w, acc[i][u]);
      }
    }
    __syncthreads();  // w1s, w2s and hs are rewritten by the next chunk
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const long long tok = row0 + warp + kWarps * i;
    if (tok >= t_total) continue;
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const int c = lane + 32 * u;
      out[tok * C + c] = x[tok * C + c] + (acc[i][u] + b2[c]);
    }
  }
}

template <int C>
int launch_fp32(const void* x, const float* gamma, const float* beta, const void* w1, const float* b1,
                const void* w2, const float* b2, void* out, long long t, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<C>();
  static_assert(smem <= 232448, "shared memory of one block on sm_90");
  auto kernel = fused_mlp_kernel<C>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (t + tile_tokens<C>() - 1) / tile_tokens<C>();
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(x), gamma, beta, static_cast<const float*>(w1), b1, static_cast<const float*>(w2),
      b2, static_cast<float*>(out), t);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

template <int C>
struct MmaTile {
  static constexpr int NS = C <= 256 ? 1 : 2;     // warps that split one row tile's output columns
  static constexpr int TM = 16 * kWarps / NS;     // tokens per block
  static constexpr int HC = C == 256 ? 64 : 32;   // hidden units per chunk
  static constexpr int MIN_BLOCKS = C == 128 ? 2 : 1;  // blocks per SM: caps registers at 128 at C = 128
  static constexpr int YS = C + 8;                // row stride of ys and w1s, in bf16 values
  static constexpr int WS = HC + 8;               // row stride of w2s
  static constexpr int W1_ELEMS = HC * YS;
  static constexpr int W2_ELEMS = C * WS;
  static constexpr size_t SMEM = sizeof(__nv_bfloat16) * ((size_t)TM * YS + 2 * (size_t)(W1_ELEMS + W2_ELEMS));
};

template <int C>
__global__ void __launch_bounds__(kThreads, MmaTile<C>::MIN_BLOCKS)
fused_mlp_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const __nv_bfloat16* __restrict__ w1,
                     const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                     const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, long long t_total) {
  using P = MmaTile<C>;
  constexpr int TM = P::TM, HC = P::HC, YS = P::YS, WS = P::WS, NS = P::NS;
  constexpr int H = 4 * C;
  constexpr int CS = C / NS;  // output columns of one warp
  constexpr int V4 = C / 128; // 4-value groups of a row per lane in the LayerNorm

  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem_u4);  // TM x YS: LayerNorm(x), bf16
  __nv_bfloat16* w1s = ys + TM * YS;                              // 2 x (HC x YS): rows of w1
  __nv_bfloat16* w2s = w1s + 2 * P::W1_ELEMS;                     // 2 x (C x WS): columns of w2

  const long long row0 = (long long)blockIdx.x * TM;

  // the chunk's HC rows of w1 and HC columns of w2 into buffer `buf`
  auto stage = [&](int chunk, int buf) {
    const int h0 = chunk * HC;
    __nv_bfloat16* d1 = w1s + buf * P::W1_ELEMS;
    __nv_bfloat16* d2 = w2s + buf * P::W2_ELEMS;
    for (int idx = threadIdx.x; idx < HC * C / 8; idx += kThreads) {
      const int j = idx / (C / 8), k8 = idx % (C / 8);
      rba::cp_async16(d1 + j * YS + 8 * k8, w1 + (size_t)(h0 + j) * C + 8 * k8);
    }
    for (int idx = threadIdx.x; idx < C * HC / 8; idx += kThreads) {
      const int nn = idx / (HC / 8), k8 = idx % (HC / 8);
      rba::cp_async16(d2 + nn * WS + 8 * k8, w2 + (size_t)nn * H + h0 + 8 * k8);
    }
  };
  stage(0, 0);
  rba::cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // LayerNorm, one warp per row; lane l holds the values 4 (l + 32 u) .. + 3
  for (int r = warp; r < TM; r += kWarps) {
    const long long tok = row0 + r;
    float xv[V4][4];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int u = 0; u < V4; ++u) {
      uint2 raw = make_uint2(0u, 0u);
      if (tok < t_total) raw = *reinterpret_cast<const uint2*>(x + tok * C + 4 * (lane + 32 * u));
      const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 lo = __bfloat1622float2(pr[0]), hi = __bfloat1622float2(pr[1]);
      xv[u][0] = lo.x, xv[u][1] = lo.y, xv[u][2] = hi.x, xv[u][3] = hi.y;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s1 += xv[u][e];
        s2 = fmaf(xv[u][e], xv[u][e], s2);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mean = s1 / C;
    const float inv = rsqrtf(fmaxf(s2 / C - mean * mean, 0.f) + kEps);
#pragma unroll
    for (int u = 0; u < V4; ++u) {
      const int c = 4 * (lane + 32 * u);
      const float4 ga = *reinterpret_cast<const float4*>(gamma + c);
      const float4 be = *reinterpret_cast<const float4*>(beta + c);
      const float gv[4] = {ga.x, ga.y, ga.z, ga.w}, bv[4] = {be.x, be.y, be.z, be.w};
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = (xv[u][e] - mean) * inv * rba::round_bf16(gv[e]) + rba::round_bf16(bv[e]);
      *reinterpret_cast<uint2*>(ys + r * YS + c) = make_uint2(rba::pack_bf16(y[0], y[1]), rba::pack_bf16(y[2], y[3]));
    }
  }

  const int g = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (warp % (kWarps / NS));  // the warp's 16 rows
  const int n0 = CS * (warp / (kWarps / NS));  // and its output columns

  float o[CS / 8][4];
#pragma unroll
  for (int j = 0; j < CS / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int chunk = 0; chunk < H / HC; ++chunk) {
    if (chunk + 1 < H / HC) stage(chunk + 1, (chunk + 1) & 1);
    rba::cp_async_commit();
    rba::cp_async_wait<1>();  // this chunk's group has landed
    __syncthreads();          // for every thread's copies, and the LayerNorm rows
    const __nv_bfloat16* w1c = w1s + (chunk & 1) * P::W1_ELEMS;
    const __nv_bfloat16* w2c = w2s + (chunk & 1) * P::W2_ELEMS;

    // fc1: (16, HC) = y (16, C) . w1c^T
    float h[HC / 8][4];
#pragma unroll
    for (int j = 0; j < HC / 8; ++j) h[j][0] = h[j][1] = h[j][2] = h[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < C / 16; ++kc) {
      uint32_t a[4];
      rba::ldmatrix_x4(a, ys + (m0 + (lane & 15)) * YS + 16 * kc + (lane >> 4) * 8);
#pragma unroll
      for (int hp = 0; hp < HC / 16; ++hp) {
        uint32_t b[4];
        rba::ldmatrix_x4(b, w1c + (16 * hp + (lane & 7) + ((lane >> 4) << 3)) * YS + 16 * kc + ((lane >> 3) & 1) * 8);
        rba::mma_bf16(h[2 * hp], a, b[0], b[1]);
        rba::mma_bf16(h[2 * hp + 1], a, b[2], b[3]);
      }
    }

    // round, + b1 in bf16, gelu in fp32, round: tiles 2 k and 2 k + 1 are fc2's A fragment k
    uint32_t ga[HC / 16][4];
#pragma unroll
    for (int j = 0; j < HC / 8; ++j) {
      const int hid = chunk * HC + 8 * j + 2 * tq;
      const float c0 = rba::round_bf16(__ldg(b1 + hid)), c1 = rba::round_bf16(__ldg(b1 + hid + 1));
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = gelu(rba::round_bf16(rba::round_bf16(h[j][e]) + ((e & 1) ? c1 : c0)));
      ga[j / 2][2 * (j & 1)] = rba::pack_bf16(v[0], v[1]);
      ga[j / 2][2 * (j & 1) + 1] = rba::pack_bf16(v[2], v[3]);
    }

    // fc2: o (16, CS) += gelu (16, HC) . w2c[n0 .. n0 + CS)^T
#pragma unroll
    for (int kc = 0; kc < HC / 16; ++kc) {
#pragma unroll
      for (int np = 0; np < CS / 16; ++np) {
        uint32_t b[4];
        rba::ldmatrix_x4(b, w2c + (n0 + 16 * np + (lane & 7) + ((lane >> 4) << 3)) * WS + 16 * kc +
                                ((lane >> 3) & 1) * 8);
        rba::mma_bf16(o[2 * np], ga[kc], b[0], b[1]);
        rba::mma_bf16(o[2 * np + 1], ga[kc], b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is restaged two chunks on
  }

  // round, + b2 in bf16, + x in bf16
#pragma unroll
  for (int j = 0; j < CS / 8; ++j) {
    const int col = n0 + 8 * j + 2 * tq;
    const float c0 = rba::round_bf16(__ldg(b2 + col)), c1 = rba::round_bf16(__ldg(b2 + col + 1));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long tok = row0 + m0 + g + 8 * half;
      if (tok >= t_total) continue;
      const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + tok * C + col));
      const float y0 = xv.x + rba::round_bf16(rba::round_bf16(o[j][2 * half]) + c0);
      const float y1 = xv.y + rba::round_bf16(rba::round_bf16(o[j][2 * half + 1]) + c1);
      *reinterpret_cast<uint32_t*>(out + tok * C + col) = rba::pack_bf16(y0, y1);
    }
  }
}

template <int C>
int launch_mma(const void* x, const float* gamma, const float* beta, const void* w1, const float* b1,
               const void* w2, const float* b2, void* out, long long t, cudaStream_t stream) {
  using P = MmaTile<C>;
  static_assert(P::SMEM <= 232448, "shared memory of one block on sm_90");
  auto kernel = fused_mlp_mma_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (t + P::TM - 1) / P::TM;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, P::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), gamma, beta, static_cast<const __nv_bfloat16*>(w1), b1,
      static_cast<const __nv_bfloat16*>(w2), b2, static_cast<__nv_bfloat16*>(out), t);
  return (int)cudaGetLastError();
}

template <int C>
int launch(const void* x, const float* gamma, const float* beta, const void* w1, const float* b1, const void* w2,
           const float* b2, void* out, long long t, int is_bf16, cudaStream_t s) {
  return is_bf16 ? launch_mma<C>(x, gamma, beta, w1, b1, w2, b2, out, t, s)
                 : launch_fp32<C>(x, gamma, beta, w1, b1, w2, b2, out, t, s);
}

}  // namespace

extern "C" {

const char* rba_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x and out (t, c), w1 (4c, c) and w2 (c, 4c), all fp32 (is_bf16 = 0) or all bf16;
// gamma, beta, b2 (c) and b1 (4c) fp32; c in {128, 256, 384, 512}; x, w1, w2,
// gamma and beta 16-byte aligned.  Returns a cudaError_t.
int rba_fused_mlp(const void* x, const float* gamma, const float* beta, const void* w1, const float* b1,
                  const void* w2, const float* b2, void* out, long long t, int c, int is_bf16, void* stream) {
  if (t < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 128: return launch<128>(x, gamma, beta, w1, b1, w2, b2, out, t, is_bf16, s);
    case 256: return launch<256>(x, gamma, beta, w1, b1, w2, b2, out, t, is_bf16, s);
    case 384: return launch<384>(x, gamma, beta, w1, b1, w2, b2, out, t, is_bf16, s);
    case 512: return launch<512>(x, gamma, beta, w1, b1, w2, b2, out, t, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
