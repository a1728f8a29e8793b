// Fused Swin MLP block tail for Hopper (sm_90a), with a plain C interface for ctypes:
//     out = x + fc2(gelu(fc1(LayerNorm(x))))
// with the (T, 4C) hidden tensor never written to device memory.
//
// Replaces the Pallas kernel of rba_tpu/ops/pallas/fused_mlp.py
// (fused_mlp_residual -> _fused_mlp_flat, body _kernel).  Its dtype placement
// is kept, with T the compute dtype (bf16 or fp32):
//   - LayerNorm moments E[x] and E[x^2] in fp32, variance clamped at >= 0,
//     eps 1e-5; gamma, beta and every weight and bias rounded to T, as the
//     Pallas wrapper casts them; the normalised row rounded to T;
//   - each product accumulated in fp32 and rounded to T before its bias add,
//     the add done in T;
//   - exact gelu, 0.5 h (1 + erff(h / sqrt 2)) in fp32, rounded to T (the
//     Pallas kernel's polynomial erf was a Mosaic workaround);
//   - the residual add in T.
// Weights come in nn.Linear's (out, in) layout, fp32, and are rounded as they
// are staged, so the caller makes no transposed or cast copy.
//
// Bound on the H100: operations.  At Swin-B 1024x2048 stage 0 (T = 131072,
// C = 128) and stage 1 (T = 32768, C = 256) one call is 2 * 2 * T * C * 4C =
// 34.4 GFLOP against 67 MB (stage 0, bf16) of x read and out written: 35 us at
// the bf16 tensor-core peak, 20 us at 3.35 TB/s.  This first design is simple,
// not fast: the products run on CUDA cores in fp32.  One block of 256 threads
// per tile of TM tokens (64 at C = 128, 32 above, so that the fp32 output tile
// stays in registers) normalises its rows into shared memory, then walks the
// hidden units in chunks of 32: it stages the chunk's 32 rows of w1 and 32
// columns of w2, computes the (TM, 32) hidden chunk with bias and gelu into
// shared memory, and adds its product with the w2 columns to the (TM, C)
// accumulator.  Shared rows are padded by 4 floats, so the lanes' float4 loads
// of 8 different rows fall on different banks.  Tensor cores (mma / wgmma)
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHC = 32;   // hidden units per chunk, one per lane
constexpr int kPad = 4;   // floats of padding per shared-memory row

template <int C>
__host__ __device__ constexpr int tile_tokens() { return C <= 128 ? 64 : 32; }

template <int C>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(tile_tokens<C>() + kHC) * (C + kPad) + (size_t)(C + tile_tokens<C>()) * (kHC + kPad));
}

// v rounded to T's precision, kept as float
template <typename T>
__device__ __forceinline__ float rnd(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__device__ __forceinline__ float4 rnd4(float4 w) {
  return make_float4(rnd<T>(w.x), rnd<T>(w.y), rnd<T>(w.z), rnd<T>(w.w));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
                 const float* __restrict__ w1, const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, T* __restrict__ out, long long t_total) {
  constexpr int TM = tile_tokens<C>();
  constexpr int H = 4 * C;
  constexpr int YS = C + kPad;    // row stride of ys and w1s
  constexpr int HS = kHC + kPad;  // row stride of w2s and hs
  constexpr int RPT = TM / kWarps;  // rows per thread: warp, warp + 8, ...
  constexpr int CPT = C / 32;       // columns per thread: lane, lane + 32, ...

  extern __shared__ float4 smem4[];
  float* ys = reinterpret_cast<float*>(smem4);  // TM x YS: LayerNorm(x) rounded to T
  float* w1s = ys + TM * YS;                    // kHC x YS: rows h0 .. h0 + 31 of w1
  float* w2s = w1s + kHC * YS;                  // C x HS: columns h0 .. h0 + 31 of w2
  float* hs = w2s + C * HS;                     // TM x HS: gelu(fc1) of the chunk, rounded to T

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row0 = (long long)blockIdx.x * TM;

  // LayerNorm, one warp per row
  for (int r = warp; r < TM; r += kWarps) {
    const long long tok = row0 + r;
    float xv[CPT];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      xv[u] = tok < t_total ? to_float(x[tok * C + lane + 32 * u]) : 0.f;
      s1 += xv[u];
      s2 = fmaf(xv[u], xv[u], s2);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mean = s1 / C;
    const float inv = rsqrtf(fmaxf(s2 / C - mean * mean, 0.f) + 1e-5f);
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const int c = lane + 32 * u;
      ys[r * YS + c] = rnd<T>((xv[u] - mean) * inv * rnd<T>(gamma[c]) + rnd<T>(beta[c]));
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
      const float4 w = reinterpret_cast<const float4*>(w1 + (size_t)(h0 + j) * C)[k4];
      *reinterpret_cast<float4*>(w1s + j * YS + 4 * k4) = rnd4<T>(w);
    }
    for (int idx = threadIdx.x; idx < C * kHC / 4; idx += kThreads) {
      const int n = idx / (kHC / 4), k4 = idx % (kHC / 4);
      const float4 w = reinterpret_cast<const float4*>(w2 + (size_t)n * H + h0)[k4];
      *reinterpret_cast<float4*>(w2s + n * HS + 4 * k4) = rnd4<T>(w);
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
      const float bias = rnd<T>(b1[h0 + lane]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float h = rnd<T>(rnd<T>(hacc[i]) + bias);
        hs[(warp + kWarps * i) * HS + lane] = rnd<T>(0.5f * h * (1.f + erff(h * 0.70710678118654752f)));
      }
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
      const float o = rnd<T>(rnd<T>(acc[i][u]) + rnd<T>(b2[c]));
      store(out + tok * C + c, to_float(x[tok * C + c]) + o);
    }
  }
}

template <typename T, int C>
int launch(const void* x, const float* gamma, const float* beta, const float* w1, const float* b1,
           const float* w2, const float* b2, void* out, long long t, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<C>();
  static_assert(smem <= 232448, "shared memory of one block on sm_90");
  auto kernel = fused_mlp_kernel<T, C>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (t + tile_tokens<C>() - 1) / tile_tokens<C>();
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), gamma, beta, w1, b1, w2, b2, static_cast<T*>(out), t);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const float* gamma, const float* beta, const float* w1, const float* b1,
             const float* w2, const float* b2, void* out, long long t, int c, cudaStream_t s) {
  switch (c) {
    case 128: return launch<T, 128>(x, gamma, beta, w1, b1, w2, b2, out, t, s);
    case 256: return launch<T, 256>(x, gamma, beta, w1, b1, w2, b2, out, t, s);
    case 384: return launch<T, 384>(x, gamma, beta, w1, b1, w2, b2, out, t, s);
    case 512: return launch<T, 512>(x, gamma, beta, w1, b1, w2, b2, out, t, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* rba_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x and out (t, c), both fp32 (is_bf16 = 0) or bf16; gamma, beta, b2 (c), w1 (4c, c),
// b1 (4c), w2 (c, 4c), all fp32; c in {128, 256, 384, 512}; w1 and w2 16-byte
// aligned.  Returns a cudaError_t.
int rba_fused_mlp(const void* x, const float* gamma, const float* beta, const float* w1, const float* b1,
                  const float* w2, const float* b2, void* out, long long t, int c, int is_bf16, void* stream) {
  if (t < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(x, gamma, beta, w1, b1, w2, b2, out, t, c, s)
                 : dispatch<float>(x, gamma, beta, w1, b1, w2, b2, out, t, c, s);
}

}  // extern "C"
