// Spatial-reduction attention core of SegFormer's Mix Transformer (MiT) for Hopper
// (sm_90a), bf16 on tensor cores (Kernel G), with a plain C interface for ctypes.
//
// Replaces no Pallas kernel: rba_tpu computes this core in plain jnp
// (rba_tpu/models/mix_transformer.py _attention), which XLA fuses, while eager
// PyTorch runs it as six to eight operations (models/mix_transformer.py
// sr_attention_plain) that write the whole (heads, N, M) score matrix to device
// memory four times: the product, the scaled product, the fp32 softmax and its
// bf16 cast, read again by the second product.  At MiT-B5's first stage of a
// 1024x2048 frame that matrix is 131,072 x 2,048, 512 MiB in bf16 a block.  This
// kernel keeps the scores in registers, one launch per block for every image and
// head.  Per (image, head), with the plain chain's roundings:
//     s   = bf16(q . k^T)            fp32 sums
//     s   = bf16(s * scale)          scale = bf16(hd^-0.5), as models/vit.py scaled
//                                    rounds it.  A power of two (0.125 at hd 64) scales
//                                    q exactly instead, and the product comes out
//                                    scaled: the same bf16 scores, one rounding
//     p   = bf16(exp(s - max) / sum) in fp32, as torch's fp32 softmax: expf, a
//                                    correctly rounded quotient
//     out = bf16(p . v)              fp32 sums, rounded once
// Only the order of the fp32 sums differs from the plain chain.
//
// Bound on the H100: operations.  q.k^T and p.v are 4 N M C per block (N queries,
// M keys, C = heads x hd); at MiT-B5 on a 1024x2048 image (M = 2,048 in every
// stage) 1.297 TFLOP, 1.31 ms at 989 TFLOP/s, against 0.76 GB of q, k, v and
// output read and written once in bf16, 0.23 ms at 3.35 TB/s.
//
// Two passes over the keys.  The plain chain rounds the normalised probability to
// bf16 before p . v; a one-pass (online) softmax rounds the unnormalised exponent
// and divides the sum at the end, another rounding.  So pass 1 streams the K tiles
// and keeps each row's fp32 running maximum and sum of exponentials (rescaled when
// the maximum grows); pass 2 streams K and V again, recomputes the scores, forms
// p = exp(s - max) / sum rounded to bf16 in registers and feeds it as the A operand
// of the p . v mma.  That is 1.5x the tensor work of one pass and two
// exponentials a score.
//
// What bounds it as built: the instructions the SMs issue, not the tensor cores.
// expf is 8 instructions (one on the special-function unit), the correctly rounded
// quotient 3, the roundings 1.5 a score: about 27 instructions a score over the two
// passes, 5.07 G scores an image.  The design keeps everything else off the issue
// slots and the tensor cores busy while the exponentials are computed:
//   - A block is one warpgroup (4 warps) and owns 64 query rows of one (image,
//     head), one 16-row tile per warp, so that the 40 blocks of MiT-B5's third stage
//     (640 blocks of rows) fill the card more evenly; 3 blocks an SM, with the
//     registers that wgmma's asynchronous accumulators need.  Each warp's q tile
//     goes from global memory straight into A fragments once.
//   - Both products are wgmma (m64nNk16, bf16 in, fp32 sums), asynchronous: A (q, or
//     p) from registers, B from shared memory by descriptor, k K-major and v
//     MN-major.  Pass 1 issues tile t + 1's q.k^T before it works on tile t's
//     scores; pass 2 forms tile t's p while tile t - 1's p.v runs, then issues tile
//     t + 1's q.k^T and tile t's p.v and rounds tile t + 1's scores while p.v runs
//     (two sets of p registers).
//   - The keys stream in tiles of 64 through a 4-stage ring in shared memory, two
//     tiles ahead: one thread asks the tensor memory accelerator for a tile's K (and
//     V in pass 2) box of the kv tensor map, counted on the buffer's mbarrier, so no
//     other thread spends an instruction on copies; keys past M land as zeros.  The
//     boxes are swizzled (128-byte rows at hd 64, 64-byte at 32) as wgmma's
//     descriptors read them.  One tile index runs over both passes.  A head's K and V
//     (at most 2 x 2,048 x 64 x 2 B = 512 KB) stay in L2 for every query tile of the
//     head; blocks of one head are neighbours in the grid.
//   - The mask of a ragged last tile is a branch of its own.
//   - q, k and v are read by strides from the linears' outputs, q (B, N, C) and
//     kv (B, M, 2C) with k in the first C columns and v in the last C, and the
//     output is written as (B, N, C): no transposes around the core.
//   - Ragged edges: query rows >= N read zeros and are not stored; key rows >= M
//     land as zeros and their scores are set to -inf (p = 0, and a zero v row, so
//     no NaN).  Any N >= 1 and M >= 1.

#include <cuda.h>  // CUtensorMap: the driver's types only; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <float.h>
#include <math.h>

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows of a block
constexpr int kKeys = 64;           // keys of a tile
constexpr int kStages = 4;          // tiles in the ring: t - 1 (p.v may still read it), t, t + 1, t + 2
constexpr int kNT = kKeys / 8;      // 8-key column tiles of the scores of a tile

template <int HD>
struct Ring {
  static constexpr uint32_t ROW = HD * 2;                 // bytes of a key's row in a shared tile
  static constexpr uint32_t TILE = kKeys * ROW;           // one K or V tile, 1024-byte aligned
  static constexpr uint32_t STAGE = 2 * TILE;             // K and V
  static constexpr size_t SMEM = kStages * STAGE + 1024;  // and room to align the ring
};

// e / sum, correctly rounded, from r = 1 / sum (correctly rounded): one fma step on
// the exact residual (Markstein), as quotient() in window_attention.cu; every
// probability a bf16 output can show is a normal float.
__device__ __forceinline__ float quotient(float e, float sum, float r) {
  const float q = e * r;
  return fmaf(fmaf(-sum, q, e), r, q);
}

// the two fp32 values of a packed bf16 pair
__device__ __forceinline__ float lo_bf16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// the (hd x 64 keys) box of the kv tensor map at column x, key y of image z into shared
// memory by the tensor memory accelerator, counted on the mbarrier `bar`; keys past the
// image's M land as zeros
__device__ __forceinline__ void tma_load(uint32_t smem, const CUtensorMap* map, int x, int y, int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(smem), "l"(map), "r"(x), "r"(y), "r"(z), "r"(rba::smem_u32(bar))
      : "memory");
}
// wgmma shared-memory descriptor: start address, leading and stride byte offsets (each in
// 16-byte units) and the swizzle, 1 (128-byte) or 2 (64-byte)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint32_t swizzle) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)swizzle << 62;
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// d (64 x 64, fp32, mma.cuh's C layout repeated over 8 8-column tiles) += a . b:
// a the warp's 16 x 16 bf16 rows of the warpgroup's 64 in registers, b (64 x 16 or 16 x 64)
// in shared memory by descriptor, K-major (TRANS_B 0) or MN-major (1); scale_d 0 ignores d
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TRANS_B));
}

// d (64 x 32, fp32, mma.cuh's C layout repeated over 4 8-column tiles) += a . b:
// a the warp's 16 x 16 bf16 rows of the warpgroup's 64 in registers, b (32 x 16 or 16 x 32)
// in shared memory by descriptor, K-major (TRANS_B 0) or MN-major (1); scale_d 0 ignores d
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n32(float (&d)[4][4], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TRANS_B));
}

// bf16(hd^-0.5) is a power of two at hd 64 (0.125) and not at hd 32
template <int HD>
constexpr bool kExactScale = HD == 64;

template <int HD>
__global__ void __launch_bounds__(kThreads, 3)
sr_attention_kernel(const __nv_bfloat16* __restrict__ q,     // (B, N, C)
                    const __grid_constant__ CUtensorMap kv,  // (B, M, 2C): k, then v; boxes of hd x 64 keys
                    __nv_bfloat16* __restrict__ out,         // (B, N, C)
                    int n, int m, int heads, float scale) {
  using R = Ring<HD>;
  constexpr bool EXACT = kExactScale<HD>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kStages];  // a buffer's mbarrier: its tile's bytes
  const uint32_t ring = (rba::smem_u32(smem_raw) + 1023) & ~1023u;  // kStages x (K, V)

  const int c = heads * HD;
  const int b = blockIdx.y / heads, head = blockIdx.y % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = blockIdx.x * kRows + 16 * warp + g, row1 = row0 + 8;  // the thread's query rows
  const int tiles = (m + kKeys - 1) / kKeys;

  if (threadIdx.x == 0)
    for (int i = 0; i < kStages; ++i) rba::mbar_init(&full[i], 1);
  __syncthreads();

  // Tile t < tiles: K of key tile t (pass 1); tiles <= t < 2 tiles: K and V of key
  // tile t - tiles (pass 2); past that nothing.  One thread asks the tensor memory
  // accelerator for a tile's boxes: no other instruction is spent on the copies.
  auto stage = [&](int t) {
    if (threadIdx.x != 0 || t >= 2 * tiles) return;
    const bool with_v = t >= tiles;
    const int key0 = (with_v ? t - tiles : t) * kKeys;
    uint64_t* bar = &full[t % kStages];
    const uint32_t dst = ring + t % kStages * R::STAGE;
    rba::fence_proxy_async();  // this buffer's earlier reads before the copies' writes
    rba::mbar_arrive_expect(bar, (with_v ? 2 : 1) * R::TILE);
    tma_load(dst, &kv, head * HD, key0, b, bar);
    if (with_v) tma_load(dst + R::TILE, &kv, c + head * HD, key0, b, bar);
  };
  auto landed = [&](int t) { rba::mbar_wait(&full[t % kStages], (uint32_t)(t / kStages) & 1); };
  stage(0);
  stage(1);

  // the warp's q tile as A fragments, straight from global memory; with a power-of-two
  // scale (EXACT) times the scale, exactly, so that q.k^T comes out scaled
  uint32_t qa[HD / 16][4];
  const __nv_bfloat16* qbase = q + (size_t)b * n * c + head * HD;
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r & 1 ? row1 : row0, col = 16 * kc + 2 * tq + (r & 2 ? 8 : 0);
      const uint32_t v = row < n ? __ldg(reinterpret_cast<const unsigned int*>(qbase + (size_t)row * c + col)) : 0u;
      qa[kc][r] = EXACT ? rba::pack_bf16(lo_bf16(v) * scale, hi_bf16(v) * scale) : v;
    }

  auto buffer = [&](int t) { return ring + t % kStages * R::STAGE; };
  auto first_key = [&](int t) { return (t < tiles ? t : t - tiles) * kKeys; };

  // q.k^T of the warpgroup's 64 rows and the K tile at ks (K-major, rows of hd values
  // swizzled as the tensor map lays them down): 16 hd values (32 bytes) a step, 8-key
  // groups 8 rows apart
  constexpr uint32_t kSwizzle = HD == 64 ? 1 : 2;
  auto qk = [&](uint32_t ks, float (&s)[kNT][4]) {
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) wgmma_n64<0>(s, qa[kc], smem_desc(ks + 32 * kc, 16, 8 * R::ROW, kSwizzle), kc);
    wgmma_commit();
  };
  // o += p.v of the 64 keys of the V tile at vs (MN-major): 16 keys a step
  float o[HD / 8][4];
  auto pv = [&](uint32_t vs, const uint32_t (&p)[kKeys / 16][4]) {
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < kKeys / 16; ++kt) {
      const uint64_t desc = smem_desc(vs + 16 * kt * R::ROW, R::TILE, 8 * R::ROW, kSwizzle);
      if constexpr (HD == 64) wgmma_n64<1>(o, p[kt], desc, 1);
      else wgmma_n32<1>(o, p[kt], desc, 1);
    }
    wgmma_commit();
  };
  // the scores of the tile that starts at key0 as the plain chain rounds them:
  // bf16(acc) (EXACT: acc is already scaled), else bf16(bf16(acc) * scale); keys >= m of
  // a ragged last tile get -inf
  auto round_scores = [&](float (&s)[kNT][4], int key0) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int h = 0; h < 4; h += 2) {
        uint32_t v = rba::pack_bf16(s[j][h], s[j][h + 1]);
        if (!EXACT) v = rba::pack_bf16(lo_bf16(v) * scale, hi_bf16(v) * scale);
        s[j][h] = lo_bf16(v);
        s[j][h + 1] = hi_bf16(v);
      }
    }
    if (key0 + kKeys > m) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int col = key0 + 8 * j + 2 * tq;
        if (col >= m) s[j][0] = s[j][2] = -INFINITY;
        if (col + 1 >= m) s[j][1] = s[j][3] = -INFINITY;
      }
    }
  };
  // tile t + 1 has landed and every warp is done with tile t - 2 (its p.v included),
  // whose buffer takes tile t + 2
  auto advance = [&](int t) {
    landed(t + 1);
    __syncthreads();
    stage(t + 2);
  };

  float s[kNT][4], sn[kNT][4];
  landed(0);
  qk(buffer(0), s);
  wgmma_wait<0>();
  round_scores(s, 0);

  // pass 1: each thread's running maximum and sum of exp(s - max) over its own columns
  // of rows row0 and row1; -FLT_MAX lies below every finite score, so a thread whose
  // columns are all masked keeps sum 0 and no NaN.  Step t issues tile t + 1's q.k^T
  // (the last step: pass 2's first tile) and works on tile t's scores meanwhile.
  float mx0 = -FLT_MAX, mx1 = -FLT_MAX, sum0 = 0.f, sum1 = 0.f;
  auto p1_step = [&](int t, float (&cur)[kNT][4], float (&next)[kNT][4]) {
    advance(t);
    qk(buffer(t + 1), next);
    float t0 = mx0, t1 = mx1;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      t0 = fmaxf(t0, fmaxf(cur[j][0], cur[j][1]));
      t1 = fmaxf(t1, fmaxf(cur[j][2], cur[j][3]));
    }
    sum0 *= expf(mx0 - t0);
    sum1 *= expf(mx1 - t1);
    mx0 = t0, mx1 = t1;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      sum0 += expf(cur[j][0] - mx0) + expf(cur[j][1] - mx0);
      sum1 += expf(cur[j][2] - mx1) + expf(cur[j][3] - mx1);
    }
    wgmma_wait<0>();
    round_scores(next, first_key(t + 1));
  };
  int t = 0;
  for (; t + 1 < tiles; t += 2) {
    p1_step(t, s, sn);
    p1_step(t + 1, sn, s);
  }
  if (t < tiles) {  // an odd number of tiles: the last step's scores land in sn
    p1_step(t, s, sn);
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = sn[j][0], s[j][1] = sn[j][1], s[j][2] = sn[j][2], s[j][3] = sn[j][3];
  }
  // the row's maximum and sum over the quad that holds it; both lanes of a pair compute
  // the same commutative sum, so the four agree
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    const float om0 = __shfl_xor_sync(0xffffffffu, mx0, x), os0 = __shfl_xor_sync(0xffffffffu, sum0, x);
    const float om1 = __shfl_xor_sync(0xffffffffu, mx1, x), os1 = __shfl_xor_sync(0xffffffffu, sum1, x);
    const float n0 = fmaxf(mx0, om0), n1 = fmaxf(mx1, om1);
    sum0 = sum0 * expf(mx0 - n0) + os0 * expf(om0 - n0);
    sum1 = sum1 * expf(mx1 - n1) + os1 * expf(om1 - n1);
    mx0 = n0, mx1 = n1;
  }
  const float r0 = 1.f / sum0, r1 = 1.f / sum1;

  // pass 2: p = exp(s - max) / sum rounded to bf16, the probabilities of 8-key tiles
  // 2 kt and 2 kt + 1 packed as the A fragment of 16-key step kt, in one of two sets:
  // the other may still feed the previous tile's p.v.  Step t then issues tile t + 1's
  // q.k^T and tile t's p.v, and rounds tile t + 1's scores while p.v runs.
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  uint32_t pa[kKeys / 16][4], pb[kKeys / 16][4];
  auto p2_step = [&](int t, uint32_t (&p)[kKeys / 16][4], auto more) {
    if constexpr (decltype(more)::value) advance(t);
#pragma unroll
    for (int kt = 0; kt < kKeys / 16; ++kt) {
      p[kt][0] = rba::pack_bf16(quotient(expf(s[2 * kt][0] - mx0), sum0, r0), quotient(expf(s[2 * kt][1] - mx0), sum0, r0));
      p[kt][1] = rba::pack_bf16(quotient(expf(s[2 * kt][2] - mx1), sum1, r1), quotient(expf(s[2 * kt][3] - mx1), sum1, r1));
      p[kt][2] = rba::pack_bf16(quotient(expf(s[2 * kt + 1][0] - mx0), sum0, r0),
                                quotient(expf(s[2 * kt + 1][1] - mx0), sum0, r0));
      p[kt][3] = rba::pack_bf16(quotient(expf(s[2 * kt + 1][2] - mx1), sum1, r1),
                                quotient(expf(s[2 * kt + 1][3] - mx1), sum1, r1));
    }
    if constexpr (decltype(more)::value) qk(buffer(t + 1), s);
    pv(buffer(t) + R::TILE, p);
    if constexpr (decltype(more)::value) {
      wgmma_wait<1>();  // q.k^T of tile t + 1 is done; p.v of tile t may run on
      round_scores(s, first_key(t + 1));
    }
  };
  for (t = tiles; t + 2 < 2 * tiles; t += 2) {
    p2_step(t, pa, std::true_type{});
    p2_step(t + 1, pb, std::true_type{});
  }
  if (t + 1 < 2 * tiles) {
    p2_step(t, pa, std::true_type{});
    p2_step(t + 1, pb, std::false_type{});
  } else {
    p2_step(t, pa, std::false_type{});
  }
  wgmma_wait<0>();

  __nv_bfloat16* obase = out + (size_t)b * n * c + head * HD;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int d = 8 * j + 2 * tq;
    if (row0 < n) *reinterpret_cast<uint32_t*>(obase + (size_t)row0 * c + d) = rba::pack_bf16(o[j][0], o[j][1]);
    if (row1 < n) *reinterpret_cast<uint32_t*>(obase + (size_t)row1 * c + d) = rba::pack_bf16(o[j][2], o[j][3]);
  }
}

// kv (b, m, 2 c) bf16 as a tensor map of boxes of hd values x 64 keys, swizzled as the
// kernel reads them
int kv_map(CUtensorMap* map, const void* kv, int b, int m, int c, int hd) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
                                                    cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || !encode) return (int)cudaErrorSymbolNotFound;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)2 * c, (cuuint64_t)m, (cuuint64_t)b};
  const cuuint64_t strides[2] = {(cuuint64_t)4 * c, (cuuint64_t)m * 4 * c};  // bytes between keys, images
  const cuuint32_t box[3] = {(cuuint32_t)hd, (cuuint32_t)kKeys, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(kv), dims, strides, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE,
                              hd == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD>
int launch(const void* q, const void* kv, void* out, int b, int n, int m, int heads, float scale,
           cudaStream_t stream) {
  CUtensorMap map;
  int err = kv_map(&map, kv, b, m, heads * HD, HD);
  if (err) return err;
  auto kernel = sr_attention_kernel<HD>;
  // above 48 KB of dynamic shared memory, on whichever device is current
  err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Ring<HD>::SMEM);
  if (err) return err;
  const dim3 grid((unsigned)((n + kRows - 1) / kRows), (unsigned)(b * heads));
  kernel<<<grid, kThreads, Ring<HD>::SMEM, stream>>>(static_cast<const __nv_bfloat16*>(q), map,
                                                      static_cast<__nv_bfloat16*>(out), n, m, heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rba_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// q (b, n, heads * hd) and out (b, n, heads * hd), kv (b, m, 2 * heads * hd), all bf16,
// contiguous, 16-byte aligned; hd 32 or 64; scale the bf16 value of hd^-0.5 as a float.
// The Python wrapper (kernels/sr_attention.py) checks these and the sizes.  Returns a
// cudaError_t.
int rba_sr_attention(const void* q, const void* kv, void* out, int b, int n, int m, int heads, int hd, float scale,
                     void* stream) {
  if (b < 1 || n < 1 || m < 1 || heads < 1 || (long long)b * heads > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch<64>(q, kv, out, b, n, m, heads, scale, s);
  if (hd == 32) return launch<32>(q, kv, out, b, n, m, heads, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
