// Attention core with decomposed relative positions (ViTDet's and MViTv2's) for Hopper
// (sm_90a), bf16 on tensor cores (Kernel H), with a plain C interface for ctypes.
//
// Replaces no Pallas kernel: rba_tpu computes this core in plain jnp
// (rba_tpu/models/vit.py _attention), which XLA fuses, while eager PyTorch runs it as
// ten to twelve operations (models/vit.py rel_pos_attention_plain) that write the
// (calls, queries, keys) score matrix to device memory and read it back several times:
// the product, the two position adds with their broadcasts, the fp32 cast, the softmax
// and its bf16 cast, about 30 bytes a score.  At MViTv2-B on a 1024x2048 frame that is
// 0.516 G scores over 24 calls.  This kernel keeps the scores on chip, one launch a
// call for every window, image and head.  Per (window or image, head), with the plain
// chain's roundings:
//     s   = bf16(bf16(q * scale) . k^T)   scale = bf16(hd^-0.5), as models/vit.py
//                                         scaled rounds it; fp32 sums
//     s   = bf16(bf16(s + rel_h[i, j_h]) + rel_w[i, j_w])
//                                         rel_h = bf16(q . R_h[i_h]^T), rel_w =
//                                         bf16(q . R_w[i_w]^T) from the unscaled q,
//                                         fp32 sums; key j = j_h kw + j_w
//     p   = bf16(exp(s - max) / sum)      in fp32, as torch's fp32 softmax: expf, a
//                                         correctly rounded quotient
//     out = bf16(p . v)                   fp32 sums, rounded once
// Only the order of the fp32 sums differs from the plain chain.  Padded windows are
// computed as the chain computes them: zero rows, keys like any other, no mask.
//
// Bound on the H100: bytes.  q.k^T, p.v and the two position products are 0.207
// TFLOP an MViTv2-B image, 0.21 ms at 989 TFLOP/s; q, k, v and the output once in
// bf16 are 0.830 GB, 0.248 ms at 3.35 TB/s.  Neither is near: as in Kernel G, what
// bounds it as built is the instructions the SMs issue around each score (the
// roundings, the position adds, expf and the quotient) and, on the many small windowed
// calls, each block's fixed latency.  Clock stamps of a 196-key window's block on an
// H100 (about 27,000 cycles): the position products a third (their loads and the
// gathers, one dependent global read after another), the softmax a third, the rest
// q's loads, the two products and the stores; a streaming block spends about 85 % in
// its two passes, 15 % asking for tiles (below).  The design:
//   - A warpgroup (4 warps) owns 64 query rows of one (window or image, head), a
//     16-row tile a warp; q goes from global memory straight into A fragments once,
//     times bf16(hd^-0.5) rounded to bf16 (the chain scales q, not the product).  Both
//     products are wgmma (m64n64k16 for q.k^T, m64n32k16 a part for p.v; bf16
//     in, fp32 sums), A from registers, B from shared memory in the 64-byte swizzle: K
//     and V land as parts of 32 values of the head, each key's 64 bytes a row, one box
//     of the tensor memory accelerator (32 values x 64 or 256 keys) a part, asked for by
//     one thread and counted on an mbarrier, keys past the last as zeros; p.v runs a
//     m64n32k16 a part.  The accelerator moves a box row by row, about two cycles a row:
//     Kernel G's boxes of 16-byte rows (8 values, no swizzle) held the thread that asks
//     for a third of a window's block and of a streaming block's loop.
//   - Two regimes, chosen by the key count alone.  A window of up to 256 keys (49 and
//     196 on MViTv2-B, 196 on ViTDet-B) is resident: its whole K and V land at once,
//     one warpgroup a block and two blocks an SM, the scores stay in registers and one
//     pass takes the exact row maximum, exp once, the sum, rounds p and runs p.v.  More
//     keys (784 and 2,048 on MViTv2-B, 8,192 on ViTDet-B) stream in tiles of 64 through
//     a 5-tile ring, three ahead, two warpgroups (128 rows) sharing each tile, over two
//     passes as in Kernel G: the chain rounds the normalised probability to bf16 before
//     p.v, so pass 1 keeps each row's fp32 running maximum and sum, and pass 2
//     recomputes the scores, forms p in registers and feeds it to p.v.  Pass 1 issues
//     tile t + 1's q.k^T before it works on tile t's scores; pass 2 overlaps tile t's
//     p.v with tile t + 1's scores (two sets of p registers).
//   - The position terms of a warp's 16 rows are made once, first, on the tensor cores
//     (mma.sync) from the unscaled q, rounded to bf16 into a shared table a row: rel_w's
//     kw values, then rel_h's kh values each doubled into a 32-bit word, rows 4 mod 8
//     words apart so that the 8 rows of a warp's reads meet no bank twice.  The rows
//     share one or a few i_h: R_h comes gathered, and its rows for those i_h are the B
//     columns.  Their 16 i_w differ, but the gathers R_w[i_w, j_w] = R'[index[i_w, j_w]]
//     of the resampled table meet one short range of entries (i_w - j_w, scaled): the
//     product runs over that range (27 to 268 entries against 16 kw gathered rows) into
//     scratch rows, and each row gathers its kw values through the index.
//   - Where kw is even and at least 8, two neighbouring keys share their j_h, so a pair
//     of scores takes one 32-bit read of each table and two bf16x2 adds (fma.rn.bf16x2
//     by one, a single rounding, as fp32 add then round gives for two bf16 values);
//     (j_h, j_w) advance by 8 keys with one compare.  Other kw (7 on MViTv2-B's last
//     windows) take a path per score.
//   - Ragged edges: query rows >= N read zeros and are not stored; keys >= M land as
//     zeros and their scores are -inf (p = 0 against a zero v row, so no NaN); 8-key
//     tiles past M are skipped where no wgmma is in flight (resident), else masked by
//     selects: a branch around an accumulator of an asynchronous wgmma serializes them.
//   - q is read by its three strides, two values as one 32-bit word where its last dim
//     is dense, else one by one: the global blocks' q, pooled channel-major, is read as it
//     lies.  k and v are read by tensor maps, which take rows 16-byte aligned with the
//     last dim dense (kernels/rel_pos_attention.py readable copies any other k or v
//     first); the output is written (calls, N, hd).
//   - The tables come from a second, small kernel (rel_pos_tables_kernel), one launch a
//     call in place of the five operations of the plain version: each entry's two taps of
//     the fp32 table times their weights, each product rounded, then their sum, rounded
//     to bf16, as rel_pos_resampled and its cast round it.

#include <cuda.h>  // CUtensorMap's type only; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int kKeys = 64;           // keys of a tile
constexpr int kNT = kKeys / 8;      // 8-key column tiles of a tile's scores
constexpr int kGroup = 8;           // 8-column tiles of a position product loaded at once
constexpr int kEntries = 128;       // entries of R_w a warp multiplies at once, into its scratch rows
constexpr int kEntriesResident = 64;  // the same where the window is resident: two blocks an SM
constexpr int kBatch = 8;           // gather indices a lane loads at once

// A K or V tile of 64 keys in shared memory as wgmma reads it in the 64-byte swizzle:
// the head in parts of 32 values (PART bytes apart), a part's 64 keys in rows of 64
// bytes, the 16-byte chunks of row r xor-ed with (r / 2) % 4, as one box of the tensor
// memory accelerator lands them; 8 rows (512 bytes) are a swizzle atom, the stride
// between 8-key groups (and between 8-key steps of p.v).  WG warpgroups a block, 64 query
// rows each; the ring holds STAGES tiles: t - 1 (p.v may still read it), t, and the
// STAGES - 2 tiles ahead.
template <int HD, int WG>
struct Ring {
  static constexpr int WARPS = 4 * WG, THREADS = 32 * WARPS, ROWS = 16 * WARPS;
  static constexpr int STAGES = WG + 3, AHEAD = STAGES - 2;
  static constexpr uint32_t PART = kKeys * 64;             // bytes between parts of 32 values
  static constexpr uint32_t TILE = kKeys * HD * 2;          // one K or V tile
  static constexpr uint32_t BYTES = STAGES * 2 * TILE;      // K and V
  // the position products' scratch rows take the ring's last two buffers before the keys do
  static_assert(WARPS * 16 * kEntries * 2 <= 2 * 2 * TILE, "scratch rows in two buffers");
};

struct Params {
  const __nv_bfloat16* q;   // (calls, nq, hd) by strides q_b, q_r, q_c
  const __nv_bfloat16* k;   // (calls, nk, hd) by strides k_b, k_r
  const __nv_bfloat16* v;   // (calls, nk, hd) by strides v_b, v_r
  const __nv_bfloat16* rh;  // (qh, kh, hd) dense: R_h resampled and gathered, as bf16
  const __nv_bfloat16* rw;  // (lw, hd) dense: R_w resampled, as bf16, before its gather
  const int* iw_index;      // (qw, kw): the entry of rw that (i_w, j_w) gathers; monotone in both
  __nv_bfloat16* out;       // (calls, nq, hd) dense
  long long q_b, q_r, q_c, k_b, k_r, v_b, v_r;
  bool q_pairs;  // q_c is 1 and each (row, 2c) starts a 32-bit word: q read two values at once
  int nq, nk, qh, qw, kh, kw;
  int kwp;  // bf16 offset of rel_h in a row of the shared table: kw rounded up to even
  int ld;   // bf16 row stride of the shared table: kwp + 2 kh, padded to 4 mod 8 words
  float scale;
};

// the (32 values x 64 or 256 keys) box of a (calls, keys, hd) tensor map at value x, key y of
// call z into shared memory by the tensor memory accelerator, counted on the mbarrier
// `bar`; keys past the call's last land as zeros
__device__ __forceinline__ void tma_load(uint32_t smem, const CUtensorMap* map, int x, int y, int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(smem), "l"(map), "r"(x), "r"(y), "r"(z), "r"(rba::smem_u32(bar))
      : "memory");
}

// the two fp32 values of a packed bf16 pair
__device__ __forceinline__ float lo_bf16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// a + b per bf16 half, each rounded once to nearest even: a * 1 + b in one fma
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(0x3f803f80u), "r"(b));
  return d;
}

// e / sum, correctly rounded, from r = 1 / sum (correctly rounded): one fma step on
// the exact residual, as quotient() in window_attention.cu and sr_attention.cu
__device__ __forceinline__ float quotient(float e, float sum, float r) {
  const float q = e * r;
  return fmaf(fmaf(-sum, q, e), r, q);
}

// wgmma shared-memory descriptor of a 64-byte-swizzled operand (layout type 2) whose
// 8-row atoms lie 512 bytes apart: start address; both byte offsets 512, since no
// operand here spans more than one atom across its rows' 32 values (the other offset)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | (uint64_t)(512 >> 4) << 16 | (uint64_t)(512 >> 4) << 32 |
         (uint64_t)2 << 62;
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 64, fp32, mma.cuh's C layout over 8 8-column tiles) += a . b: a the warp's
// 16 x 16 bf16 rows of the warpgroup's 64 in registers, b (64 x 16) K-major in shared
// memory by descriptor; scale_d 0 ignores d
__device__ __forceinline__ void wgmma_n64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// the 32 columns from 8 P of d (64 x HD, fp32, mma.cuh's C layout over 8-column tiles)
// += a . b, b (16 x 32) MN-major in shared memory by descriptor
template <int P, int N>
__device__ __forceinline__ void wgmma_n32_t(float (&d)[N][4], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
      : "+f"(d[P][0]), "+f"(d[P][1]), "+f"(d[P][2]), "+f"(d[P][3]),
        "+f"(d[P + 1][0]), "+f"(d[P + 1][1]), "+f"(d[P + 1][2]), "+f"(d[P + 1][3]),
        "+f"(d[P + 2][0]), "+f"(d[P + 2][1]), "+f"(d[P + 2][2]), "+f"(d[P + 2][3]),
        "+f"(d[P + 3][0]), "+f"(d[P + 3][1]), "+f"(d[P + 3][2]), "+f"(d[P + 3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

// o (64 x HD) += p . v of 16 keys: p the warp's A fragment, v's 16 rows at vs in parts
// `part` bytes apart, one m64n32k16 a part
template <int HD>
__device__ __forceinline__ void pv_step(float (&o)[HD / 8][4], const uint32_t (&a)[4], uint32_t vs, uint32_t part) {
  wgmma_n32_t<0>(o, a, smem_desc(vs));
  wgmma_n32_t<4>(o, a, smem_desc(vs + part));
  if constexpr (HD == 96) wgmma_n32_t<8>(o, a, smem_desc(vs + 2 * part));
}

// FAST: kw is even and at least 8, so the pair of keys (2c, 2c + 1) shares its j_h and
// (j_h, j_w) move across an 8-key tile with one compare
template <int HD, bool FAST, int WG, int NT>
__global__ void __launch_bounds__(Ring<HD, WG>::THREADS, 3 - WG) rel_pos_attention_kernel(const Params p,
                                                                             const __grid_constant__ CUtensorMap kmap,
                                                                             const __grid_constant__ CUtensorMap vmap) {
  static_assert(NT == 0 || (WG == 1 && NT <= Ring<HD, WG>::STAGES), "a resident window fits the ring");
  using R = Ring<HD, WG>;
  constexpr int kThreads = R::THREADS, kRows = R::ROWS, kStages = R::STAGES;
  constexpr int ENTRIES = NT > 0 ? kEntriesResident : kEntries;
  constexpr int PARTS = HD / 32, KC = HD / 16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (rba::smem_u32(smem_raw) + 1023) & ~1023u;  // kStages x (K, V), on swizzle atoms
  __nv_bfloat16* table = reinterpret_cast<__nv_bfloat16*>(smem_raw + (ring - rba::smem_u32(smem_raw)) + R::BYTES);

  const int call = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = blockIdx.x * kRows + 16 * warp;  // the warp's first query row
  const int row0 = r0 + g, row1 = row0 + 8;        // the thread's query rows
  const bool active = r0 < p.nq;                   // some row of the warp exists
  const int tiles = (p.nk + kKeys - 1) / kKeys;

  // K (and V) of the 64 keys from key0 into the ring's buffer slot, keys past nk as
  // zeros: one thread asks the tensor memory accelerator for a box a chunk, counted on
  // the slot's mbarrier, so no other thread spends an instruction on copies.
  __shared__ uint64_t full[kStages];
  if (threadIdx.x == 0)
    for (int i = 0; i < kStages; ++i) rba::mbar_init(&full[i], 1);
  __syncthreads();
  auto copy_tile = [&](int slot, int key0, bool with_v) {
    if (threadIdx.x != 0) return;
    const uint32_t ks = ring + slot * 2 * R::TILE;
    rba::fence_proxy_async();  // this buffer's earlier reads before the copies' writes
    rba::mbar_arrive_expect(&full[slot], (with_v ? 2 : 1) * R::TILE);
#pragma unroll
    for (int pt = 0; pt < PARTS; ++pt) {
      tma_load(ks + pt * R::PART, &kmap, 32 * pt, key0, call, &full[slot]);
      if (with_v) tma_load(ks + R::TILE + pt * R::PART, &vmap, 32 * pt, key0, call, &full[slot]);
    }
  };
  auto landed = [&](int slot, int use) { rba::mbar_wait(&full[slot], (uint32_t)use & 1); };
  // Streaming, tile t < tiles: K of key tile t (pass 1); tiles <= t < 2 tiles: K and V
  // of key tile t - tiles (pass 2).  Resident (NT tiles): K and V of tile i in slot i,
  // all at once.
  auto stage = [&](int t) {
    if (t < 2 * tiles) copy_tile(t % kStages, (t < tiles ? t : t - tiles) * kKeys, t >= tiles);
  };
  auto buffer = [&](int t) { return ring + t % kStages * 2 * R::TILE; };
  auto first_key = [&](int t) { return (t < tiles ? t : t - tiles) * kKeys; };
  // Resident: the window's K, then its V, each a part at a time of NT x 64 keys
  // (RES_PART bytes apart), one box a part, all on slot 0's mbarrier
  constexpr uint32_t RES_PART = NT * R::PART;
  if constexpr (NT > 0) {
    if (threadIdx.x == 0) {
      rba::mbar_arrive_expect(&full[0], 2 * NT * R::TILE);
#pragma unroll
      for (int pt = 0; pt < PARTS; ++pt) {
        tma_load(ring + pt * RES_PART, &kmap, 32 * pt, 0, call, &full[0]);
        tma_load(ring + NT * R::TILE + pt * RES_PART, &vmap, 32 * pt, 0, call, &full[0]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < R::AHEAD; ++i) stage(i);
  }

  // the warp's q tile as A fragments, straight from global memory
  uint32_t qa[KC][4];
  const __nv_bfloat16* qbase = p.q + call * p.q_b;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r & 1 ? row1 : row0, col = 16 * kc + 2 * tq + (r & 2 ? 8 : 0);
      const __nv_bfloat16* at = qbase + row * p.q_r + col * p.q_c;
      const unsigned short* half = reinterpret_cast<const unsigned short*>(at);
      qa[kc][r] = row >= p.nq  ? 0u
                  : p.q_pairs ? __ldg(reinterpret_cast<const unsigned int*>(at))
                              : (unsigned int)__ldg(half) | (unsigned int)__ldg(half + p.q_c) << 16;
    }

  // The position terms of the warp's rows into the shared table, from the unscaled q.
  // Rows past N take the last row's indices (their values are not stored).
  __nv_bfloat16* w0 = table + (16 * warp + g) * p.ld;  // row0's rel_w; its rel_h at + kwp
  __nv_bfloat16* w1 = w0 + 8 * p.ld;
  const uint32_t* h0 = reinterpret_cast<const uint32_t*>(w0 + p.kwp);
  const uint32_t* h1 = reinterpret_cast<const uint32_t*>(w1 + p.kwp);
  if (active) {
    const int last = p.nq - 1, c0 = min(row0, last), c1 = min(row1, last), rl = min(r0 + 15, last);
    // C (16 rows x cols) = q . T^T for the first cols rows of a (rows, hd) table T,
    // kGroup 8-column tiles at a time; keep(n, d) takes the four values of 8-column
    // tile n (mma.cuh's C layout)
    auto product = [&](const __nv_bfloat16* tab, int cols, auto keep) {
      for (int n0 = 0; n0 < cols; n0 += 8 * kGroup) {
        uint32_t bf[kGroup][KC][2];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const int c = n0 + 8 * u + g;
          const bool ok = c < cols;
          const unsigned int* src = reinterpret_cast<const unsigned int*>(tab + (size_t)(ok ? c : 0) * HD + 2 * tq);
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) {
            bf[u][kc][0] = ok ? __ldg(src + 8 * kc) : 0u;
            bf[u][kc][1] = ok ? __ldg(src + 8 * kc + 4) : 0u;
          }
        }
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) rba::mma_bf16(d, qa[kc], bf[u][kc][0], bf[u][kc][1]);
          keep(n0 + 8 * u, d);
        }
      }
    };
    // rel_h: the rows i_h0 .. i_h(rl) of the gathered R_h, kh columns each, in order;
    // row r keeps its own i_h's, doubled into 32-bit words
    const int ih0 = r0 / p.qw, offh0 = (c0 / p.qw - ih0) * p.kh, offh1 = (c1 / p.qw - ih0) * p.kh;
    product(p.rh + (size_t)ih0 * p.kh * HD, (rl / p.qw - ih0 + 1) * p.kh, [&](int n, const float (&d)[4]) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = n + 2 * tq + (e & 1) - (e < 2 ? offh0 : offh1);
        if (t < 0 || t >= p.kh) continue;
        const __nv_bfloat16 x = __float2bfloat16(d[e]);
        const uint32_t bits = *reinterpret_cast<const unsigned short*>(&x);
        reinterpret_cast<uint32_t*>((e < 2 ? w0 : w1) + p.kwp)[t] = bits | bits << 16;
      }
    });
    // rel_w: the rows' 16 i_w differ, but their gathers meet one range of entries of
    // the resampled R_w (i_w - j_w, scaled, plus a constant): the product runs over that
    // range, ENTRIES at a time, into the warp's scratch rows, and each row gathers its
    // kw values from there.  The range's ends are the index map's corners.
    int lo = min(__ldg(p.iw_index + (c0 % p.qw) * p.kw + p.kw - 1), __ldg(p.iw_index + (c1 % p.qw) * p.kw + p.kw - 1));
    int hi = max(__ldg(p.iw_index + (c0 % p.qw) * p.kw), __ldg(p.iw_index + (c1 % p.qw) * p.kw));
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    // a streaming block's scratch rows lie in the ring's last two buffers, free until
    // the loop; a resident window's, whose K and V fill the ring, after the table
    __nv_bfloat16* scratch = (NT > 0 ? table + kRows * p.ld : reinterpret_cast<__nv_bfloat16*>(table) - 2 * R::TILE) +
                             warp * 16 * ENTRIES;
    // lane (rr, par) gathers row rr's j = par, par + 2, ..., kBatch indices loaded at once
    const int rr = lane >> 1, par = lane & 1;
    const int* irow = p.iw_index + (size_t)(min(r0 + rr, last) % p.qw) * p.kw;
    __nv_bfloat16* wrow = table + (16 * warp + rr) * p.ld;
    for (int e0 = lo; e0 <= hi; e0 += ENTRIES) {
      const int cols = min(ENTRIES, hi + 1 - e0);
      product(p.rw + (size_t)e0 * HD, cols, [&](int n, const float (&d)[4]) {
        const int col = n + 2 * tq;
        *reinterpret_cast<uint32_t*>(scratch + g * ENTRIES + col) = rba::pack_bf16(d[0], d[1]);
        *reinterpret_cast<uint32_t*>(scratch + (g + 8) * ENTRIES + col) = rba::pack_bf16(d[2], d[3]);
      });
      __syncwarp();
      for (int j0 = par; j0 < p.kw; j0 += 2 * kBatch) {
        int e[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) e[u] = j0 + 2 * u < p.kw ? __ldg(irow + j0 + 2 * u) - e0 : -1;
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (e[u] >= 0 && e[u] < cols) wrow[j0 + 2 * u] = scratch[rr * ENTRIES + e[u]];
      }
      __syncwarp();
    }
  }
  // q * scale rounded to bf16, as the chain scales q before q.k^T
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) qa[kc][r] = rba::pack_bf16(lo_bf16(qa[kc][r]) * p.scale, hi_bf16(qa[kc][r]) * p.scale);

  // q.k^T of the warpgroup's 64 rows and the 64 keys at ks (parts `part` bytes apart),
  // asynchronous: 16 hd values, half a part's row, a step
  auto qk_steps = [&](uint32_t ks, uint32_t part, float (&s)[kNT][4]) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) wgmma_n64(s, qa[kc], smem_desc(ks + kc / 2 * part + kc % 2 * 32), kc);
  };
  auto qk = [&](uint32_t ks, float (&s)[kNT][4]) {
    wgmma_fence();
    qk_steps(ks, R::PART, s);
    wgmma_commit();
  };
  // o += p.v of the 64 keys of the V tile at vs, asynchronous: 16 keys (two key groups) a step
  float o[HD / 8][4];
  auto pv = [&](uint32_t vs, const uint32_t (&pf)[kKeys / 16][4]) {
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < kKeys / 16; ++kt) pv_step<HD>(o, pf[kt], vs + kt * 16 * 64, R::PART);
    wgmma_commit();
  };

  // the scores of the tile at key0 as the chain rounds them, position terms added;
  // keys >= nk get -inf.  No branch: their table reads are clamped and their scores
  // replaced by a select.
  const int dh = 8 / p.kw, dw = 8 % p.kw;  // (j_h, j_w) of 8 keys
  auto round_scores = [&](float (&s)[kNT][4], int key0, auto skip) {
    // (j_h, j_w) of the thread's first key of each 8-key tile (FAST: of both keys of
    // the pair; else of the second too), advanced by 8 a tile
    const int k0 = key0 + 2 * tq;
    int jh = k0 / p.kw, jw = k0 - jh * p.kw;
    int jh1 = FAST ? jh : (k0 + 1) / p.kw, jw1 = FAST ? jw + 1 : k0 + 1 - jh1 * p.kw;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int key = k0 + 8 * j;
      const bool ok0 = key < p.nk, ok1 = key + 1 < p.nk;
      // where no wgmma is in flight (resident), 8-key tiles past nk are skipped; they
      // stay as they are, and the caller reads no score of theirs
      if constexpr (decltype(skip)::value)
        if (key0 + 8 * j >= p.nk) continue;
      if (FAST) {
        const int hj = min(jh, p.kh - 1);
        uint32_t a0 = rba::pack_bf16(s[j][0], s[j][1]), a1 = rba::pack_bf16(s[j][2], s[j][3]);
        a0 = add_bf16x2(add_bf16x2(a0, h0[hj]), *reinterpret_cast<const uint32_t*>(w0 + jw));
        a1 = add_bf16x2(add_bf16x2(a1, h1[hj]), *reinterpret_cast<const uint32_t*>(w1 + jw));
        s[j][0] = ok0 ? lo_bf16(a0) : -INFINITY, s[j][1] = ok1 ? hi_bf16(a0) : -INFINITY;
        s[j][2] = ok0 ? lo_bf16(a1) : -INFINITY, s[j][3] = ok1 ? hi_bf16(a1) : -INFINITY;
      } else {
        const int hj0 = min(jh, p.kh - 1), hj1 = min(jh1, p.kh - 1);
        const float v0 = rba::round_bf16(rba::round_bf16(rba::round_bf16(s[j][0]) + lo_bf16(h0[hj0])) +
                                         __bfloat162float(w0[jw]));
        const float v1 = rba::round_bf16(rba::round_bf16(rba::round_bf16(s[j][1]) + lo_bf16(h0[hj1])) +
                                         __bfloat162float(w0[jw1]));
        const float v2 = rba::round_bf16(rba::round_bf16(rba::round_bf16(s[j][2]) + lo_bf16(h1[hj0])) +
                                         __bfloat162float(w1[jw]));
        const float v3 = rba::round_bf16(rba::round_bf16(rba::round_bf16(s[j][3]) + lo_bf16(h1[hj1])) +
                                         __bfloat162float(w1[jw1]));
        s[j][0] = ok0 ? v0 : -INFINITY, s[j][1] = ok1 ? v1 : -INFINITY;
        s[j][2] = ok0 ? v2 : -INFINITY, s[j][3] = ok1 ? v3 : -INFINITY;
        jh1 += dh, jw1 += dw;
        if (jw1 >= p.kw) jw1 -= p.kw, ++jh1;
      }
      jh += dh, jw += dw;
      if (jw >= p.kw) jw -= p.kw, ++jh;
    }
  };
  // the output rows of the thread, rounded to bf16
  auto store = [&](const float (&o)[HD / 8][4]) {
    __nv_bfloat16* obase = p.out + (size_t)call * p.nq * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int d = 8 * j + 2 * tq;
      if (row0 < p.nq) *reinterpret_cast<uint32_t*>(obase + (size_t)row0 * HD + d) = rba::pack_bf16(o[j][0], o[j][1]);
      if (row1 < p.nq) *reinterpret_cast<uint32_t*>(obase + (size_t)row1 * HD + d) = rba::pack_bf16(o[j][2], o[j][3]);
    }
  };

  if constexpr (NT > 0) {
    // Resident: the window's K and V whole in the ring, the scores in registers, one
    // pass.
    landed(0, 0);
    float s[NT][kNT][4];
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < NT; ++i) qk_steps(ring + i * kKeys * 64, RES_PART, s[i]);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    uint32_t pf[NT][kKeys / 16][4];
    if (active) {
#pragma unroll
      for (int i = 0; i < NT; ++i) round_scores(s[i], i * kKeys, std::true_type{});
      float mx0 = -FLT_MAX, mx1 = -FLT_MAX;
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          if (i * kKeys + 8 * j < p.nk) {
            mx0 = fmaxf(mx0, fmaxf(s[i][j][0], s[i][j][1]));
            mx1 = fmaxf(mx1, fmaxf(s[i][j][2], s[i][j][3]));
          }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      // e = exp(s - max) in place; 8-key tiles past nk hold 0
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          if (i * kKeys + 8 * j < p.nk) {
            s[i][j][0] = expf(s[i][j][0] - mx0), s[i][j][1] = expf(s[i][j][1] - mx0);
            s[i][j][2] = expf(s[i][j][2] - mx1), s[i][j][3] = expf(s[i][j][3] - mx1);
            sum0 += s[i][j][0] + s[i][j][1];
            sum1 += s[i][j][2] + s[i][j][3];
          } else {
            s[i][j][0] = s[i][j][1] = s[i][j][2] = s[i][j][3] = 0.f;
          }
        }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, x);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, x);
      }
      const float rs0 = 1.f / sum0, rs1 = 1.f / sum1;
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int kt = 0; kt < kKeys / 16; ++kt) {
          pf[i][kt][0] = rba::pack_bf16(quotient(s[i][2 * kt][0], sum0, rs0), quotient(s[i][2 * kt][1], sum0, rs0));
          pf[i][kt][1] = rba::pack_bf16(quotient(s[i][2 * kt][2], sum1, rs1), quotient(s[i][2 * kt][3], sum1, rs1));
          pf[i][kt][2] = rba::pack_bf16(quotient(s[i][2 * kt + 1][0], sum0, rs0),
                                        quotient(s[i][2 * kt + 1][1], sum0, rs0));
          pf[i][kt][3] = rba::pack_bf16(quotient(s[i][2 * kt + 1][2], sum1, rs1),
                                        quotient(s[i][2 * kt + 1][3], sum1, rs1));
        }
    }
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int kt = 0; kt < kKeys / 16; ++kt)
        pv_step<HD>(o, pf[i][kt], ring + NT * R::TILE + (i * kKeys + 16 * kt) * 64, RES_PART);
    wgmma_commit();
    wgmma_wait<0>();
    if (active) store(o);
    return;
  }

  // tile t + 1 has landed (later ones may still be landing) and every warp is done
  // with tile t - 2 (its p.v included), whose buffer takes tile t + AHEAD
  auto advance = [&](int t) {
    landed((t + 1) % kStages, (t + 1) / kStages);
    __syncthreads();
    stage(t + R::AHEAD);
  };

  float s[kNT][4], sn[kNT][4];
  landed(0, 0);
  qk(buffer(0), s);
  wgmma_wait<0>();
  round_scores(s, 0, std::false_type{});

  // pass 1: each thread's running maximum and sum of exp(s - max) over its own columns
  // of rows row0 and row1; -FLT_MAX lies below every finite score, so a thread whose
  // columns are all masked keeps sum 0 and no NaN.  Step t issues tile t + 1's q.k^T
  // (the last step: pass 2's first tile) and works on tile t's scores meanwhile.
  float mx0 = -FLT_MAX, mx1 = -FLT_MAX, sum0 = 0.f, sum1 = 0.f;
  auto p1_step = [&](int t, float (&cur)[kNT][4], float (&next)[kNT][4]) {
    advance(t);
    qk(buffer(t + 1), next);
    {
      const int live = p.nk - first_key(t);
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
      for (int j = 0; j < kNT; ++j)
        if (8 * j < live) {
          sum0 += expf(cur[j][0] - mx0) + expf(cur[j][1] - mx0);
          sum1 += expf(cur[j][2] - mx1) + expf(cur[j][3] - mx1);
        }
    }
    wgmma_wait<0>();
    round_scores(next, first_key(t + 1), std::false_type{});
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
  const float rs0 = 1.f / sum0, rs1 = 1.f / sum1;

  // pass 2: p = exp(s - max) / sum rounded to bf16, the probabilities of 8-key tiles
  // 2 kt and 2 kt + 1 packed as the A fragment of 16-key step kt, in one of two sets:
  // the other may still feed the previous tile's p.v.  Step t then issues tile t + 1's
  // q.k^T and tile t's p.v, and rounds tile t + 1's scores while p.v runs.
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  uint32_t pa[kKeys / 16][4], pb[kKeys / 16][4];
  auto p2_step = [&](int t, uint32_t (&pf)[kKeys / 16][4], auto more) {
    if constexpr (decltype(more)::value) advance(t);
    {
#pragma unroll
      for (int kt = 0; kt < kKeys / 16; ++kt) {
        pf[kt][0] = rba::pack_bf16(quotient(expf(s[2 * kt][0] - mx0), sum0, rs0),
                                   quotient(expf(s[2 * kt][1] - mx0), sum0, rs0));
        pf[kt][1] = rba::pack_bf16(quotient(expf(s[2 * kt][2] - mx1), sum1, rs1),
                                   quotient(expf(s[2 * kt][3] - mx1), sum1, rs1));
        pf[kt][2] = rba::pack_bf16(quotient(expf(s[2 * kt + 1][0] - mx0), sum0, rs0),
                                   quotient(expf(s[2 * kt + 1][1] - mx0), sum0, rs0));
        pf[kt][3] = rba::pack_bf16(quotient(expf(s[2 * kt + 1][2] - mx1), sum1, rs1),
                                   quotient(expf(s[2 * kt + 1][3] - mx1), sum1, rs1));
      }
    }
    if constexpr (decltype(more)::value) qk(buffer(t + 1), s);
    pv(buffer(t) + R::TILE, pf);
    if constexpr (decltype(more)::value) {
      wgmma_wait<1>();  // q.k^T of tile t + 1 is done; p.v of tile t may run on
      round_scores(s, first_key(t + 1), std::false_type{});
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
  if (!active) return;

  store(o);
}

// Kernel H's position tables, R_h gathered and R_w resampled, stacked: entry e of `n`,
// value c, is bf16(fp32(src[lo[e]][c] * w[e]) + fp32(src[hi[e]][c] * w[n + e])) with
// lo = rows[e], hi = rows[n + e] and src the rows of rh_src, then those of rw_src
// (rows >= len_h), both fp32 (·, hd) dense; no product is fused into the sum
__global__ void rel_pos_tables_kernel(const float* __restrict__ rh_src, const float* __restrict__ rw_src, int len_h,
                                      const long long* __restrict__ rows, const float* __restrict__ w, int n,
                                      int hd, __nv_bfloat16* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)n * hd) return;
  const int e = (int)(i / hd), c = (int)(i % hd);
  const long long lo = rows[e], hi = rows[n + e];
  const float a = (lo < len_h ? rh_src + lo * hd : rw_src + (lo - len_h) * hd)[c];
  const float b = (hi < len_h ? rh_src + hi * hd : rw_src + (hi - len_h) * hd)[c];
  out[i] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(a, w[e]), __fmul_rn(b, w[n + e])));
}

// a (calls, n, hd) bf16 tensor, rows and calls by strides (values), as a tensor map of
// boxes of 32 values x `rows` rows in the 64-byte swizzle
int tile_map(CUtensorMap* map, const void* base, int hd, int n, int calls, long long row, long long batch, int rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
                                                    cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || !encode) return (int)cudaErrorSymbolNotFound;
  }
  if (n == 1) row = hd;              // a stride of one row or one call is never taken:
  if (calls == 1) batch = row * n;   // any multiple of 16 bytes does
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)n, (cuuint64_t)calls};
  const cuuint64_t strides[2] = {(cuuint64_t)row * 2, (cuuint64_t)batch * 2};  // bytes
  const cuuint32_t box[3] = {32, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
                              unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD, bool FAST, int WG, int NT>
int launch(const Params& p, int calls, cudaStream_t stream) {
  using R = Ring<HD, WG>;
  CUtensorMap kmap, vmap;
  const int rows = NT > 0 ? NT * kKeys : kKeys;  // a resident window's keys in one box a part
  int err = tile_map(&kmap, p.k, HD, p.nk, calls, p.k_r, p.k_b, rows);
  if (!err) err = tile_map(&vmap, p.v, HD, p.nk, calls, p.v_r, p.v_b, rows);
  if (err) return err;
  auto kernel = rel_pos_attention_kernel<HD, FAST, WG, NT>;
  const size_t smem = 1024 + R::BYTES + (size_t)R::ROWS * p.ld * sizeof(__nv_bfloat16) +
                      (NT > 0 ? (size_t)R::WARPS * 16 * kEntriesResident * sizeof(__nv_bfloat16) : 0);
  // above 48 KB of dynamic shared memory, on whichever device is current
  err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const dim3 grid((unsigned)((p.nq + R::ROWS - 1) / R::ROWS), (unsigned)calls);
  kernel<<<grid, R::THREADS, smem, stream>>>(p, kmap, vmap);
  return (int)cudaGetLastError();
}

// By the key count: a window of up to 64 or 256 keys stays resident, one warpgroup a
// block and two blocks an SM; more keys stream, two warpgroups sharing each tile
template <int HD, bool FAST>
int by_keys(const Params& p, int calls, cudaStream_t stream) {
  if (p.nk <= kKeys) return launch<HD, FAST, 1, 1>(p, calls, stream);
  if (p.nk <= 4 * kKeys) return launch<HD, FAST, 1, 4>(p, calls, stream);
  return launch<HD, FAST, 2, 0>(p, calls, stream);
}

template <int HD>
int dispatch(const Params& p, int calls, cudaStream_t stream) {
  return p.kw % 2 == 0 && p.kw >= 8 ? by_keys<HD, true>(p, calls, stream) : by_keys<HD, false>(p, calls, stream);
}

}  // namespace

extern "C" {

const char* rba_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// q (calls, nq, hd) bf16 by the strides (in values) q_b, q_r, q_c; k and v (calls, nk,
// hd) bf16, the last dim dense, rows and starts 16-byte aligned, by the strides k_b, k_r,
// v_b, v_r; nq = qh qw, nk = kh kw; rh (qh, kh, hd) bf16, dense; rw (entries, hd) bf16,
// dense, and iw_index (qw, kw) int32, the entry of rw that each (i_w, j_w) takes; out
// (calls, nq, hd) bf16, dense; hd 64 or 96; scale the bf16 value of hd^-0.5 as a float.
// The Python wrapper (kernels/rel_pos_attention.py) checks these and the sizes.  Returns
// a cudaError_t.
int rba_rel_pos_attention(const void* q, const void* k, const void* v, const void* rh, const void* rw,
                          const void* iw_index, void* out,
                          int calls, int qh, int qw, int kh, int kw, int hd, long long q_b, long long q_r,
                          long long q_c, long long k_b, long long k_r, long long v_b, long long v_r, float scale, void* stream) {
  if (calls < 1 || calls > 65535 || qh < 1 || qw < 1 || kh < 1 || kw < 1) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.rh = static_cast<const __nv_bfloat16*>(rh);
  p.rw = static_cast<const __nv_bfloat16*>(rw);
  p.iw_index = static_cast<const int*>(iw_index);
  p.q_pairs = q_c == 1 && q_r % 2 == 0 && q_b % 2 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.q_b = q_b, p.q_r = q_r, p.q_c = q_c, p.k_b = k_b, p.k_r = k_r, p.v_b = v_b, p.v_r = v_r;
  p.nq = qh * qw, p.nk = kh * kw, p.qh = qh, p.qw = qw, p.kh = kh, p.kw = kw;
  p.kwp = kw + kw % 2;
  // rows 4 mod 8 words apart: the 8 rows g of a warp's reads, 4 words each, fall in 32 banks
  const int words = p.kwp / 2 + kh;
  p.ld = 2 * (words + (12 - words % 8) % 8);
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 96) return dispatch<96>(p, calls, s);
  if (hd == 64) return dispatch<64>(p, calls, s);
  return (int)cudaErrorInvalidValue;
}

// The tables of rel_pos_tables_kernel into out (n, hd) bf16, dense: rh_src (len_h, hd) and
// rw_src fp32, dense; rows (2 n) int64 into their stacked rows, w (2 n) fp32.  Returns a
// cudaError_t.
int rba_rel_pos_tables(const void* rh_src, const void* rw_src, int len_h, const void* rows, const void* w, int n,
                       int hd, void* out, void* stream) {
  if (n < 1 || hd < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)n * hd;
  rel_pos_tables_kernel<<<(unsigned)((total + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rh_src), static_cast<const float*>(rw_src), len_h,
      static_cast<const long long*>(rows), static_cast<const float*>(w), n, hd, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
