// Exact linear-sum assignment (Kernel E) for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// The on-device Hungarian solver of rba_tpu/ops/lsap.py (linear_sum_assignment,
// vmapped over the batch as batched_linear_sum_assignment), which rba_tpu runs
// in lax while-loops so that its train step never syncs to the host.  For each
// (R, C) fp32 cost matrix of a batch, R <= C <= 1024, it returns col4row, the
// column assigned to each row: the rows are taken in order; for each, the
// shortest augmenting path (Jonker-Volgenant, rectangular) grows one column at
// a time, then the duals u, v are updated and the path is augmented.  Ties go
// as in rba_tpu: the least reduced cost over unscanned columns, among equal
// minima the first free column, failing that the first column.  The fp32
// arithmetic is rba_tpu's, in its order, with __fadd_rn / __fsub_rn so that no
// contraction or reassociation changes a rounding:
//     reduced = ((min_val + cost[i, j]) - u[i]) - v[j]
//     u[cur] = u[cur] + min_val;  u[r] = (u[r] + min_val) - spc[col4row[r]]
//     v[j] = v[j] - (min_val - spc[j])
// so the assignment equals the plain version's (rba_tpu_torch/ops/lsap.py)
// exactly, not within a tolerance.
//
// Bound on the H100: latency.  The work is a chain: each step of a path needs
// the argmin of the step before, and each row starts from the duals of the row
// before.  Per step a warp reads one cost row (C floats) and makes one pass over
// C columns plus a 5-level shuffle reduction; the bytes (B·R·C·4 once) and
// operations (a few per column and step) are far below what the card moves in
// the time of the chain.  The design therefore keeps the chain short and in
// one warp:
//   - One block of one warp per matrix; the matrices of a batch run in
//     parallel on separate SMs.  The rows are serial.
//   - The columns are split over the 32 lanes (lane l holds l, l + 32, ...);
//     u, v, spc, path, the scanned flags and row4col / col4row live in shared
//     memory, so a step touches device memory only for its cost row.
//   - The argmin is a warp shuffle reduction on the key (value, not free,
//     index), which is rba_tpu's tie order; __syncwarp orders the shared
//     writes of one step before the reads of the next.
//   - Lane 0 walks the augmenting path back; the other lanes wait at the next
//     __syncwarp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 1024;
constexpr float kInf = 1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Key {
  float val;
  int not_free;
  int idx;
};

// a before b in rba_tpu's order: the smaller value, then a free column, then the lower index
__device__ __forceinline__ bool before(const Key& a, const Key& b) {
  if (a.val != b.val) return a.val < b.val;
  if (a.not_free != b.not_free) return a.not_free < b.not_free;
  return a.idx < b.idx;
}

__global__ void __launch_bounds__(32) lsap_kernel(const float* __restrict__ cost, int* __restrict__ out, int R,
                                                  int C) {
  extern __shared__ unsigned char smem[];
  float* u = reinterpret_cast<float*>(smem);
  float* v = u + R;
  float* spc = v + C;
  int* path = reinterpret_cast<int*>(spc + C);
  int* row4col = path + C;
  int* col4row = row4col + C;
  unsigned char* sc = reinterpret_cast<unsigned char*>(col4row + R);
  unsigned char* sr = sc + C;

  const int lane = threadIdx.x;
  const float* mat = cost + static_cast<size_t>(blockIdx.x) * R * C;

  for (int j = lane; j < C; j += 32) {
    v[j] = 0.f;
    row4col[j] = -1;
  }
  for (int r = lane; r < R; r += 32) {
    u[r] = 0.f;
    col4row[r] = -1;
  }
  __syncwarp();

  for (int cur = 0; cur < R; ++cur) {
    for (int j = lane; j < C; j += 32) {
      sc[j] = 0;
      spc[j] = kInf;
      path[j] = -1;
    }
    for (int r = lane; r < R; r += 32) sr[r] = 0;
    __syncwarp();

    int i = cur, sink = -1;
    float min_val = 0.f;
    while (sink < 0) {
      if (lane == 0) sr[i] = 1;
      const float ui = u[i];
      const float* row = mat + static_cast<size_t>(i) * C;
      Key best{kInf, 1, C};
      for (int j = lane; j < C; j += 32) {
        float s = spc[j];
        const bool scanned = sc[j];
        if (!scanned) {
          const float reduced = __fsub_rn(__fsub_rn(__fadd_rn(min_val, __ldg(row + j)), ui), v[j]);
          if (reduced < s) {
            s = reduced;
            spc[j] = reduced;
            path[j] = i;
          }
        }
        const Key k{scanned ? kInf : s, row4col[j] >= 0 ? 1 : 0, j};
        if (before(k, best)) best = k;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        Key o;
        o.val = __shfl_down_sync(kFull, best.val, off);
        o.not_free = __shfl_down_sync(kFull, best.not_free, off);
        o.idx = __shfl_down_sync(kFull, best.idx, off);
        if (before(o, best)) best = o;
      }
      const int j = __shfl_sync(kFull, best.idx, 0);
      min_val = __shfl_sync(kFull, best.val, 0);
      __syncwarp();
      const int owner = row4col[j];
      if (owner < 0) {
        sink = j;
      } else {
        i = owner;
      }
      if (lane == 0) sc[j] = 1;
      __syncwarp();
    }

    // dual updates: the current row, the other rows on the path, the scanned columns
    if (lane == 0) u[cur] = __fadd_rn(u[cur], min_val);
    for (int r = lane; r < R; r += 32) {
      if (sr[r] && r != cur) {
        const int c = min(max(col4row[r], 0), C - 1);
        u[r] = __fsub_rn(__fadd_rn(u[r], min_val), spc[c]);
      }
    }
    for (int j = lane; j < C; j += 32) {
      if (sc[j]) v[j] = __fsub_rn(v[j], __fsub_rn(min_val, spc[j]));
    }
    __syncwarp();

    // augment: walk back along the path
    if (lane == 0) {
      int j = sink;
      int r;
      do {
        r = path[j];
        row4col[j] = r;
        const int prev = col4row[r];
        col4row[r] = j;
        j = prev;
      } while (r != cur);
    }
    __syncwarp();
  }
  for (int r = lane; r < R; r += 32) out[static_cast<size_t>(blockIdx.x) * R + r] = col4row[r];
}

// u, col4row (R) and v, spc, path, row4col (C) of 4 bytes; sc (C) and sr (R) of 1
size_t smem_bytes(int R, int C) { return static_cast<size_t>(2 * R + 4 * C) * 4 + C + R; }

}  // namespace

extern "C" {

const char* rba_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// cost (b, r, c) fp32, contiguous, r <= c <= 1024; out (b, r) int32 col4row.
// Returns a cudaError_t.
int rba_lsap(const float* cost, int* out, int b, int r, int c, void* stream) {
  if (b < 1 || r < 1 || r > c || c > kMaxCols) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(r, c);
  lsap_kernel<<<b, 32, smem, static_cast<cudaStream_t>(stream)>>>(cost, out, r, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
