// Normal equations of one ALS degree bucket, for Hopper (sm_90a).
//
// Replaces the TPU kernel predictionio_tpu/ops/train_kernel.py:_train_contract_kernel,
// reached through fused_train_normal_eq (the dense solver's per-bucket step,
// models/als.py:_dense_half_step_local).
//
// What it computes, per bucket row e over its D slots d (g = V[idx[e,d]] as f32,
// int8 rows times their per-row scale; m = msk[e,d]; r = rat[e,d]):
//   explicit  W = g*m               A = sum W W^T     b = sum W*r      cnt = sum m
//   implicit  X = g*(alpha*r*m)     A = sum X g^T     b = sum g*((1+alpha*r)*m)   cnt = 0
// with the reference's cast points for bf16 (models/als.py:644-665): the weights
// alpha*r, 1+alpha*r, r and m are rounded to bf16, and so are their products with
// g (W, X, the b weight), before the f32 products that are accumulated. Every
// product of two bf16 values is exact in f32, so "f32 products of bf16 operands"
// needs no further rounding. Accumulation is always f32. A masked slot (m == 0)
// never reads V and contributes exactly zero, whatever its idx.
//
// What bounds it: per half-step the kernel must read each slot's idx, rat and msk
// once (12 B a slot), V once (n_opp*k elements) and write A, b and cnt; it does
// 2k^2 + 2k f32 operations a slot. At rank 10 that is 220 operations against 12 B,
// ~18 operations a byte, below the card's f32 ridge (67 TFLOP/s over 3.35 TB/s =
// 20): bytes bound it, by a little.
//
// Design. The TPU kernel pins V in VMEM and contracts 8 entity rows per grid step
// in order, accumulating across the D sweep in resident output blocks. On Hopper
// V (2.4 MB of items, 6.5 MB of users at f32) is read through the 50 MB L2, blocks
// run in parallel and in no order, and most rows are narrow (width 48 to a few
// hundred slots at the ML-25M zipf shape), so a row's work is a warp's:
//   * accumulators. A warp owns one row and a tile of 32 * M of its sums, M a lane
//     in registers (as csrc/segment_normal_eq.cu): explicit A is symmetric bit for
//     bit (W_i * W_j is W_j * W_i, summed in the same order), so only i <= j is
//     summed and stored twice, k(k+1)/2 + k + 1 sums (rank 10: 66, M = 3);
//     implicit A is not (X and g differ), so k^2 + k (110, M = 4), and cnt is 0.
//     Larger ranks take more tiles, one task each.
//   * slots. The warp reads up to 32 slots' (idx, rat, msk) at a time, coalesced;
//     a ballot keeps the live slots (m != 0), in slot order; their V rows are
//     gathered, widened and weighted (the cast points above) into one record a
//     slot in the warp's shared memory; then each lane adds its accumulators'
//     products, slot after slot (fmaf), with no __syncthreads and no cross-group
//     fold. The next batch's metadata is in flight meanwhile.
//   * narrow rows (width up to NARROW_MAX, set in ops/train_kernel.py:dense_plan):
//     eight rows a block, a warp each, the whole row.
//   * wide rows: a block per (row, part), the part's batches dealt to its 8 warps in
//     turn, the warps' sums folded in warp order through shared memory. A row cut
//     into parts (split_plan) writes its parts' sums, and a second grid adds them
//     in part order.
// Every sum is taken in an order fixed by the shapes alone (and which slots are
// live), with no atomics, so one seed gives one model. Making it faster (fewer
// shared loads a product, one launch a half-step over all buckets, tensor cores
// for wide ranks) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 64;            // slots: the grain of a wide row's parts (Python: TILE)
constexpr int MAX_RANK = 64;        // (Python: MAX_RANK)
constexpr int MAX_PER_LANE = 4;     // accumulators a lane, at most
constexpr int STAGE_FLOATS = 1152;  // staged records a warp, in floats
constexpr unsigned FULL = 0xffffffffu;

// floats of one slot's record: the weighted row (k), implicit: g (k), then the b
// weight, m and 1
__host__ __device__ __forceinline__ int record(int k, bool implicit) {
  return (implicit ? 2 * k : k) + 3;
}
// slots of one batch: 32, or fewer where 32 records would not fit
__host__ __device__ __forceinline__ int batch_rows(int k, bool implicit) {
  const int rows = STAGE_FLOATS / record(k, implicit);
  return rows > 32 ? 32 : rows;
}
// shared floats of one warp: its records, then the batch's row ids, ratings, masks
__host__ __device__ __forceinline__ int warp_floats(int k, bool implicit) {
  return batch_rows(k, implicit) * record(k, implicit) + 96;
}
__host__ __device__ __forceinline__ int accumulators(int k, bool implicit) {
  return implicit ? k * k + k : k * (k + 1) / 2 + k + 1;
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float load(const float* V, long long o) { return V[o]; }
__device__ __forceinline__ float load(const __nv_bfloat16* V, long long o) {
  return __bfloat162float(V[o]);
}
__device__ __forceinline__ float load(const int8_t* V, long long o) {
  return static_cast<float>(V[o]);
}

struct Args {
  const int* idx;     // (n_b, D)
  const float* rat;   // (n_b, D)
  const float* msk;   // (n_b, D)
  const void* V;      // (n_opp, k)
  const float* vs;    // (n_opp,) int8 row scales, else null
  float* A;           // (n_b, k, k)
  float* b;           // (n_b, k)
  float* cnt;         // (n_b,)
  float* parts;       // (n_b, splits, k*k + k + 1) when splits > 1
  int n_b, D, n_opp, k, splits, seg, tiles;
  float alpha;
};

enum Kind { KIND_A, KIND_B, KIND_CNT, KIND_NONE };

// Accumulator t: explicit A enumerates i <= j row by row, then b, then cnt;
// implicit A all k^2, then b.
__device__ void decode(int t, int k, bool implicit, Kind& kind, int& i, int& j) {
  const int n_a = implicit ? k * k : k * (k + 1) / 2;
  i = j = 0;
  if (t < n_a) {
    kind = KIND_A;
    if (implicit) {
      i = t / k;
      j = t - i * k;
    } else {
      while (t >= k - i) {
        t -= k - i;
        ++i;
      }
      j = i + t;
    }
  } else if (t < n_a + k) {
    kind = KIND_B;
    i = t - n_a;
  } else {
    kind = !implicit && t == n_a + k ? KIND_CNT : KIND_NONE;
  }
}

// The record entries whose product accumulator t adds a slot.
__device__ void operands(int t, int k, bool implicit, int& x, int& y) {
  const int g = implicit ? k : 0, bw = implicit ? 2 * k : k;
  Kind kind;
  int i, j;
  decode(t, k, implicit, kind, i, j);
  switch (kind) {
    case KIND_A:  // explicit W_i W_j, implicit X_i g_j
      x = i;
      y = g + j;
      break;
    case KIND_B:  // explicit W_i * r, implicit g_i * ((1 + alpha*r) m)
      x = g + i;
      y = bw;
      break;
    case KIND_CNT:  // m * 1
      x = bw + 1;
      y = bw + 2;
      break;
    default:  // past the last: summed, never stored
      x = y = bw + 2;
  }
}

template <bool IMPLICIT>
__device__ void store_sum(const Args& a, long long row, int t, float v) {
  const int k = a.k;
  Kind kind;
  int i, j;
  decode(t, k, IMPLICIT, kind, i, j);
  if (kind == KIND_A) {
    float* Ae = a.A + row * k * k;
    Ae[i * k + j] = v;
    if (!IMPLICIT) Ae[j * k + i] = v;
  } else if (kind == KIND_B) {
    a.b[row * k + i] = v;
  } else if (kind == KIND_CNT) {
    a.cnt[row] = v;
  }
}

// The warp's M accumulators a lane over nl staged records, slot after slot.
template <int M>
__device__ __forceinline__ void sum_records(const float* rec, int P, int nl, const int (&x)[M],
                                            const int (&y)[M], float (&acc)[M]) {
#pragma unroll 4
  for (int t = 0; t < nl; ++t) {
    const float* rt = rec + t * P;
#pragma unroll
    for (int mi = 0; mi < M; ++mi) acc[mi] = fmaf(rt[x[mi]], rt[y[mi]], acc[mi]);
  }
}

// One batch's slot metadata, a lane a slot (m = 0 past `end`).
struct Meta {
  float m, r;
  int o;
};

__device__ __forceinline__ Meta load_meta(const Args& a, long long off, int d, int end, int rows) {
  const int lane = threadIdx.x & 31;
  Meta t{0.f, 0.f, 0};
  if (lane < rows && d + lane < end) {
    t.m = a.msk[off + d + lane];
    t.r = a.rat[off + d + lane];
    t.o = a.idx[off + d + lane];
  }
  return t;
}

// Keeps the batch's live slots (m != 0), in slot order: their clamped row ids,
// ratings and masks into ids, rs, ms. Returns how many.
__device__ __forceinline__ int compact(const Args& a, const Meta& t, int* ids, float* rs, float* ms) {
  const int lane = threadIdx.x & 31;
  const bool live = t.m != 0.f;
  const unsigned bal = __ballot_sync(FULL, live);
  if (live) {
    const int p = __popc(bal & ((1u << lane) - 1u));
    ids[p] = t.o < 0 ? 0 : (t.o >= a.n_opp ? a.n_opp - 1 : t.o);  // clamped, as XLA's gather
    rs[p] = t.r;
    ms[p] = t.m;
  }
  return __popc(bal);
}

// Value q of a batch is slot q / k, column q % k; a lane steps 32 values at a time.
struct Step {
  int s, c, ds, dc, k;
  __device__ __forceinline__ void next() {
    s += ds;
    c += dc;
    if (c >= k) {
      c -= k;
      ++s;
    }
  }
};

__device__ __forceinline__ Step first_step(int k) {
  const int lane = threadIdx.x & 31;
  return Step{lane / k, lane % k, 32 / k, 32 % k, k};
}

// One staged value: the gathered g (widened, scaled) weighted with the reference's
// cast points into the record of slot s, column c.
template <bool IMPLICIT, bool BF16>
__device__ __forceinline__ void put(float* rec, int P, int k, int s, int c, float gv, float r,
                                    float m, float am) {
  const float wm = BF16 ? bf16r(m) : m;
  if (IMPLICIT) {
    const float cw = BF16 ? bf16r(__fmul_rn(bf16r(__fmul_rn(am, r)), wm))
                          : __fmul_rn(__fmul_rn(am, r), wm);
    rec[s * P + c] = BF16 ? bf16r(__fmul_rn(gv, cw)) : __fmul_rn(gv, cw);
    rec[s * P + k + c] = gv;
  } else {
    rec[s * P + c] = BF16 ? bf16r(__fmul_rn(gv, wm)) : __fmul_rn(gv, wm);
  }
}

// A slot's scalars: the b weight, m and 1.
template <bool IMPLICIT, bool BF16>
__device__ __forceinline__ void put_scalars(float* rec, int bw, float r, float m, float am) {
  float bwv;
  if (IMPLICIT) {
    const float wm = BF16 ? bf16r(m) : m;
    const float cb = __fadd_rn(1.f, __fmul_rn(am, r));
    bwv = BF16 ? bf16r(__fmul_rn(bf16r(cb), wm)) : __fmul_rn(cb, wm);
  } else {
    bwv = BF16 ? bf16r(r) : r;
  }
  rec[bw] = bwv;
  rec[bw + 1] = m;
  rec[bw + 2] = 1.f;
}

// One warp adds the live slots among [first, end) of `row`, taken `rows` at a time
// and `stride` apart, into its accumulators, batch after batch in slot order; the
// next batch's metadata is in flight while this one is staged and summed.
template <typename T, bool IMPLICIT, int M>
__device__ __forceinline__ void sum_slots(const Args& a, long long row, int first, int end,
                                          int stride, float* rec, int* ids, float* rs, float* ms,
                                          const int (&x)[M], const int (&y)[M], float (&acc)[M]) {
  constexpr bool BF16 = sizeof(T) == 2;
  const int lane = threadIdx.x & 31;
  const int k = a.k, P = record(k, IMPLICIT), rows = batch_rows(k, IMPLICIT);
  const int bw = IMPLICIT ? 2 * k : k;
  const T* V = static_cast<const T*>(a.V);
  const long long off = row * a.D;
  Meta nx = load_meta(a, off, first, end, rows);
  for (int base = first; base < end; base += stride) {
    const Meta cur = nx;
    nx = load_meta(a, off, base + stride, end, rows);
    const int nl = compact(a, cur, ids, rs, ms);
    if (nl == 0) continue;  // uniform over the warp
    __syncwarp();
    Step st = first_step(k);
    for (int q = lane; q < nl * k; q += 32, st.next()) {
      const int vo = ids[st.s];
      float gv = load(V, static_cast<long long>(vo) * k + st.c);
      if (a.vs != nullptr) gv = __fmul_rn(gv, a.vs[vo]);
      put<IMPLICIT, BF16>(rec, P, k, st.s, st.c, gv, rs[st.s], ms[st.s], a.alpha);
    }
    if (lane < nl) put_scalars<IMPLICIT, BF16>(rec + lane * P, bw, rs[lane], ms[lane], a.alpha);
    __syncwarp();
    sum_records<M>(rec, P, nl, x, y, acc);
    __syncwarp();  // the records are read before the next batch overwrites them
  }
}

// Narrow rows: a warp per (row, tile), eight a block.
template <typename T, bool IMPLICIT, int M>
__global__ void __launch_bounds__(THREADS, 4) normal_eq_rows(Args a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = a.k, P = record(k, IMPLICIT), rows = batch_rows(k, IMPLICIT);
  const long long task = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (task >= static_cast<long long>(a.n_b) * a.tiles) return;  // only warp-level syncs below
  const long long row = task / a.tiles;
  const int tile = static_cast<int>(task - row * a.tiles);
  float* rec = smem + warp * warp_floats(k, IMPLICIT);
  int* ids = reinterpret_cast<int*>(rec + rows * P);
  float* rs = rec + rows * P + 32;
  float* ms = rs + 32;
  int x[M], y[M];
  float acc[M];
#pragma unroll
  for (int mi = 0; mi < M; ++mi) {
    operands(tile * 32 * M + mi * 32 + lane, k, IMPLICIT, x[mi], y[mi]);
    acc[mi] = 0.f;
  }
  sum_slots<T, IMPLICIT, M>(a, row, 0, a.D, rows, rec, ids, rs, ms, x, y, acc);
  const int E = accumulators(k, IMPLICIT);
#pragma unroll
  for (int mi = 0; mi < M; ++mi) {
    const int t = tile * 32 * M + mi * 32 + lane;
    if (t < E) store_sum<IMPLICIT>(a, row, t, acc[mi]);
  }
  if (IMPLICIT && tile == 0 && lane == 0) a.cnt[row] = 0.f;
}

// Wide rows: a block per (row, part, tile); the part's batches go to the warps in
// turn, and the warps' sums are folded in warp order.
template <typename T, bool IMPLICIT, int M>
__global__ void __launch_bounds__(THREADS, 4) normal_eq_parts(Args a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = a.k, P = record(k, IMPLICIT), rows = batch_rows(k, IMPLICIT);
  const int tile = blockIdx.x % a.tiles;
  const long long rp = blockIdx.x / a.tiles;
  const long long row = rp / a.splits;
  const int part = static_cast<int>(rp - row * a.splits);
  float* rec = smem + warp * warp_floats(k, IMPLICIT);
  int* ids = reinterpret_cast<int*>(rec + rows * P);
  float* rs = rec + rows * P + 32;
  float* ms = rs + 32;
  float* sums = smem + WARPS * warp_floats(k, IMPLICIT);  // [WARPS][32 * M]
  int x[M], y[M];
  float acc[M];
#pragma unroll
  for (int mi = 0; mi < M; ++mi) {
    operands(tile * 32 * M + mi * 32 + lane, k, IMPLICIT, x[mi], y[mi]);
    acc[mi] = 0.f;
  }
  const int d0 = part * a.seg, d1 = min(a.D, d0 + a.seg);
  sum_slots<T, IMPLICIT, M>(a, row, d0 + warp * rows, d1, rows * WARPS, rec, ids, rs, ms, x, y,
                            acc);
#pragma unroll
  for (int mi = 0; mi < M; ++mi) sums[warp * 32 * M + mi * 32 + lane] = acc[mi];
  __syncthreads();
  const int E = accumulators(k, IMPLICIT);
  if (threadIdx.x < 32 * M) {
    float v = 0.f;
    for (int w = 0; w < WARPS; ++w) v += sums[w * 32 * M + threadIdx.x];
    const int t = tile * 32 * M + threadIdx.x;
    if (t < E) {
      if (a.splits > 1)
        a.parts[(row * a.splits + part) * (k * k + k + 1) + t] = v;
      else
        store_sum<IMPLICIT>(a, row, t, v);
    }
    if (IMPLICIT && a.splits == 1 && t == 0) a.cnt[row] = 0.f;
  }
}

// one thread per (row, accumulator): the parts summed in part order
template <bool IMPLICIT>
__global__ void normal_eq_fold(Args a) {
  const int E = accumulators(a.k, IMPLICIT);
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(a.n_b) * E) return;
  const long long row = t / E;
  const int e = static_cast<int>(t - row * E);
  const float* p = a.parts + row * a.splits * (a.k * a.k + a.k + 1) + e;
  float v = 0.f;
  for (int s = 0; s < a.splits; ++s) v += p[static_cast<long long>(s) * (a.k * a.k + a.k + 1)];
  store_sum<IMPLICIT>(a, row, e, v);
  if (IMPLICIT && e == 0) a.cnt[row] = 0.f;
}

// Accumulators a lane: as few as hold one row's in one tile, at most MAX_PER_LANE.
int per_lane(int k, bool implicit) {
  const int m = (accumulators(k, implicit) + 31) / 32;
  return m < MAX_PER_LANE ? m : MAX_PER_LANE;
}

template <typename T, bool IMPLICIT, int M>
cudaError_t launch_m(Args a, bool narrow, cudaStream_t stream) {
  a.tiles = (accumulators(a.k, IMPLICIT) + 32 * M - 1) / (32 * M);
  const size_t warps_smem = sizeof(float) * WARPS * warp_floats(a.k, IMPLICIT);
  if (narrow) {
    const long long blocks = (static_cast<long long>(a.n_b) * a.tiles + WARPS - 1) / WARPS;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    normal_eq_rows<T, IMPLICIT, M>
        <<<static_cast<unsigned>(blocks), THREADS, warps_smem, stream>>>(a);
    return cudaGetLastError();
  }
  const long long blocks = static_cast<long long>(a.n_b) * a.splits * a.tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  normal_eq_parts<T, IMPLICIT, M><<<static_cast<unsigned>(blocks), THREADS,
                                    warps_smem + sizeof(float) * WARPS * 32 * M, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const long long n = static_cast<long long>(a.n_b) * accumulators(a.k, IMPLICIT);
  normal_eq_fold<IMPLICIT><<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool IMPLICIT>
cudaError_t launch_mode(const Args& a, bool narrow, cudaStream_t stream) {
  switch (per_lane(a.k, IMPLICIT)) {
    case 1:
      return launch_m<T, IMPLICIT, 1>(a, narrow, stream);
    case 2:
      return launch_m<T, IMPLICIT, 2>(a, narrow, stream);
    case 3:
      return launch_m<T, IMPLICIT, 3>(a, narrow, stream);
    default:
      return launch_m<T, IMPLICIT, 4>(a, narrow, stream);
  }
}

template <typename T>
cudaError_t launch(const Args& a, bool narrow, bool implicit, cudaStream_t stream) {
  return implicit ? launch_mode<T, true>(a, narrow, stream)
                  : launch_mode<T, false>(a, narrow, stream);
}

}  // namespace

extern "C" {

int pio_train_normal_eq_limits(int* tile, int* max_rank) {
  *tile = TILE;
  *max_rank = MAX_RANK;
  return 0;
}

const char* pio_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 f32, 1 bf16, 2 int8 (v_scale required). narrow: a warp a row (splits must
// be 1), else a block per (row, part). parts: n_b * splits * (k*k+k+1) floats when
// splits > 1, else unused. Launches on `stream` and does not synchronise; returns a
// cudaError_t.
int pio_train_normal_eq(const int* idx, const float* rat, const float* msk,
                        const void* V, const float* v_scale, float* A, float* b,
                        float* cnt, float* parts, int n_b, int D, int n_opp, int k,
                        int narrow, int splits, int seg, int dtype, int implicit, float alpha,
                        void* stream) {
  if (k < 1 || k > MAX_RANK || n_b < 1 || D < 1 || n_opp < 1 || splits < 1 || seg < 1 ||
      static_cast<long long>(splits) * seg < D || (splits > 1 && parts == nullptr) ||
      (narrow && splits != 1))
    return cudaErrorInvalidValue;
  Args a{idx, rat, msk, V, nullptr, A, b, cnt, parts, n_b, D, n_opp, k, splits, seg, 0, alpha};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(a, narrow != 0, implicit != 0, s);
    case 1:
      return launch<__nv_bfloat16>(a, narrow != 0, implicit != 0, s);
    case 2:
      if (v_scale == nullptr) return cudaErrorInvalidValue;
      a.vs = v_scale;
      return launch<int8_t>(a, narrow != 0, implicit != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
