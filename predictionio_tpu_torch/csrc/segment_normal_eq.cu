// The segment solver's normal equations, one launch a half-step, for Hopper (sm_90a).
//
// Replaces, on the segment solver's path, the TPU kernel
// predictionio_tpu/ops/train_kernel.py:_gather_rows_kernel (kernel 3, reached through
// fused_gather_rows) together with the chunk body it feeds: models/als.py:_half_step_local's
// lax.scan over chunks of _CHUNK ratings, each gathering V's rows, forming the outer products
// and adding them into A, b and cnt with segment_sum. Reached through fused_segment_normal_eq.
//
// What it computes, in the plain version's order, which is JAX's: for each entity e
//   A_e   = ((0 + S_e^1) + S_e^2) + ...   over the chunks c that hold slots of e, in order
//   S_e^c = ((0 + o_1) + o_2) + ...       over e's slots of chunk c, in stream order
// and b and cnt alike. A chunk without a slot of e adds +0 and a padding slot adds +-0; a
// sum that starts from +0 never becomes -0, so neither changes a value, and the layout drops
// both. Per slot, with v the gathered row widened to f32 (int8 times its row scale, one
// rounded multiply, as csrc/gather_rows.cu) and r its rating:
//   explicit  o_ij = v_i * v_j             b-term v_i * r               cnt-term 1
//   implicit  o_ij = v_i * (v_j * (a*r))   b-term v_i * (1 + a*r)       cnt 0
// Every product and every sum is one f32 rounding: __fmul_rn and __fadd_rn, which the
// compiler never contracts into an FMA, and no tensor core, since TF32 or wgmma would round
// elsewhere. So the kernel equals the plain version on the CPU bit for bit, and one seed
// gives one model.
//
// The layout (ops/train_kernel.py:segment_layout, built once per side): the real slots sorted
// by entity, stably, so each entity's slots keep stream order and fall into runs, one for each
// chunk that holds any, in chunk order. run_off holds the runs' slot offsets and ent_runs each
// entity's run offsets; heavy and light list the entities by how they are scheduled.
//
// What bounds it: one half-step reads the sorted stream once (other and rating, 8 B a slot),
// the run offsets, and each distinct row of V once (2.4 MB of items, 6.5 MB of users at f32,
// rank 10), and writes A, b and cnt once (k^2 + k + 1 floats an entity). At the ML-25M shape
// that is ~200 MB of stream, 28-65 MB of run offsets and 26-72 MB of output, 0.08-0.10 ms at
// 3.35 TB/s. Its f32 operations, k(k+1) + 2k + 1 a slot (explicit A is symmetric, below) and
// k(k+1)/2 + k + 1 a run (the fold; 7-16 M runs), come to 3.7-4.4 GFLOP, 0.06 ms at
// 67 TFLOP/s outside the tensor cores: bytes bound it.
//
// Design. The TPU path gathered a chunk of rows into HBM, wrote (chunk, k, k) outer products
// and scattered them into A with segment_sum, one chunk after the other. Here nothing but
// A, b and cnt is written, V stays in the 50 MB L2, and no sum needs an atomic:
//   * one warp owns one entity and a tile of 32 * M of its accumulators, M a lane in
//     registers: the fewest that hold an entity's in one tile, at most four (one kernel
//     for each M). Explicit A is symmetric bit for bit (v_i * v_j == v_j * v_i, summed in
//     the same order), so only i <= j is summed and stored twice: k(k+1)/2 + k + 1
//     accumulators (rank 10: 66, M = 3); implicit k^2 + k + 1 (111, M = 4). Larger ranks
//     take more tiles, one task each, over the grid.
//   * the warp walks the entity's slots in batches of up to 32: lanes load the slots' ids
//     and ratings and the next 32 run ends at once, then the batch's rows of V, widened, into
//     a record per slot in shared memory (v, v * a*r, the b weight, 1, 0), coalesced. Then it
//     adds slot after slot, each lane its products of two record entries, and folds the
//     run's sum into the carry where a run ends.
//   * a hot entity (the top item holds ~0.4% of 25 M ratings) would keep one warp busy long
//     after the rest: an entity with at least HEAVY_SLOTS slots and more than one run gets a
//     block instead. Its eight warps take eight runs at a time, each writes its run's sum to
//     shared memory, and one thread per accumulator folds the eight sums in chunk order.
//   * heavy blocks come first in the grid, then the light entities, most slots first.
// Each output value is written once (explicit A's mirror entries twice, the same value).
// Making it faster (cp.async prefetch of the next batch, fewer shared loads a product, a
// few products per lane that share an operand) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                // warps a block
constexpr int THREADS = WARPS * 32;
constexpr int MAX_PER_LANE = 4;         // accumulators a lane, at most
constexpr int STAGE_FLOATS = 1024;      // staged records a warp, in floats
constexpr int MAX_RANK = 1024;          // (Python: MAX_SEGMENT_RANK)
constexpr unsigned FULL = 0xffffffffu;

// floats of one staged slot: v (k), v * a*r (k), the b weight, 1 and 0
__host__ __device__ __forceinline__ int record(int k) { return 2 * k + 3; }
__host__ __device__ __forceinline__ int batch_rows(int k) {
  const int rows = STAGE_FLOATS / record(k);
  return rows < 1 ? 1 : (rows > 32 ? 32 : rows);
}
// shared floats of one warp: its records, then the batch's row ids and a*r
__host__ __device__ __forceinline__ int warp_floats(int k) {
  return batch_rows(k) * record(k) + 64;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(int8_t v) { return static_cast<float>(v); }

struct Args {
  const int* other;     // (nnz,) sorted by entity, stream order within
  const float* rating;  // (nnz,)
  const int* run_off;   // (n_runs + 1,) slot offsets of the runs
  const int* ent_runs;  // (n + 1,) run offsets of the entities
  const int* heavy;     // (n_heavy,) entities a block reduces
  const int* light;     // (n_light,) entities a warp reduces
  const void* V;        // (n_opp, k) f32, bf16 or int8
  const float* scale;   // (n_opp,) int8 row scales, else null
  float* A;             // (n, k, k)
  float* b;             // (n, k)
  float* cnt;           // (n,)
  int n_heavy, n_light, n_opp, k, tiles, implicit;
  float alpha;
};

// Accumulators an entity needs: explicit A is symmetric bit for bit (v_i * v_j is
// v_j * v_i, summed in the same order), so only i <= j is summed and stored twice;
// implicit A is not (v_i * (v_j * a*r)), so all k^2. Then b (k) and cnt (1).
__host__ __device__ __forceinline__ int accumulators(int k, bool implicit) {
  return (implicit ? k * k : k * (k + 1) / 2) + k + 1;
}

enum Kind { KIND_A, KIND_B, KIND_CNT, KIND_NONE };

// Accumulator t: what it sums and where it is stored. Explicit A enumerates i <= j
// row by row.
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
    kind = t == n_a + k ? KIND_CNT : KIND_NONE;
  }
}

// The record entries whose product accumulator t adds a slot: A[i][j] takes v_i and v_j
// (implicit: v_j * a*r), b[i] takes v_i and the b weight, cnt takes 1 * 1 (implicit 1 * 0).
// Accumulators past the last add 0 * 0 and are not stored.
__device__ __forceinline__ void operands(int t, int k, bool implicit, int& x, int& y) {
  const int b_weight = 2 * k, one = 2 * k + 1, zero = 2 * k + 2;
  Kind kind;
  int i, j;
  decode(t, k, implicit, kind, i, j);
  switch (kind) {
    case KIND_A:
      x = i;
      y = (implicit ? k : 0) + j;
      break;
    case KIND_B:
      x = i;
      y = b_weight;
      break;
    case KIND_CNT:
      x = one;
      y = implicit ? zero : one;
      break;
    default:
      x = y = zero;
  }
}

__device__ __forceinline__ void store(const Args& a, int e, int t, float v) {
  const int k = a.k;
  Kind kind;
  int i, j;
  decode(t, k, a.implicit, kind, i, j);
  if (kind == KIND_A) {
    float* Ae = a.A + static_cast<long long>(e) * k * k;
    Ae[i * k + j] = v;
    if (!a.implicit) Ae[j * k + i] = v;
  } else if (kind == KIND_B) {
    a.b[static_cast<long long>(e) * k + i] = v;
  } else if (kind == KIND_CNT) {
    a.cnt[e] = v;
  }
}

// A lane's place in the batch's (rows, k) staging grid, stepped 32 values at a time
// without a division.
struct Grid {
  int s, c, ds, dc;
};

// One warp folds the runs r0 .. r1-1 (slots run_off[r0] .. run_off[r1] - 1) into acc: each
// run's sum S = ((0 + o_1) + o_2) + ... in slot order, then acc = acc + S at the run's end.
// The lane owns M accumulators; x and y name their operands in a slot's record.
template <typename T, int M>
__device__ void reduce_runs(const Args& a, float* rec, int* ids, float* cws, Grid g, int r0,
                            int r1, const int (&x)[M], const int (&y)[M], float (&acc)[M]) {
  const int lane = threadIdx.x & 31;
  const int k = a.k, P = record(k), rows = batch_rows(k);
  const T* V = static_cast<const T*>(a.V);
  const int s1 = a.run_off[r1];
  int run = r0;  // the run that holds the batch's first slot
  float S[M];
#pragma unroll
  for (int m = 0; m < M; ++m) S[m] = 0.f;
  for (int p0 = a.run_off[r0]; p0 < s1; p0 += rows) {
    const int nb = min(rows, s1 - p0);
    // the next 32 run ends: every one is past p0, and at most nb fall inside the batch
    const int end = run + 1 + lane <= r1 ? __ldg(a.run_off + run + 1 + lane) : INT_MAX;
    const bool ends = end <= p0 + nb;
    const unsigned ends_at = __reduce_or_sync(FULL, ends ? 1u << (end - p0 - 1) : 0u);
    run += __popc(__ballot_sync(FULL, ends));
    if (lane < nb) {
      int o = __ldg(a.other + p0 + lane);
      o = o < 0 ? 0 : (o >= a.n_opp ? a.n_opp - 1 : o);  // clamped, as XLA's gather
      const float r = __ldg(a.rating + p0 + lane);
      const float cw = __fmul_rn(a.alpha, r);  // a*r (times the mask, 1)
      ids[lane] = o;
      cws[lane] = cw;
      rec[lane * P + 2 * k] = a.implicit ? __fadd_rn(1.f, cw) : r;
    }
    __syncwarp();
    int row = g.s, col = g.c;  // value q of the batch is row q / k, column q % k
#pragma unroll 4
    for (int q = lane; q < nb * k; q += 32) {
      const int o = ids[row];
      float v = widen(V[static_cast<long long>(o) * k + col]);
      if (a.scale != nullptr) v = __fmul_rn(v, __ldg(a.scale + o));
      rec[row * P + col] = v;
      if (a.implicit) rec[row * P + k + col] = __fmul_rn(v, cws[row]);
      row += g.ds;
      col += g.dc;
      if (col >= k) {
        col -= k;
        ++row;
      }
    }
    __syncwarp();
    for (int s = 0; s < nb; ++s) {
      const float* xs = rec + s * P;
#pragma unroll
      for (int m = 0; m < M; ++m) S[m] = __fadd_rn(S[m], __fmul_rn(xs[x[m]], xs[y[m]]));
      if (ends_at >> s & 1u) {
#pragma unroll
        for (int m = 0; m < M; ++m) {
          acc[m] = __fadd_rn(acc[m], S[m]);
          S[m] = 0.f;
        }
      }
    }
    __syncwarp();  // the records are read before the next batch overwrites them
  }
}

// M accumulators a lane, a tile of 32 * M a warp.
template <typename T, int M>
__global__ void __launch_bounds__(THREADS, 4) segment_normal_eq_kernel(Args a) {
  constexpr int TILE = 32 * M;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = a.k, P = record(k), rows = batch_rows(k);
  const int E = accumulators(k, a.implicit);
  float* rec = smem + warp * warp_floats(k);
  int* ids = reinterpret_cast<int*>(rec + rows * P);
  float* cws = rec + rows * P + 32;
  for (int s = lane; s < rows; s += 32) {
    rec[s * P + 2 * k + 1] = 1.f;
    rec[s * P + 2 * k + 2] = 0.f;
  }
  const Grid g{lane / k, lane % k, 32 / k, 32 % k};
  const long long heavy_blocks = static_cast<long long>(a.n_heavy) * a.tiles;
  int x[M], y[M];
  if (blockIdx.x < heavy_blocks) {
    // a block for one hot entity's tile: eight runs at a time, folded in chunk order
    const int e = a.heavy[blockIdx.x / a.tiles], tile = blockIdx.x % a.tiles;
#pragma unroll
    for (int m = 0; m < M; ++m) operands(tile * TILE + m * 32 + lane, k, a.implicit, x[m], y[m]);
    float* sums = smem + WARPS * warp_floats(k);  // [WARPS][TILE]
    const int r0 = a.ent_runs[e], r1 = a.ent_runs[e + 1];
    float total = 0.f;  // thread t < TILE owns accumulator tile * TILE + t
    for (int base = r0; base < r1; base += WARPS) {
      float S[M];
#pragma unroll
      for (int m = 0; m < M; ++m) S[m] = 0.f;
      if (base + warp < r1) reduce_runs<T, M>(a, rec, ids, cws, g, base + warp, base + warp + 1, x, y, S);
#pragma unroll
      for (int m = 0; m < M; ++m) sums[warp * TILE + m * 32 + lane] = S[m];
      __syncthreads();
      if (threadIdx.x < TILE) {
        const int n = min(WARPS, r1 - base);
        for (int w = 0; w < n; ++w) total = __fadd_rn(total, sums[w * TILE + threadIdx.x]);
      }
      __syncthreads();
    }
    const int t = tile * TILE + threadIdx.x;
    if (threadIdx.x < TILE && t < E) store(a, e, t, total);
    return;
  }
  // a warp for one light entity's tile
  const long long task = (blockIdx.x - heavy_blocks) * WARPS + warp;
  if (task >= static_cast<long long>(a.n_light) * a.tiles) return;
  const int e = a.light[task / a.tiles], tile = static_cast<int>(task % a.tiles);
#pragma unroll
  for (int m = 0; m < M; ++m) operands(tile * TILE + m * 32 + lane, k, a.implicit, x[m], y[m]);
  float acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.f;
  const int r0 = a.ent_runs[e], r1 = a.ent_runs[e + 1];
  if (r1 > r0) reduce_runs<T, M>(a, rec, ids, cws, g, r0, r1, x, y, acc);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int t = tile * TILE + m * 32 + lane;
    if (t < E) store(a, e, t, acc[m]);
  }
}

// Accumulators a lane: as few as hold one entity's in one tile, at most MAX_PER_LANE.
int per_lane(int k, bool implicit) {
  const int m = (accumulators(k, implicit) + 31) / 32;
  return m < MAX_PER_LANE ? m : MAX_PER_LANE;
}

size_t smem_bytes(int k) {
  return sizeof(float) * (static_cast<size_t>(WARPS) * warp_floats(k) + WARPS * 32 * MAX_PER_LANE);
}

// Dynamic shared memory above 48 KB needs an opt-in, made once per kernel: the device's
// opt-in limit less the kernel's static shared memory.
template <typename T, int M>
cudaError_t opt_in_smem(size_t smem) {
  static const int limit = [] {
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess ||
        cudaFuncGetAttributes(&attr, segment_normal_eq_kernel<T, M>) != cudaSuccess)
      return -1;
    const int most = optin - static_cast<int>(attr.sharedSizeBytes);
    if (cudaFuncSetAttribute(segment_normal_eq_kernel<T, M>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, most) != cudaSuccess)
      return -1;
    return most;
  }();
  if (limit < 0) return cudaErrorInvalidDeviceFunction;
  return smem <= static_cast<size_t>(limit) ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int M>
cudaError_t launch_m(Args a, cudaStream_t stream) {
  a.tiles = (accumulators(a.k, a.implicit) + 32 * M - 1) / (32 * M);
  const size_t smem = smem_bytes(a.k);
  const long long heavy_blocks = static_cast<long long>(a.n_heavy) * a.tiles;
  const long long light_tasks = static_cast<long long>(a.n_light) * a.tiles;
  const long long blocks = heavy_blocks + (light_tasks + WARPS - 1) / WARPS;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = opt_in_smem<T, M>(smem);
    if (e != cudaSuccess) return e;
  }
  segment_normal_eq_kernel<T, M><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  switch (per_lane(a.k, a.implicit)) {
    case 1:
      return launch_m<T, 1>(a, stream);
    case 2:
      return launch_m<T, 2>(a, stream);
    case 3:
      return launch_m<T, 3>(a, stream);
    default:
      return launch_m<T, 4>(a, stream);
  }
}

}  // namespace

extern "C" {

int pio_segment_normal_eq_limits(int* max_rank) {
  *max_rank = MAX_RANK;
  return 0;
}

const char* pio_segment_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 f32, 1 bf16, 2 int8 (scale required, (n_opp,) f32). A (n, k, k), b (n, k) and
// cnt (n,) f32, every value written. Launches on `stream` and does not synchronise;
// returns a cudaError_t.
int pio_segment_normal_eq(const int* other, const float* rating, const int* run_off,
                          const int* ent_runs, const int* heavy, const int* light,
                          const void* V, const float* scale, float* A, float* b, float* cnt,
                          int n_heavy, int n_light, int n_opp, int k, int dtype, int implicit,
                          float alpha, void* stream) {
  if (n_heavy < 0 || n_light < 0 || n_heavy + n_light < 1 || n_opp < 1 || k < 1 ||
      k > MAX_RANK)
    return cudaErrorInvalidValue;
  if ((dtype == 2) != (scale != nullptr)) return cudaErrorInvalidValue;
  Args a{other, rating, run_off, ent_runs, heavy, light, V, scale, A, b, cnt,
         n_heavy, n_light, n_opp, k, 0, implicit != 0, alpha};  // tiles: set by launch_m
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(a, s);
    case 1:
      return launch<__nv_bfloat16>(a, s);
    case 2:
      return launch<int8_t>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
