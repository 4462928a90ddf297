// Gather -> score -> masked top-k for the serving fast path, for Hopper (sm_90a).
//
// Replaces the TPU kernel predictionio_tpu/ops/score_kernel.py:_score_topk_kernel
// (with its merge _merge_block), reached through fused_gather_score_topk.
//
// What it computes, per batch row b (all arithmetic f32, no TF32):
//   u   = float(U[u_idx[b]]) * u_scale[u_idx[b]]            (scale if given)
//   s_i = dot(u, float(V[i])) * v_scale[i]                  (scale AFTER the dot)
//   s_i = -1e30 where mask[i]                               (excluded or padded)
//   out = the k best (s_i, i) by value descending, ties to the smaller index.
//
// What bounds it: per call the kernel must read V once (n_items * rank elements
// plus v_scale and the mask), B rows of U, and write B*k pairs. At the ML-25M
// serving shape (59,392 padded items, rank 10, B <= 64, k = 100) that is
// ~2.4 MB in f32, ~0.7 us at 3.35 TB/s, and 2*B*n_items*rank f32 operations,
// ~1.1 us at 67 TFLOP/s for B = 64: a few microseconds of work, so the launch
// and the selection, not the dot products, set its time.
//
// Design. The TPU kernel sweeps item blocks in order on one core into one
// running (B, k) leaderboard in VMEM. Thread blocks on Hopper run in parallel
// and in no order, so the leaderboard is built in two launches instead:
//   pass 1, grid (n_chunks, ceil(B / 8)), 8 warps: each warp takes one batch
//     row, gathers and dequantizes that U row into shared memory once, scores
//     one CHUNK of items (V is read once per row group, the 8 warps share it
//     through L1), bitonic-sorts the CHUNK (value, index) pairs in shared memory
//     and writes its top kc = min(k, CHUNK) as a candidate list.
//   pass 2, grid B, 512 threads: merges a row's n_chunks sorted lists. Each
//     list's kc-th entry bounds the row's final k-th entry from below, so the
//     best of those bounds T lets every candidate ordered after T be skipped.
//     Survivors stream into a shared-memory buffer that is bitonic-sorted
//     (and cut back to its best Q = next_pow2(k) entries) whenever it could
//     overflow, and once at the end; its first k entries are the answer.
// Both sorts use the same two-key order, so ties resolve exactly as lax.top_k
// resolves them, across chunks included. Making it fast (one pass, wgmma for
// wide ranks, no candidate round trip through device memory) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

namespace {

constexpr int CHUNK = 512;       // items per pass-1 block (BLOCK_I in Python)
constexpr int WARPS = 8;         // batch rows per pass-1 block
constexpr int MERGE_THREADS = 512;
constexpr float NEG = -1e30f;    // excluded / padded score
constexpr int MAX_SMEM = 232448; // bytes a block may opt in to on sm_90

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

// a goes before b: larger value first, then smaller index
__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ void bitonic_step(float* v, int* id, int p, int size, int stride) {
  // stride is a power of two: pair p sits in run p / stride at offset p % stride
  const int i = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
  const int l = i + stride;
  const float a = v[i], b = v[l];
  const int ai = id[i], bi = id[l];
  const bool up = (i & size) == 0;  // this run sorts best-first
  if (up ? before(b, bi, a, ai) : before(a, ai, b, bi)) {
    v[i] = b; v[l] = a; id[i] = bi; id[l] = ai;
  }
}

__device__ __forceinline__ int pow2ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// n a power of two; one warp sorts best-first
__device__ void warp_sort(float* v, int* id, int n, int lane) {
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = lane; p < n / 2; p += 32) bitonic_step(v, id, p, size, stride);
      __syncwarp();
    }
}

// n a power of two; the whole block sorts best-first
__device__ void block_sort(float* v, int* id, int n) {
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < n / 2; p += blockDim.x) bitonic_step(v, id, p, size, stride);
      __syncthreads();
    }
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
score_chunks(const T* __restrict__ U, const float* __restrict__ us,
             const T* __restrict__ V, const float* __restrict__ vs,
             const int* __restrict__ u_idx, const unsigned char* __restrict__ mask,
             float* __restrict__ cand_v, int* __restrict__ cand_i,
             int n_users, int rank, int n_items, int batch, int kc) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.y * WARPS + warp;
  if (row >= batch) return;  // only warp-level syncs below
  float* urow = smem + warp * rank;
  float* sv = smem + WARPS * rank + warp * CHUNK;
  int* si = reinterpret_cast<int*>(smem + WARPS * rank + WARPS * CHUNK) + warp * CHUNK;

  const int u = min(max(u_idx[row], 0), n_users - 1);  // XLA's gather clamps
  const float su = us != nullptr ? us[u] : 1.f;
  for (int j = lane; j < rank; j += 32) {
    const float x = to_f32(U[static_cast<size_t>(u) * rank + j]);
    urow[j] = us != nullptr ? x * su : x;
  }
  __syncwarp();

  const int base = blockIdx.x * CHUNK;
  for (int t = lane; t < CHUNK; t += 32) {
    const int item = base + t;
    float s = -INFINITY;
    int gi = INT_MAX;  // past the catalog: sorts after everything real
    if (item < n_items) {
      const T* v = V + static_cast<size_t>(item) * rank;
      float acc = 0.f;
      for (int j = 0; j < rank; ++j) acc = fmaf(urow[j], to_f32(v[j]), acc);
      if (vs != nullptr) acc *= vs[item];
      if (mask != nullptr && mask[item]) acc = NEG;
      s = acc;
      gi = item;
    }
    sv[t] = s;
    si[t] = gi;
  }
  __syncwarp();
  warp_sort(sv, si, CHUNK, lane);

  const size_t off = (static_cast<size_t>(row) * gridDim.x + blockIdx.x) * kc;
  for (int t = lane; t < kc; t += 32) {
    cand_v[off + t] = sv[t];
    cand_i[off + t] = si[t];
  }
}

__global__ void __launch_bounds__(MERGE_THREADS)
merge_chunks(const float* __restrict__ cand_v, const int* __restrict__ cand_i,
             float* __restrict__ out_v, int* __restrict__ out_i,
             int n_chunks, int kc, int k, int S, int Q) {
  extern __shared__ float bv[];
  int* bi = reinterpret_cast<int*>(bv + S);
  __shared__ float red_v[MERGE_THREADS / 32];
  __shared__ int red_i[MERGE_THREADS / 32];
  __shared__ int s_fill;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x;
  const int n_cand = n_chunks * kc;
  const float* cv = cand_v + static_cast<size_t>(row) * n_cand;
  const int* ci = cand_i + static_cast<size_t>(row) * n_cand;

  // T bounds the row's k-th entry from below: every candidate ordered after
  // T can be skipped. Two bounds, the better one wins:
  //  (a) each list's kc-th entry, when every list holds k entries;
  //  (b) the k-th best of the lists' heads (the first j = ceil(k / n_chunks)
  //      entries of each list: at least k distinct candidates).
  float tv = -INFINITY;
  int ti = INT_MAX;
  if (kc == k) {
    for (int c = tid; c < n_chunks; c += blockDim.x) {
      const float v = cv[c * kc + kc - 1];
      const int i = ci[c * kc + kc - 1];
      if (before(v, i, tv, ti)) { tv = v; ti = i; }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float v = __shfl_down_sync(0xffffffffu, tv, o);
      const int i = __shfl_down_sync(0xffffffffu, ti, o);
      if (before(v, i, tv, ti)) { tv = v; ti = i; }
    }
    if (lane == 0) { red_v[warp] = tv; red_i[warp] = ti; }
    __syncthreads();
    tv = red_v[0]; ti = red_i[0];
    for (int w = 1; w < static_cast<int>(blockDim.x / 32); ++w)
      if (before(red_v[w], red_i[w], tv, ti)) { tv = red_v[w]; ti = red_i[w]; }
  }
  const int j = (k + n_chunks - 1) / n_chunks;
  const int n_heads = n_chunks * j;
  if (pow2ceil(n_heads) <= S) {
    const int n = pow2ceil(n_heads);
    for (int t = tid; t < n; t += blockDim.x) {
      if (t < n_heads) {
        const int c = t / j, r = t - (t / j) * j;
        bv[t] = cv[c * kc + r];
        bi[t] = ci[c * kc + r];
      } else {
        bv[t] = -INFINITY; bi[t] = INT_MAX;
      }
    }
    __syncthreads();
    block_sort(bv, bi, n);
    if (before(bv[k - 1], bi[k - 1], tv, ti)) { tv = bv[k - 1]; ti = bi[k - 1]; }
    __syncthreads();
  }
  for (int t = tid; t < S; t += blockDim.x) { bv[t] = -INFINITY; bi[t] = INT_MAX; }
  if (tid == 0) s_fill = 0;

  // Survivors stream into the buffer; when a round could overflow it, the
  // filled prefix is sorted and cut back to its best Q entries.
  const int R = S - Q;
  for (int base = 0; base < n_cand; base += R) {
    __syncthreads();
    const int fill = s_fill;
    __syncthreads();
    if (fill + R > S) {  // uniform: every thread read the same fill
      block_sort(bv, bi, pow2ceil(fill));
      for (int t = Q + tid; t < S; t += blockDim.x) { bv[t] = -INFINITY; bi[t] = INT_MAX; }
      if (tid == 0) s_fill = Q;
      __syncthreads();
    }
    for (int t = tid; t < R; t += blockDim.x) {
      const int c = base + t;
      if (c >= n_cand) break;
      const float v = cv[c];
      const int i = ci[c];
      if (!before(tv, ti, v, i)) {  // at or before T
        const int pos = atomicAdd(&s_fill, 1);
        bv[pos] = v;
        bi[pos] = i;
      }
    }
  }
  __syncthreads();
  // entries past the fill are sentinels, so sorting the prefix suffices
  block_sort(bv, bi, pow2ceil(max(s_fill, k)));
  for (int t = tid; t < k; t += blockDim.x) {
    out_v[static_cast<size_t>(row) * k + t] = bv[t];
    out_i[static_cast<size_t>(row) * k + t] = bi[t];
  }
}

// Opts a kernel in to the largest dynamic shared memory a block may use: the
// device's opt-in limit less the kernel's static shared memory (the limit
// covers both, so asking for the whole of it fails).
template <typename F>
cudaError_t opt_in_max_smem(F* kernel) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(attr.sharedSizeBytes));
  return e;
}

// The opt-in depends on nothing of the call, so it is made once per dtype: a
// function-local static is initialised once, thread-safely. The attribute
// belongs to the device current at that first call (the port drives one
// card per process).
template <typename T>
cudaError_t opt_in_smem() {
  static const cudaError_t err = [] {
    const cudaError_t e = opt_in_max_smem(score_chunks<T>);
    return e != cudaSuccess ? e : opt_in_max_smem(merge_chunks);
  }();
  return err;
}

template <typename T>
cudaError_t launch(const void* U, const float* us, const void* V, const float* vs,
                   const int* u_idx, const unsigned char* mask, float* cand_v,
                   int* cand_i, float* out_v, int* out_i, int n_users, int rank,
                   int n_items, int batch, int k, cudaStream_t stream) {
  const int kc = k < CHUNK ? k : CHUNK;
  const int n_chunks = (n_items + CHUNK - 1) / CHUNK;
  const size_t smem1 = sizeof(float) * WARPS * (rank + 2 * CHUNK);
  if (smem1 > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = opt_in_smem<T>();
  if (err != cudaSuccess) return err;
  const dim3 grid1(n_chunks, (batch + WARPS - 1) / WARPS);
  score_chunks<T><<<grid1, WARPS * 32, smem1, stream>>>(
      static_cast<const T*>(U), us, static_cast<const T*>(V), vs, u_idx, mask,
      cand_v, cand_i, n_users, rank, n_items, batch, kc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  int Q = 1;
  while (Q < k) Q <<= 1;
  const int S = Q * 2 > 4096 ? Q * 2 : 4096;
  const size_t smem2 = static_cast<size_t>(S) * (sizeof(float) + sizeof(int));
  if (smem2 > MAX_SMEM) return cudaErrorInvalidValue;
  merge_chunks<<<batch, MERGE_THREADS, smem2, stream>>>(
      cand_v, cand_i, out_v, out_i, n_chunks, kc, k, S, Q);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pio_score_topk_chunk(void) { return CHUNK; }

const char* pio_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 f32, 1 bf16, 2 int8. u_scale, v_scale and mask may be null.
// Launches on `stream` and does not synchronise; returns a cudaError_t.
int pio_score_topk(const void* U, const float* u_scale, const void* V,
                   const float* v_scale, const int* u_idx, const unsigned char* mask,
                   float* cand_v, int* cand_i, float* out_v, int* out_i,
                   int n_users, int rank, int n_items, int batch, int k, int dtype,
                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(U, u_scale, V, v_scale, u_idx, mask, cand_v, cand_i, out_v,
                           out_i, n_users, rank, n_items, batch, k, s);
    case 1:
      return launch<__nv_bfloat16>(U, u_scale, V, v_scale, u_idx, mask, cand_v, cand_i,
                                   out_v, out_i, n_users, rank, n_items, batch, k, s);
    case 2:
      return launch<int8_t>(U, u_scale, V, v_scale, u_idx, mask, cand_v, cand_i, out_v,
                            out_i, n_users, rank, n_items, batch, k, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
