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
// V (2.4 MB of items, 6.5 MB of users at f32) is read through the 50 MB L2, and
// blocks run in parallel and in no order, so:
//   pass 1, one block per (row, part): a row's D slots are cut into `splits`
//     parts of `seg` slots, so the widest rows (96,168 slots at the ML-25M zipf
//     shape) spread over many SMs. The block stages TILE slots at a time in shared
//     memory (the gathered, weighted rows X and Y below). Its threads form G
//     groups of k + 1; thread i of a group owns row i of A and b[i], so it loads
//     X[s][i] once per slot and reads Y[s] four columns at a time (k + 1 FMAs for
//     about k/4 + 3 shared loads); group g takes every G-th staged slot. At the
//     end the groups' sums are added in group order. A row of one part writes A,
//     b and cnt directly; a split row writes its k*k + k + 1 partial sums.
//   pass 2 (only when a bucket is split): one thread per (row, output) sums the
//     row's parts in part order.
// Every sum is taken in an order fixed by the shapes alone, with no atomics, so
// one seed gives one model. Making it faster (several narrow rows per block,
// overlapping the next tile's gather with this tile's sums, tensor cores for wide
// ranks) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;        // slots staged per step (Python: TILE)
constexpr int MAX_RANK = 64;    // (Python: MAX_RANK)
constexpr int MAX_GROUPS = 16;   // slot groups per block

__host__ __device__ __forceinline__ int row_stride(int k) { return (k + 2 + 3) / 4 * 4; }

// groups of k + 1 threads per block: as many as fit in THREADS, at most MAX_GROUPS
__host__ __device__ __forceinline__ int groups(int k) {
  const int g = THREADS / (k + 1);
  return g < MAX_GROUPS ? g : MAX_GROUPS;
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

// Shared memory, per block: X and Y, TILE rows of KS floats each (k + 2 rounded
// up to a multiple of 4, so a row reads as float4s), the per-group sums and the
// staged slot metadata. Columns 0..k-1 hold the weighted rows; column k holds the
// b weight (Y); column k+1 the count weight (Y). Every output is a sum over slots:
//   A[i][j] = sum X[s][i] * Y[s][j]
//   b[i]    = sum (explicit: X, implicit: Y)[s][i] * Y[s][k]
//   cnt     = sum Y[s][k+1]
// A block is G groups of k + 1 threads. Thread i < k of a group owns row i of A
// and b[i] (X[s][i] loaded once, Y[s] read four columns at a time); thread k owns
// cnt. Group g takes slots g, g + G, ... of each tile.
template <typename T, bool IMPLICIT, int KMAX>
__global__ void __launch_bounds__(THREADS) normal_eq_parts(
    const int* __restrict__ idx, const float* __restrict__ rat,
    const float* __restrict__ msk, const T* __restrict__ V,
    const float* __restrict__ vs, float* __restrict__ A, float* __restrict__ b,
    float* __restrict__ cnt, float* __restrict__ part_out, int D, int n_opp, int k,
    int splits, int seg, float alpha) {
  constexpr bool BF16 = sizeof(T) == 2;
  extern __shared__ __align__(16) float smem[];
  const int KS = row_stride(k);
  const int R = k + 1;                  // threads per group
  const int G = blockDim.x / R;         // groups
  const int E = k * k + k + 1;
  float* X = smem;
  float* Y = X + TILE * KS;
  float* red = Y + TILE * KS;           // [G][E]
  float* s_m = red + G * E;
  float* s_r = s_m + TILE;
  int* s_idx = reinterpret_cast<int*>(s_r + TILE);

  const long long row = blockIdx.x / splits;
  const int part = blockIdx.x - static_cast<int>(row) * splits;
  const int d0 = part * seg;
  const int d1 = min(D, d0 + seg);
  const int tid = threadIdx.x;
  const int g = tid / R;
  const int i = tid - g * R;            // this thread's row (k: the count)

  float acc[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) acc[j] = 0.f;
  float accb = 0.f;
  const float am = alpha;

  for (int t0 = d0; t0 < d1; t0 += TILE) {
    const int n = min(TILE, d1 - t0);
    for (int t = tid; t < TILE; t += blockDim.x) {
      float m = 0.f, r = 0.f;
      int v = 0;
      if (t < n) {
        const long long o = row * D + t0 + t;
        m = msk[o];
        r = rat[o];
        v = idx[o];
        v = v < 0 ? 0 : (v >= n_opp ? n_opp - 1 : v);  // clamped, as XLA's gather
      }
      s_idx[t] = v;
      s_m[t] = m;
      s_r[t] = r;
    }
    __syncthreads();
    for (int u = tid; u < n * KS; u += blockDim.x) {
      const int s = u / KS;
      const int c = u - s * KS;
      const float m = s_m[s];
      float xv = 0.f, yv = 0.f;
      if (m != 0.f && c < k + 2) {
        const float r = s_r[s];
        const float wm = BF16 ? bf16r(m) : m;
        if (c < k) {
          const long long row_v = s_idx[s];
          float gv = load(V, row_v * k + c);
          if (vs != nullptr) gv = __fmul_rn(gv, vs[row_v]);
          if (IMPLICIT) {
            const float cw = BF16 ? bf16r(__fmul_rn(bf16r(__fmul_rn(am, r)), wm))
                                  : __fmul_rn(__fmul_rn(am, r), wm);
            xv = BF16 ? bf16r(__fmul_rn(gv, cw)) : __fmul_rn(gv, cw);
            yv = gv;
          } else {
            xv = BF16 ? bf16r(__fmul_rn(gv, wm)) : __fmul_rn(gv, wm);
            yv = xv;
          }
        } else if (c == k) {
          if (IMPLICIT) {
            const float cb = __fadd_rn(1.f, __fmul_rn(am, r));
            yv = BF16 ? bf16r(__fmul_rn(bf16r(cb), wm)) : __fmul_rn(cb, wm);
          } else {
            yv = BF16 ? bf16r(r) : r;
          }
        } else {
          yv = IMPLICIT ? 0.f : m;
        }
      }
      X[u] = xv;
      Y[u] = yv;
    }
    __syncthreads();
    if (g < G) {
      for (int s = g; s < n; s += G) {
        const float* ys = Y + s * KS;
        if (i < k) {
          const float x = X[s * KS + i];
          const float4* y4 = reinterpret_cast<const float4*>(ys);
#pragma unroll
          for (int c = 0; c < KMAX / 4; ++c) {
            if (4 * c < k) {
              const float4 y = y4[c];
              acc[4 * c + 0] = fmaf(x, y.x, acc[4 * c + 0]);
              acc[4 * c + 1] = fmaf(x, y.y, acc[4 * c + 1]);
              acc[4 * c + 2] = fmaf(x, y.z, acc[4 * c + 2]);
              acc[4 * c + 3] = fmaf(x, y.w, acc[4 * c + 3]);
            }
          }
          accb = fmaf(IMPLICIT ? ys[i] : x, ys[k], accb);
        } else {
          accb += ys[k + 1];
        }
      }
    }
    __syncthreads();
  }

  // each group's sums, then the groups folded in group order
  if (g < G) {
    float* mine = red + g * E;
    if (i < k) {
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j < k) mine[i * k + j] = acc[j];
      mine[k * k + i] = accb;
    } else {
      mine[k * k + k] = accb;
    }
  }
  __syncthreads();
  for (int e = tid; e < E; e += blockDim.x) {
    float v = 0.f;
    for (int gg = 0; gg < G; ++gg) v += red[gg * E + e];
    if (splits > 1) {
      part_out[(row * splits + part) * E + e] = v;
    } else if (e < k * k) {
      A[row * k * k + e] = v;
    } else if (e < k * k + k) {
      b[row * k + (e - k * k)] = v;
    } else {
      cnt[row] = v;
    }
  }
}

// one thread per (row, output): the parts summed in part order
__global__ void normal_eq_fold(const float* __restrict__ parts, float* __restrict__ A,
                               float* __restrict__ b, float* __restrict__ cnt, int n_b,
                               int k, int splits) {
  const int kk = k * k;
  const int E = kk + k + 1;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(n_b) * E) return;
  const long long row = t / E;
  const int e = static_cast<int>(t - row * E);
  const float* p = parts + row * splits * E + e;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += p[static_cast<long long>(s) * E];
  if (e < kk) {
    A[row * kk + e] = v;
  } else if (e < kk + k) {
    b[row * k + (e - kk)] = v;
  } else {
    cnt[row] = v;
  }
}

// Dynamic shared memory above 48 KB needs an opt-in, made once per kernel: the
// device's opt-in limit less the kernel's static shared memory.
template <typename T, bool IMPLICIT, int KMAX>
cudaError_t opt_in_smem() {
  static const cudaError_t err = [] {
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, normal_eq_parts<T, IMPLICIT, KMAX>);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(normal_eq_parts<T, IMPLICIT, KMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - static_cast<int>(attr.sharedSizeBytes));
    return e;
  }();
  return err;
}

template <typename T, bool IMPLICIT, int KMAX>
cudaError_t launch_parts(const int* idx, const float* rat, const float* msk, const T* V,
                         const float* vs, float* A, float* b, float* cnt, float* parts,
                         int n_b, int D, int n_opp, int k, int splits, int seg,
                         float alpha, cudaStream_t stream) {
  const int G = groups(k);
  const int E = k * k + k + 1;
  const size_t smem = sizeof(float) * (2 * TILE * row_stride(k) + G * E + 2 * TILE) +
                      sizeof(int) * TILE;
  const long long blocks = static_cast<long long>(n_b) * splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = opt_in_smem<T, IMPLICIT, KMAX>();
    if (e != cudaSuccess) return e;
  }
  normal_eq_parts<T, IMPLICIT, KMAX>
      <<<static_cast<unsigned>(blocks), G * (k + 1), smem, stream>>>(
          idx, rat, msk, V, vs, A, b, cnt, parts, D, n_opp, k, splits, seg, alpha);
  return cudaGetLastError();
}

template <typename T, bool IMPLICIT>
cudaError_t launch_rank(const int* idx, const float* rat, const float* msk, const T* V,
                        const float* vs, float* A, float* b, float* cnt, float* parts,
                        int n_b, int D, int n_opp, int k, int splits, int seg,
                        float alpha, cudaStream_t stream) {
  if (k <= 16)
    return launch_parts<T, IMPLICIT, 16>(idx, rat, msk, V, vs, A, b, cnt, parts, n_b, D,
                                         n_opp, k, splits, seg, alpha, stream);
  if (k <= 32)
    return launch_parts<T, IMPLICIT, 32>(idx, rat, msk, V, vs, A, b, cnt, parts, n_b, D,
                                         n_opp, k, splits, seg, alpha, stream);
  return launch_parts<T, IMPLICIT, 64>(idx, rat, msk, V, vs, A, b, cnt, parts, n_b, D,
                                       n_opp, k, splits, seg, alpha, stream);
}

template <typename T>
cudaError_t launch(const int* idx, const float* rat, const float* msk, const void* V,
                   const float* vs, float* A, float* b, float* cnt, float* parts,
                   int n_b, int D, int n_opp, int k, int splits, int seg, int implicit,
                   float alpha, cudaStream_t stream) {
  const T* Vt = static_cast<const T*>(V);
  cudaError_t err =
      implicit ? launch_rank<T, true>(idx, rat, msk, Vt, vs, A, b, cnt, parts, n_b, D,
                                      n_opp, k, splits, seg, alpha, stream)
               : launch_rank<T, false>(idx, rat, msk, Vt, vs, A, b, cnt, parts, n_b, D,
                                       n_opp, k, splits, seg, alpha, stream);
  if (err != cudaSuccess || splits == 1) return err;
  const long long n = static_cast<long long>(n_b) * (k * k + k + 1);
  const unsigned grid = static_cast<unsigned>((n + 255) / 256);
  normal_eq_fold<<<grid, 256, 0, stream>>>(parts, A, b, cnt, n_b, k, splits);
  return cudaGetLastError();
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

// dtype: 0 f32, 1 bf16, 2 int8 (v_scale required). parts: n_b * splits * (k*k+k+1)
// floats when splits > 1, else unused. Launches on `stream` and does not
// synchronise; returns a cudaError_t.
int pio_train_normal_eq(const int* idx, const float* rat, const float* msk,
                        const void* V, const float* v_scale, float* A, float* b,
                        float* cnt, float* parts, int n_b, int D, int n_opp, int k,
                        int splits, int seg, int dtype, int implicit, float alpha,
                        void* stream) {
  if (k < 1 || k > MAX_RANK || n_b < 1 || D < 1 || splits < 1 || seg < 1 ||
      static_cast<long long>(splits) * seg < D || (splits > 1 && parts == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(idx, rat, msk, V, nullptr, A, b, cnt, parts, n_b, D, n_opp, k,
                           splits, seg, implicit, alpha, s);
    case 1:
      return launch<__nv_bfloat16>(idx, rat, msk, V, nullptr, A, b, cnt, parts, n_b, D,
                                   n_opp, k, splits, seg, implicit, alpha, s);
    case 2:
      if (v_scale == nullptr) return cudaErrorInvalidValue;
      return launch<int8_t>(idx, rat, msk, V, v_scale, A, b, cnt, parts, n_b, D, n_opp,
                            k, splits, seg, implicit, alpha, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
