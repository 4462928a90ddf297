// Exact softmax attention, backward, for Hopper (sm_90a): two kernels.
//
// Replace the TPU kernels predictionio_tpu/ops/flash_attention.py:_bwd_dq_kernel
// (dq) and :_bwd_dkv_kernel (dk, dv), both reached through _flash_2d_bwd from the
// custom VJP of flash_attention (every SASRec layer at a flash-eligible length,
// in training) and from flash_block_bwd (one block pair of the ring backward).
//
// What they compute, per batch·head b, in the recomputation form (all float32):
//   s[r,c]  = sum_d (q[r,d] * scale) * k[c,d]        q·scale rounded once, as the TPU kernels
//   s[r,c]  = NEG_INF (-1e30) where causal and r < c    positions absolute, also for T_q != T_kv
//   p[r,c]  = exp(s[r,c] - lse[r])                    lse is the forward's (global, for a ring block)
//   dp[r,c] = sum_d do[r,d] * v[c,d]
//   ds[r,c] = p[r,c] * (dp[r,c] - delta[r])           delta = sum_d do·o, computed by the wrapper
//   dq[r]   = (sum_c ds[r,c] * k[c,:]) * scale        scale applied once at the end, as the TPU kernel
//   dk[c]   = (sum_r ds[r,c] * q[r,:]) * scale        (the TPU kernel scales per 128-row query tile)
//   dv[c]   = sum_r p[r,c] * do[r,:]
// Plain f32 FMAs and expf: no TF32, no fast math. No atomics: each output row is
// owned by one block, which loops over the other axis itself.
//
// What bounds them: inputs read once and outputs written once, kernel 5 moves
// 4*BH*(3*T_q*h + 2*T_kv*h + 2*T_q) bytes against 6*h*pairs*BH f32 operations
// (three products over each visible (query, key) pair: s, dp, ds·k), kernel 6
// 4*BH*(2*T_q*h + 4*T_kv*h + 2*T_q) bytes against 8*h*pairs*BH (s, dp, p·do,
// ds·q). At the SASRec training shape (BH = 128, T = 256, h = 50, causal) that is
// 33 MB against 1.26 GFLOP and 40 MB against 1.68 GFLOP: operations bound both,
// at 18.9 and 25.1 us on 67 TFLOP/s (the bytes alone take 9.9 and 11.8 us).
//
// Design. The TPU kernels walk (q block, k block) grids of 128 x 128 tiles, dq
// with the key axis innermost and dk/dv with the query axis innermost, carrying
// the sums in VMEM scratch. On Hopper both take kernel 4's layout
// (csrc/flash_fwd.cu):
//   - one block of 256 threads per (batch·head, 64-row tile) of the axis it
//     owns; the other axis is a loop inside the block, so the sums live in
//     registers: dq 4 x 4*NJ floats a thread, dk and dv 2 x 4 x 4*NJ;
//   - operand tiles are staged transposed in shared memory, [d][68], and read as
//     float4s by a 16 x 16 thread grid that owns 4 x 4 entries of each 64 x 64
//     score tile; staging reads each tile's contiguous rows*d floats one scalar at
//     a time, so head width 50 needs no special case;
//   - the two score products of a tile (s and dp) and the accumulation read three
//     layouts of the moving operands; they take turns in ONE staging buffer
//     (transposed for the products, row-major [64][round4(d)] for the
//     accumulation), so a head width of 256 fits in 221 KB of shared memory;
//   - p (kernel 6) and ds go through shared memory once per tile, laid out so the
//     accumulation reads them as float4s;
//   - causal tiles wholly above the diagonal are skipped (kernel 5: key tiles past
//     the query tile; kernel 6: query tiles before the key tile), and so are the
//     diagonal tile's keys that no query row of kernel 5's block sees. In the TPU
//     kernels those scores are -1e30 and exp(-1e30 - lse) is exactly 0, so the
//     sums come out the same;
//   - heaviest tiles first: kernel 5 runs the last query tiles first, kernel 6
//     the first key tiles.
// Head widths 1..256 through NJ = ceil(h / 64) in {1, 2, 3, 4}; kernel 6 holds
// 32*NJ accumulators a thread (128 at NJ = 4), with 256 threads at most 255
// registers each (nvcc -Xptxas -v reports registers and spills per NJ). Tensor
// cores (wgmma), TMA and a fused single-pass backward are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;        // rows of a query and of a key/value tile
constexpr int THREADS = 256;    // a 16 x 16 thread grid
constexpr int MAX_HEAD = 256;
constexpr int TS = TILE + 4;    // row stride of the transposed tiles: float4-aligned
constexpr float NEG_INF = -1e30f;

// rows*d contiguous floats of src → dst[c][TS] transposed (times mul), zeros past nr
__device__ __forceinline__ void stage_t(float* dst, const float* src, int nr, int d, float mul,
                                        bool scaled) {
  for (int u = threadIdx.x; u < TILE * d; u += THREADS) {
    const int r = u / d, c = u - r * d;
    dst[c * TS + r] = r < nr ? (scaled ? __fmul_rn(src[u], mul) : src[u]) : 0.f;
  }
}

// rows*d contiguous floats of src → dst[r][ds] row-major; rows past nr are not read
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int nr, int d, int ds) {
  for (int u = threadIdx.x; u < nr * d; u += THREADS) {
    const int r = u / d, c = u - r * d;
    dst[r * ds + c] = src[u];
  }
}

// out[i][j] = sum_c aT[c][4*ty + i] * bT[c][4*tx + j]
__device__ __forceinline__ void tile_product(float out[4][4], const float* aT, const float* bT,
                                             int d, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < d; ++c) {
    const float4 a = *reinterpret_cast<const float4*>(aT + c * TS + 4 * ty);
    const float4 b = *reinterpret_cast<const float4*>(bT + c * TS + 4 * tx);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = fmaf(av[i], bv[j], out[i][j]);
  }
}

// acc[i][4*jj + e] += sum_{n < count} wT[n][4*ty + i] * rows[n][64*jj + 4*tx + e]
template <int NJ>
__device__ __forceinline__ void accumulate(float acc[4][4 * NJ], const float* wT, const float* rows,
                                           int count, int d, int ds, int ty, int tx) {
  for (int n = 0; n < count; ++n) {
    const float4 a = *reinterpret_cast<const float4*>(wT + n * TS + 4 * ty);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      if (64 * jj + 4 * tx < d) {
        const float4 b = *reinterpret_cast<const float4*>(rows + n * ds + 64 * jj + 4 * tx);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][4 * jj + e] = fmaf(av[i], bv[e], acc[i][4 * jj + e]);
      }
    }
  }
}

// the staging buffer holds a transposed [d][TS] tile or a row-major [TILE][ds] one
__host__ __device__ inline int stage_floats(int d) {
  const int ds = (d + 3) & ~3;
  return d * TS > TILE * ds ? d * TS : TILE * ds;
}

// Kernel 5: dq. One block per (batch·head, 64-row query tile).
template <int NJ>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int n_bh, int n_qt, int t_q,
    int t_kv, int d, int causal, float scale) {
  const int ds = (d + 3) & ~3;
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;              // [d][TS]  q * scale, transposed
  float* doT = qT + d * TS;      // [d][TS]  do, transposed
  float* buf = doT + d * TS;     // k or v transposed, then k row-major
  float* dsT = buf + stage_floats(d);   // [TILE][TS]  ds, transposed: dsT[key][row]

  const int bh = blockIdx.x % n_bh;
  const int qt = n_qt - 1 - blockIdx.x / n_bh;   // heaviest tiles first
  const int q0 = qt * TILE;
  const int nq = min(TILE, t_q - q0);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long long row0 = static_cast<long long>(bh) * t_q + q0;
  const float* kb = k + static_cast<long long>(bh) * t_kv * d;
  const float* vb = v + static_cast<long long>(bh) * t_kv * d;

  stage_t(qT, q + row0 * d, nq, d, scale, true);
  stage_t(doT, dout + row0 * d, nq, d, 1.f, false);
  float lr[4], dl[4];   // rows past t_q: lse +inf makes their p exactly 0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    lr[i] = r < nq ? lse[row0 + r] : INFINITY;
    dl[i] = r < nq ? delta[row0 + r] : 0.f;
  }

  int n_kt = (t_kv + TILE - 1) / TILE;
  if (causal) n_kt = min(n_kt, (q0 + nq - 1) / TILE + 1);

  float acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4 * NJ; ++e) acc[i][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TILE;
    const int nk = min(TILE, t_kv - k0);
    const float* kt_b = kb + static_cast<long long>(k0) * d;
    float s[4][4], dp[4][4];
    __syncthreads();   // the previous tile's readers are done with buf and dsT
    stage_t(buf, kt_b, nk, d, 1.f, false);
    __syncthreads();
    tile_product(s, qT, buf, d, ty, tx);
    __syncthreads();
    stage_t(buf, vb + static_cast<long long>(k0) * d, nk, d, 1.f, false);
    __syncthreads();
    tile_product(dp, doT, buf, d, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + 4 * tx + j;
        float sv = s[i][j];
        if (c >= t_kv) {
          sv = -INFINITY;
        } else if (causal && r < c) {
          sv = NEG_INF;
        }
        const float p = expf(sv - lr[i]);
        s[i][j] = p * (dp[i][j] - dl[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(dsT + (4 * tx + j) * TS + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();   // dsT written; everyone is done reading v from buf
    stage_rows(buf, kt_b, nk, d, ds);
    __syncthreads();
    // dq += ds k over the keys some row of this block sees
    const int nc = causal ? min(nk, q0 + nq - k0) : nk;
    accumulate<NJ>(acc, dsT, buf, nc, d, ds, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r < nq) {
      float* out = dq + (row0 + r) * d;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 64 * jj + 4 * tx + e;
          if (col < d) out[col] = acc[i][4 * jj + e] * scale;
        }
    }
  }
}

// Kernel 6: dk and dv. One block per (batch·head, 64-row key tile); the thread
// grid's rows are keys and its columns queries (the transposed score tile).
template <int NJ>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int n_bh,
    int t_q, int t_kv, int d, int causal, float scale) {
  const int ds = (d + 3) & ~3;
  extern __shared__ __align__(16) float smem[];
  float* kT = smem;              // [d][TS]  k, transposed
  float* vT = kT + d * TS;       // [d][TS]  v, transposed
  float* buf = vT + d * TS;      // q·scale or do transposed, then do or q row-major
  float* wT = buf + stage_floats(d);   // [TILE][TS]  p, then ds: wT[row][key]

  const int bh = blockIdx.x % n_bh;
  const int kt = blockIdx.x / n_bh;   // the first key tiles are the heaviest under a causal mask
  const int k0 = kt * TILE;
  const int nk = min(TILE, t_kv - k0);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long long key0 = static_cast<long long>(bh) * t_kv + k0;
  const float* qb = q + static_cast<long long>(bh) * t_q * d;
  const float* ob = dout + static_cast<long long>(bh) * t_q * d;

  stage_t(kT, k + key0 * d, nk, d, 1.f, false);
  stage_t(vT, v + key0 * d, nk, d, 1.f, false);

  const int n_qt = (t_q + TILE - 1) / TILE;
  const int qt0 = causal ? kt : 0;   // query tiles before the key tile see none of it

  float dk_acc[4][4 * NJ], dv_acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4 * NJ; ++e) {
      dk_acc[i][e] = 0.f;
      dv_acc[i][e] = 0.f;
    }

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * TILE;
    const int nq = min(TILE, t_q - q0);
    const long long row0 = static_cast<long long>(bh) * t_q + q0;
    float lr[4], dl[4];   // per query column 4tx+j; rows past t_q get p = 0
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * tx + j;
      lr[j] = r < nq ? lse[row0 + r] : INFINITY;
      dl[j] = r < nq ? delta[row0 + r] : 0.f;
    }
    float s[4][4], dp[4][4];
    __syncthreads();   // the previous tile's readers are done with buf and wT
    stage_t(buf, qb + static_cast<long long>(q0) * d, nq, d, scale, true);
    __syncthreads();
    tile_product(s, kT, buf, d, ty, tx);   // s[key i][query j]
    __syncthreads();
    stage_t(buf, ob + static_cast<long long>(q0) * d, nq, d, 1.f, false);
    __syncthreads();
    tile_product(dp, vT, buf, d, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = k0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = q0 + 4 * tx + j;
        float sv = s[i][j];
        if (c >= t_kv) {
          sv = -INFINITY;
        } else if (causal && r < c) {
          sv = NEG_INF;
        }
        s[i][j] = expf(sv - lr[j]);   // p
        dp[i][j] = s[i][j] * (dp[i][j] - dl[j]);   // ds
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(wT + (4 * tx + j) * TS + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();   // p written; everyone is done reading do from buf
    stage_rows(buf, ob + static_cast<long long>(q0) * d, nq, d, ds);
    __syncthreads();
    accumulate<NJ>(dv_acc, wT, buf, nq, d, ds, ty, tx);   // dv += pᵀ do
    __syncthreads();   // done reading p and do
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(wT + (4 * tx + j) * TS + 4 * ty) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    stage_rows(buf, qb + static_cast<long long>(q0) * d, nq, d, ds);
    __syncthreads();
    accumulate<NJ>(dk_acc, wT, buf, nq, d, ds, ty, tx);   // dk += dsᵀ q
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 4 * ty + i;
    if (c < nk) {
      float* ko = dk + (key0 + c) * d;
      float* vo = dv + (key0 + c) * d;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 64 * jj + 4 * tx + e;
          if (col < d) {
            ko[col] = dk_acc[i][4 * jj + e] * scale;
            vo[col] = dv_acc[i][4 * jj + e];
          }
        }
    }
  }
}

// Dynamic shared memory above 48 KB needs an opt-in, made once per kernel: the
// device's opt-in limit less the kernel's static shared memory.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(attr.sharedSizeBytes));
  return e;
}

template <int NJ>
cudaError_t opt_in_dq() {
  static const cudaError_t err = opt_in_smem(flash_bwd_dq_kernel<NJ>);
  return err;
}

template <int NJ>
cudaError_t opt_in_dkv() {
  static const cudaError_t err = opt_in_smem(flash_bwd_dkv_kernel<NJ>);
  return err;
}

size_t smem_bytes(int d) {
  return sizeof(float) * (2 * static_cast<size_t>(d) * TS + stage_floats(d) + TILE * TS);
}

template <int NJ>
cudaError_t launch_dq(const float* q, const float* k, const float* v, const float* dout,
                      const float* lse, const float* delta, float* dq, int n_bh, int t_q,
                      int t_kv, int d, int causal, float scale, cudaStream_t stream) {
  const int n_qt = (t_q + TILE - 1) / TILE;
  const long long blocks = static_cast<long long>(n_bh) * n_qt;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d);
  if (smem > 48 * 1024) {
    const cudaError_t e = opt_in_dq<NJ>();
    if (e != cudaSuccess) return e;
  }
  flash_bwd_dq_kernel<NJ><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, n_bh, n_qt, t_q, t_kv, d, causal, scale);
  return cudaGetLastError();
}

template <int NJ>
cudaError_t launch_dkv(const float* q, const float* k, const float* v, const float* dout,
                       const float* lse, const float* delta, float* dk, float* dv, int n_bh,
                       int t_q, int t_kv, int d, int causal, float scale, cudaStream_t stream) {
  const int n_kt = (t_kv + TILE - 1) / TILE;
  const long long blocks = static_cast<long long>(n_bh) * n_kt;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d);
  if (smem > 48 * 1024) {
    const cudaError_t e = opt_in_dkv<NJ>();
    if (e != cudaSuccess) return e;
  }
  flash_bwd_dkv_kernel<NJ><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, n_bh, t_q, t_kv, d, causal, scale);
  return cudaGetLastError();
}

bool bad_shape(int n_bh, int t_q, int t_kv, int d) {
  return n_bh < 1 || t_q < 1 || t_kv < 1 || d < 1 || d > MAX_HEAD;
}

}  // namespace

extern "C" {

int pio_flash_bwd_limits(int* tile, int* max_head) {
  *tile = TILE;
  *max_head = MAX_HEAD;
  return 0;
}

const char* pio_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, dout (n_bh, t_q, d), k and v (n_bh, t_kv, d), lse and delta (n_bh, t_q),
// dq (n_bh, t_q, d): float32, contiguous. Launches on `stream` and does not
// synchronise; returns a cudaError_t.
int pio_flash_bwd_dq(const float* q, const float* k, const float* v, const float* dout,
                     const float* lse, const float* delta, float* dq, int n_bh, int t_q,
                     int t_kv, int d, int causal, float scale, void* stream) {
  if (bad_shape(n_bh, t_q, t_kv, d)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 63) / 64) {
    case 1:
      return launch_dq<1>(q, k, v, dout, lse, delta, dq, n_bh, t_q, t_kv, d, causal, scale, s);
    case 2:
      return launch_dq<2>(q, k, v, dout, lse, delta, dq, n_bh, t_q, t_kv, d, causal, scale, s);
    case 3:
      return launch_dq<3>(q, k, v, dout, lse, delta, dq, n_bh, t_q, t_kv, d, causal, scale, s);
    default:
      return launch_dq<4>(q, k, v, dout, lse, delta, dq, n_bh, t_q, t_kv, d, causal, scale, s);
  }
}

// The same inputs; dk and dv (n_bh, t_kv, d), float32, contiguous.
int pio_flash_bwd_dkv(const float* q, const float* k, const float* v, const float* dout,
                      const float* lse, const float* delta, float* dk, float* dv, int n_bh,
                      int t_q, int t_kv, int d, int causal, float scale, void* stream) {
  if (bad_shape(n_bh, t_q, t_kv, d)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 63) / 64) {
    case 1:
      return launch_dkv<1>(q, k, v, dout, lse, delta, dk, dv, n_bh, t_q, t_kv, d, causal, scale, s);
    case 2:
      return launch_dkv<2>(q, k, v, dout, lse, delta, dk, dv, n_bh, t_q, t_kv, d, causal, scale, s);
    case 3:
      return launch_dkv<3>(q, k, v, dout, lse, delta, dk, dv, n_bh, t_q, t_kv, d, causal, scale, s);
    default:
      return launch_dkv<4>(q, k, v, dout, lse, delta, dk, dv, n_bh, t_q, t_kv, d, causal, scale, s);
  }
}

}  // extern "C"
