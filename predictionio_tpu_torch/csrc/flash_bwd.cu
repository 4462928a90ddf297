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
// Kernel 5 uses plain f32 FMAs, kernel 6 the tensor cores in the 3xTF32 form
// (csrc/mma_tf32.cuh), at float32 accuracy; both expf, no fast math. No atomics:
// each output row is owned by one block, which loops over the other axis itself.
//
// What bounds them: inputs read once and outputs written once, kernel 5 moves
// 4*BH*(3*T_q*h + 2*T_kv*h + 2*T_q) bytes against 6*h*pairs*BH f32 operations
// (three products over each visible (query, key) pair: s, dp, ds·k), kernel 6
// 4*BH*(2*T_q*h + 4*T_kv*h + 2*T_q) bytes against 8*h*pairs*BH (s, dp, p·do,
// ds·q), each of which its tensor cores run as three TF32 products, plus one
// exponential a pair. At the SASRec training shape (BH = 128, T = 256, h = 50,
// causal) that is 33 MB against 1.26 GFLOP and 40 MB against 1.68 GFLOP: operations
// bound kernel 5 at 18.9 us on 67 TFLOP/s; kernel 6's bytes (11.8 us) bound it.
//
// Design. The TPU kernels walk (q block, k block) grids of 128 x 128 tiles, dq
// with the key axis innermost and dk/dv with the query axis innermost, carrying
// the sums in VMEM scratch. On Hopper:
//   - kernel 5 (plain f32 FMAs): one block of 256 threads per (batch·head,
//     64-row query tile), looping over key tiles; operand tiles staged transposed
//     in shared memory, [d][68], and read as float4s by a 16 x 16 thread grid that
//     owns 4 x 4 entries of each 64 x 64 score tile; the two score products and
//     the accumulation take turns in ONE staging buffer; ds goes through shared
//     memory once per tile; key tiles past the query tile are skipped, and so are
//     the diagonal tile's keys no row of the block sees; last query tiles first.
//     Head widths 1..256 through NJ = ceil(h / 64) in {1, 2, 3, 4};
//   - kernel 6: one block of four warps per (batch·head, 64-key tile, 64-column
//     slice of the head), each warp owning 16 keys and their dk, dv accumulators
//     as mma C fragments (64 registers a thread at any head width: a head wider
//     than 64 takes ceil(h / 64) slices, each block recomputing s and dp over the
//     whole width); k and v staged once, then 32-query tiles of q, do, lse and
//     delta staged by cp.async in a two-stage ring (one stage when the head is too
//     wide for two), row-major with a row stride of 64*ceil(h / 64) + 4 and zero
//     columns past h, one __syncthreads a tile; the four products read that one
//     copy (see the kernel); 8-query steps before a warp's first key under a
//     causal mask are skipped (their p is exactly 0), query tiles before the key
//     tile too; the first key tiles, the heaviest, first.
// In the TPU kernels skipped scores are -1e30 and exp(-1e30 - lse) is exactly 0,
// so the sums come out the same.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

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

// Kernel 6: dk and dv. One block of four warps per (batch·head, 64-key tile, 64-wide
// slice of the head), warp w owning keys 16w..16w+15 of the tile; the block loops
// over 32-query tiles staged by cp.async in a two-stage ring (q and do row-major,
// lse and delta beside them), one __syncthreads a tile. The four products run on
// the tensor cores in the 3xTF32 form (csrc/mma_tf32.cuh) from that one copy:
// sᵀ = k (q·scale)ᵀ and dpᵀ = v doᵀ with q and do as B operands, then dv += pᵀ do
// and dk += dsᵀ q with pᵀ and dsᵀ taken straight from the score fragments. Neither
// goes through shared memory.
constexpr int KV_THREADS = 128;   // four warps of 16 keys
constexpr int KV_QT = 32;         // queries a staged tile
constexpr int KV_SLICE = 64;      // head columns a block accumulates

struct KvArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* delta;
  float* dk;
  float* dv;
  int n_bh, t_q, t_kv, d, causal;
  float scale;
  int n_kt, n_js, stages, vec;
};

// Three blocks an SM: ptxas keeps the kernel within 170 registers a thread, with
// no spill at the widths the paths use; two blocks an SM ran slower.
__global__ void __launch_bounds__(KV_THREADS, 3) flash_bwd_dkv_kernel(const KvArgs a) {
  using namespace pio_mma;
  extern __shared__ __align__(16) float smem[];
  // rows of 64 * n_js floats and 4 more: the unrolled accumulation reads zeros past h
  const int DW = KV_SLICE * a.n_js, DS = DW + 4, nd = pad8(a.d) / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const int bh = blockIdx.x % a.n_bh;
  const int rest = blockIdx.x / a.n_bh;
  const int js = rest % a.n_js;
  const int kt = rest / a.n_js;   // the first key tiles are the heaviest under a causal mask
  const int k0 = kt * TILE;
  const int nk = min(TILE, a.t_kv - k0);
  const int col0 = KV_SLICE * js;
  const long long key0 = static_cast<long long>(bh) * a.t_kv + k0;
  const float* qb = a.q + static_cast<long long>(bh) * a.t_q * a.d;
  const float* ob = a.dout + static_cast<long long>(bh) * a.t_q * a.d;
  const float* lb = a.lse + static_cast<long long>(bh) * a.t_q;
  const float* db = a.delta + static_cast<long long>(bh) * a.t_q;

  float* ks = smem;                  // [TILE][DS]  k
  float* vs = ks + TILE * DS;        // [TILE][DS]  v
  float* ring = vs + TILE * DS;      // stages x {q [KV_QT][DS], do [KV_QT][DS], lse [KV_QT], delta [KV_QT]}
  const int stage_floats = 2 * KV_QT * DS + 2 * KV_QT;

  const int qs_first = a.causal ? k0 / KV_QT : 0;   // query tiles before the key tile see none of it
  const int n_it = max(0, (a.t_q + KV_QT - 1) / KV_QT - qs_first);

  zero_pad_columns(ks, DS, 2 * TILE, a.d, DW);
  for (int s = 0; s < a.stages; ++s) zero_pad_columns(ring + s * stage_floats, DS, 2 * KV_QT, a.d, DW);
  auto issue = [&](int it, int stage) {
    const int q0 = (qs_first + it) * KV_QT, nq = min(KV_QT, a.t_q - q0);
    float* st = ring + stage * stage_floats;
    pio_mma::stage_rows(st, DS, qb + static_cast<long long>(q0) * a.d, KV_QT, nq, a.d, a.vec);
    pio_mma::stage_rows(st + KV_QT * DS, DS, ob + static_cast<long long>(q0) * a.d, KV_QT, nq, a.d, a.vec);
    stage_vector(st + 2 * KV_QT * DS, lb + q0, KV_QT, nq);
    stage_vector(st + 2 * KV_QT * DS + KV_QT, db + q0, KV_QT, nq);
  };
  pio_mma::stage_rows(ks, DS, a.k + key0 * a.d, TILE, nk, a.d, a.vec);
  pio_mma::stage_rows(vs, DS, a.v + key0 * a.d, TILE, nk, a.d, a.vec);
  if (n_it > 0) issue(0, 0);
  cp_async_commit();

  const int wk0 = k0 + 16 * warp;   // this warp's first key; this thread's keys wk0 + g, + 8
  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait_all();
    __syncthreads();   // tile `it` is in; every warp is done with the stage refilled below
    if (a.stages == 2 && it + 1 < n_it) {
      issue(it + 1, (it + 1) & 1);
      cp_async_commit();
    }
    const float* st = ring + (a.stages == 2 ? (it & 1) : 0) * stage_floats;
    const float* qsm = st;
    const float* dos = st + KV_QT * DS;
    const float* lse_s = st + 2 * KV_QT * DS;
    const float* del_s = lse_s + KV_QT;
    const int q0 = (qs_first + it) * KV_QT;
    // 8-query steps [j0, j1): past t_q, and before this warp's first key under a causal mask, none
    const int j1 = min(KV_QT / 8, (a.t_q - q0 + 7) / 8);
    const int j0 = a.causal ? min(j1, max(0, (wk0 - q0) / 8)) : 0;

    if (j0 < j1) {
      float s[KV_QT / 8][4], dp[KV_QT / 8][4];
#pragma unroll
      for (int j = 0; j < KV_QT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      const float* kr = ks + (16 * warp + g) * DS + t;
      const float* vr = vs + (16 * warp + g) * DS + t;
      for (int kk = 0; kk < nd; ++kk) {
        FragA ak, av;
        ak.set(kr[8 * kk], kr[8 * DS + 8 * kk], kr[8 * kk + 4], kr[8 * DS + 8 * kk + 4]);
        av.set(vr[8 * kk], vr[8 * DS + 8 * kk], vr[8 * kk + 4], vr[8 * DS + 8 * kk + 4]);
        FragB bq[KV_QT / 8], bo[KV_QT / 8];
#pragma unroll
        for (int j = 0; j < KV_QT / 8; ++j) {   // unguarded, so the 8 chains interleave
          const float* qr = qsm + (8 * j + g) * DS + 8 * kk + t;
          const float* orow = dos + (8 * j + g) * DS + 8 * kk + t;
          bq[j].set(__fmul_rn(qr[0], a.scale), __fmul_rn(qr[4], a.scale));
          bo[j].set(orow[0], orow[4]);
        }
        mma3_pair<KV_QT / 8>(s, ak, bq, dp, av, bo);
      }
      // pᵀ and dsᵀ: key rows wk0 + g (e = 0, 1) and + 8 (e = 2, 3), query columns 8j + 2t (+1)
#pragma unroll
      for (int j = 0; j < KV_QT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = wk0 + g + 8 * (e >> 1);
          const int rl = 8 * j + 2 * t + (e & 1);
          const int r = q0 + rl;
          float p = 0.f, ds = 0.f;
          if (r < a.t_q) {
            float sv = s[j][e];
            if (c >= a.t_kv) {
              sv = -INFINITY;
            } else if (a.causal && r < c) {
              sv = NEG_INF;
            }
            p = expf(sv - lse_s[rl]);
            ds = p * (dp[j][e] - del_s[rl]);
          }
          s[j][e] = p;
          dp[j][e] = ds;
        }
      }
      // dv += pᵀ do, dk += dsᵀ q over this slice's columns
#pragma unroll
      for (int j = 0; j < KV_QT / 8; ++j) {
        if (j >= j0 && j < j1) {
          FragA ap, ads;
          ap.set(s[j][0], s[j][2], s[j][1], s[j][3]);
          ads.set(dp[j][0], dp[j][2], dp[j][1], dp[j][3]);
          const float* orow = dos + (8 * j + 2 * t) * DS + col0 + g;
          const float* qr = qsm + (8 * j + 2 * t) * DS + col0 + g;
#pragma unroll
          for (int nb = 0; nb < 8; nb += 4) {   // unguarded: columns past h are zeros
            FragB bo[4], bq[4];
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              bo[n].set(orow[8 * (nb + n)], orow[DS + 8 * (nb + n)]);
              bq[n].set(qr[8 * (nb + n)], qr[DS + 8 * (nb + n)]);
            }
            mma3_pair<4>(dv_acc + nb, ap, bo, dk_acc + nb, ads, bq);
          }
        }
      }
    }
    if (a.stages == 1 && it + 1 < n_it) {
      __syncthreads();   // every warp is done with the only stage
      issue(it + 1, 0);
      cp_async_commit();
    }
  }

  cp_async_wait_all();   // a block no query sees still has its k and v copies in flight
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = 16 * warp + g + 8 * h;
    if (c >= nk) continue;
    float* ko = a.dk + (key0 + c) * a.d;
    float* vo = a.dv + (key0 + c) * a.d;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = col0 + 8 * n + 2 * t;
      if (col < a.d) {
        ko[col] = dk_acc[n][2 * h] * a.scale;
        vo[col] = dv_acc[n][2 * h];
      }
      if (col + 1 < a.d) {
        ko[col + 1] = dk_acc[n][2 * h + 1] * a.scale;
        vo[col + 1] = dv_acc[n][2 * h + 1];
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

// Kernel 6's dynamic shared-memory limit: the device's opt-in limit less the
// kernel's static shared memory, set once.
int dkv_smem_limit() {
  static const int limit = [] {
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
        cudaFuncGetAttributes(&attr, flash_bwd_dkv_kernel) != cudaSuccess)
      return -1;
    const int lim = optin - static_cast<int>(attr.sharedSizeBytes);
    if (cudaFuncSetAttribute(flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lim) !=
        cudaSuccess)
      return -1;
    return lim;
  }();
  return limit;
}

cudaError_t launch_dkv(KvArgs a, cudaStream_t stream) {
  const int limit = dkv_smem_limit();
  if (limit < 0) return cudaErrorInvalidValue;
  a.n_kt = (a.t_kv + TILE - 1) / TILE;
  a.n_js = (a.d + KV_SLICE - 1) / KV_SLICE;
  const void* bases[4] = {a.q, a.k, a.v, a.dout};
  a.vec = pio_mma::copy_vec(a.d, bases, 4);
  const long long blocks = static_cast<long long>(a.n_bh) * a.n_kt * a.n_js;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t ds = KV_SLICE * a.n_js + 4;
  const size_t stage = 2 * KV_QT * ds + 2 * KV_QT;
  size_t smem = sizeof(float) * (2 * TILE * ds + 2 * stage);
  a.stages = 2;
  if (smem > static_cast<size_t>(limit)) {
    a.stages = 1;
    smem -= sizeof(float) * stage;
    if (smem > static_cast<size_t>(limit)) return cudaErrorInvalidValue;
  }
  flash_bwd_dkv_kernel<<<static_cast<unsigned>(blocks), KV_THREADS, smem, stream>>>(a);
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
  KvArgs a{q, k, v, dout, lse, delta, dk, dv, n_bh, t_q, t_kv, d, causal != 0, scale};
  return launch_dkv(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
