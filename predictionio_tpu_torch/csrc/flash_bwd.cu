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
// Both run every product on the tensor cores in the 3xTF32 form (csrc/mma_tf32.cuh),
// each 8-deep step's three products summed from zero and added to a float32 sum
// rounded to nearest, at float32 accuracy; expf, no fast math. No atomics: each
// output element is summed by one block in one fixed order, so a relaunch gives
// the same bytes.
//
// What bounds them: inputs read once and outputs written once, kernel 5 moves
// 4*BH*(3*T_q*h + 2*T_kv*h + 2*T_q) bytes against 6*h*pairs*BH operations (three
// products over each visible (query, key) pair: s, dp, ds·k), kernel 6
// 4*BH*(2*T_q*h + 4*T_kv*h + 2*T_q) bytes against 8*h*pairs*BH (s, dp, p·do,
// ds·q); the tensor cores run each product as three TF32 products (495/3 TFLOP/s),
// and each pair takes one exponential at the f32 rate (67 TFLOP/s). At the SASRec
// training shape (BH = 128, T = 256, h = 50, causal) kernel 5 moves 33 MB (9.9 us)
// against 1.26 GFLOP (7.7 us + 0.06 us): bytes bound it; kernel 6's bytes too.
//
// Design. The TPU kernels walk (q block, k block) grids of 128 x 128 tiles, dq
// with the key axis innermost and dk/dv with the query axis innermost, carrying
// the sums in VMEM scratch. On Hopper, a block loops over the other axis itself:
//   - kernel 5: a block of four warps owns q_rows (64, 32 or 16) query rows and a
//     64-column slice of dq (a head wider than 64 takes ceil(h / 64) slices, each
//     block recomputing s and dp over the whole width). q_rows / 16 row groups of
//     16 rows times 64 / q_rows key groups: a warp owns one row group's dq
//     accumulators as mma C fragments and the keys of its group, 32 of every
//     32 * (64 / q_rows) (ops/flash_attention.dq_plan picks q_rows: 64 where those
//     tiles give every SM a block, fewer rows and more key groups where not).
//     q·scale (rounded once) and do are staged once a block by cp.async and, where
//     that costs no block an SM, split into TF32 hi and lo once, in shared memory,
//     for every key tile; else (the SASRec training shape, where the split copy
//     leaves two blocks an SM instead of three, and ran slower) kept as float32 and
//     split where a fragment is formed. k and v come by cp.async in a two-stage
//     ring (one stage when two do not fit), row-major with a row stride of
//     64*ceil(h / 64) + 4 and zero columns past h, one __syncthreads a staged
//     tile; a warp's lse and delta stay in registers. s = (q·scale) kᵀ and dp = do vᵀ take k and v as B operands, ds
//     goes from the score fragments straight into the A operand of dq += ds k, with
//     k read again as B from the same copy (mma_tf32.cuh says how). 8-key steps
//     past a warp's last row under a causal mask are skipped (p is exactly 0), and
//     so are key tiles past the block's; the last (heaviest) query tiles first.
//     Key groups' partial sums meet in shared memory at the end, added in group
//     order;
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
constexpr int MAX_HEAD = 256;
constexpr float NEG_INF = -1e30f;

// Kernel 5: dq. One block of four warps per (batch·head, tile of q_rows query
// rows, 64-wide slice of the head); warp w owns rows 16*(w % R)..+15 of the tile
// (R = q_rows / 16 row groups) and key group w / R: keys 32*(w / R)..+31 of every
// staged chunk of 32 * (4 / R) keys.
constexpr int DQ_THREADS = 128;
constexpr int DQ_KT = 32;         // keys a warp takes from a staged chunk
constexpr int DQ_SLICE = 64;      // dq columns a block accumulates

struct DqArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* delta;
  float* dq;
  int n_bh, t_q, t_kv, d, causal;
  float scale;
  int q_rows, n_qt, n_js, stages, vec;
};

// SPLIT: q·scale and do held as TF32 hi and lo in shared memory (four arrays),
// else as float32 (two arrays), split where a fragment is formed.
template <bool SPLIT>
__global__ void __launch_bounds__(DQ_THREADS, SPLIT ? 2 : 3) flash_bwd_dq_kernel(const DqArgs a) {
  using namespace pio_mma;
  extern __shared__ __align__(16) float smem[];
  // rows of 64 * n_js floats and 4 more: the unrolled products read zeros past h
  const int DW = DQ_SLICE * a.n_js, DS = DW + 4, nd = pad8(a.d) / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_rg = a.q_rows / 16, n_kg = 4 / n_rg;
  const int rg = warp % n_rg, kg = warp / n_rg;
  const int chunk = DQ_KT * n_kg;   // keys a staged tile

  const int bh = blockIdx.x % a.n_bh;
  const int rest = blockIdx.x / a.n_bh;
  const int js = rest % a.n_js;
  const int qt = a.n_qt - 1 - rest / a.n_js;   // the last (heaviest) query tiles first
  const int q0 = qt * a.q_rows;
  const int nq = min(a.q_rows, a.t_q - q0);
  const int col0 = DQ_SLICE * js;
  const long long row0 = static_cast<long long>(bh) * a.t_q + q0;
  const int visible = a.causal ? min(a.t_kv, q0 + nq) : a.t_kv;   // keys some row of the tile sees
  const int n_it = (visible + chunk - 1) / chunk;

  constexpr int N_A = SPLIT ? 4 : 2;
  float* aop = smem;                          // SPLIT: q hi, q lo, do hi, do lo; else q, do; [q_rows][DS]
  float* ring = aop + N_A * a.q_rows * DS;    // stages x {k [chunk][DS], v [chunk][DS]}
  const int stage_floats = 2 * chunk * DS;
  const float* kbase = a.k + static_cast<long long>(bh) * a.t_kv * a.d;
  const float* vbase = a.v + static_cast<long long>(bh) * a.t_kv * a.d;

  const int n_a = a.q_rows * DS;   // floats of one A-operand array
  float* qs = aop;                                  // q, then q·scale (its hi part where SPLIT)
  float* os = aop + (SPLIT ? 2 : 1) * n_a;          // do (its hi part where SPLIT)
  zero_pad_columns(aop, DS, N_A * a.q_rows, a.d, DW);
  for (int s = 0; s < a.stages; ++s) zero_pad_columns(ring + s * stage_floats, DS, 2 * chunk, a.d, DW);
  auto issue = [&](int it, int stage) {
    // every row of the chunk: rows past t_kv are zeros, so no product reads garbage
    const int k0 = it * chunk, nk = min(chunk, a.t_kv - k0);
    float* st = ring + stage * stage_floats;
    stage_rows(st, DS, kbase + static_cast<long long>(k0) * a.d, chunk, nk, a.d, a.vec);
    stage_rows(st + chunk * DS, DS, vbase + static_cast<long long>(k0) * a.d, chunk, nk, a.d, a.vec);
  };
  // q and do (rows past t_q as zeros: such a row has lse +inf below, so its p is 0)
  stage_rows(qs, DS, a.q + row0 * a.d, a.q_rows, nq, a.d, a.vec);
  stage_rows(os, DS, a.dout + row0 * a.d, a.q_rows, nq, a.d, a.vec);
  issue(0, 0);
  cp_async_commit();

  const int rl0 = 16 * rg + g;   // this thread's rows of the tile: rl0 and rl0 + 8
  const bool has_rows = 16 * rg < nq;
  const int warp_last = q0 + min(16 * rg + 15, nq - 1);
  float lr[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = rl0 + 8 * h < nq;
    lr[h] = in ? a.lse[row0 + rl0 + 8 * h] : INFINITY;
    dl[h] = in ? a.delta[row0 + rl0 + 8 * h] : 0.f;
  }

  // q·scale (rounded once) and, where SPLIT, both operands split into TF32 hi
  // and lo, once a block: each thread converts the elements it copied, which
  // its own wait makes visible to it; the loop's first barrier publishes them
  cp_async_wait_all();
  for_each_2d(a.q_rows, a.d / a.vec, [&](int r, int p) {
    for (int e = 0; e < a.vec; ++e) {
      const int i = r * DS + a.vec * p + e;
      const float x = __fmul_rn(qs[i], a.scale);
      if constexpr (SPLIT) {
        uint32_t hi, lo;
        split(x, hi, lo);
        qs[i] = __uint_as_float(hi);
        qs[n_a + i] = __uint_as_float(lo);
        split(os[i], hi, lo);
        os[i] = __uint_as_float(hi);
        os[n_a + i] = __uint_as_float(lo);
      } else {
        qs[i] = x;
      }
    }
  });
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int a_row = (16 * rg + g) * DS + t;   // this thread's A-fragment element of row g, column t
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait_all();
    __syncthreads();   // tile `it` is in (and q, do converted); every warp is done with the stage refilled below
    if (a.stages == 2 && it + 1 < n_it) {
      issue(it + 1, (it + 1) & 1);
      cp_async_commit();
    }
    const float* kt_s = ring + (a.stages == 2 ? (it & 1) : 0) * stage_floats + kg * DQ_KT * DS;
    const float* vt_s = kt_s + chunk * DS;
    const int k0 = it * chunk + kg * DQ_KT;
    // 8-key steps holding a key some row of this warp sees
    int nj = k0 < visible ? min(DQ_KT / 8, (visible - k0 + 7) / 8) : 0;
    if (a.causal) nj = warp_last < k0 ? 0 : min(nj, (warp_last - k0) / 8 + 1);
    if (!has_rows) nj = 0;

    if (nj > 0) {
      // all 4 key steps, unguarded, so their chains interleave; steps past nj are masked
      float s[DQ_KT / 8][4], dp[DQ_KT / 8][4];
#pragma unroll
      for (int j = 0; j < DQ_KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      for (int kk = 0; kk < nd; ++kk) {
        const int off[4] = {a_row + 8 * kk, a_row + 8 * DS + 8 * kk, a_row + 8 * kk + 4,
                            a_row + 8 * DS + 8 * kk + 4};
        FragA aq, ao;
        if constexpr (SPLIT) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            aq.hi[i] = __float_as_uint(qs[off[i]]);
            aq.lo[i] = __float_as_uint(qs[n_a + off[i]]);
            ao.hi[i] = __float_as_uint(os[off[i]]);
            ao.lo[i] = __float_as_uint(os[n_a + off[i]]);
          }
        } else {
          aq.set(qs[off[0]], qs[off[1]], qs[off[2]], qs[off[3]]);
          ao.set(os[off[0]], os[off[1]], os[off[2]], os[off[3]]);
        }
        FragB bk[DQ_KT / 8], bv[DQ_KT / 8];
#pragma unroll
        for (int j = 0; j < DQ_KT / 8; ++j) {
          const float* kr = kt_s + (8 * j + g) * DS + 8 * kk + t;
          const float* vr = vt_s + (8 * j + g) * DS + 8 * kk + t;
          bk[j].set(kr[0], kr[4]);
          bv[j].set(vr[0], vr[4]);
        }
        mma3_pair<DQ_KT / 8>(s, aq, bk, dp, ao, bv);
      }
      // ds of rows q0 + rl0 (e = 0, 1) and + 8 (e = 2, 3), keys k0 + 8j + 2t (+1)
#pragma unroll
      for (int j = 0; j < DQ_KT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = k0 + 8 * j + 2 * t + (e & 1);
          const int r = q0 + rl0 + 8 * (e >> 1);
          float sv = s[j][e];
          if (j >= nj || c >= a.t_kv) {
            sv = -INFINITY;   // past t_kv, or hidden from every row of the warp
          } else if (a.causal && r < c) {
            sv = NEG_INF;
          }
          const float p = expf(sv - lr[e >> 1]);
          dp[j][e] = p * (dp[j][e] - dl[e >> 1]);
        }
      }
      // dq += ds k over this slice's columns: ds straight from the C fragments,
      // k's rows read as 2t, 2t + 1
#pragma unroll
      for (int j = 0; j < DQ_KT / 8; ++j) {
        if (j < nj) {
          FragA ads;
          ads.set(dp[j][0], dp[j][2], dp[j][1], dp[j][3]);
          const float* kr = kt_s + (8 * j + 2 * t) * DS + col0 + g;
#pragma unroll
          for (int nb = 0; nb < 8; nb += 4) {   // unguarded: columns past h are zeros
            FragB bk[4];
#pragma unroll
            for (int n = 0; n < 4; ++n) bk[n].set(kr[8 * (nb + n)], kr[DS + 8 * (nb + n)]);
            mma3<4>(acc + nb, ads, bk);
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

  if (n_kg == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = rl0 + 8 * h;
      if (rl >= nq) continue;
      float* out = a.dq + (row0 + rl) * a.d;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = col0 + 8 * n + 2 * t;
        if (col < a.d) out[col] = acc[n][2 * h] * a.scale;
        if (col + 1 < a.d) out[col + 1] = acc[n][2 * h + 1] * a.scale;
      }
    }
    return;
  }
  // key groups' partial sums, [n_kg][q_rows][DQ_SLICE + 4] in the ring's space,
  // added in group order
  constexpr int PS = DQ_SLICE + 4;
  cp_async_wait_all();
  __syncthreads();   // every warp is done with the ring
  float* part = ring;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* row = part + (kg * a.q_rows + rl0 + 8 * h) * PS + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      row[8 * n] = acc[n][2 * h];
      row[8 * n + 1] = acc[n][2 * h + 1];
    }
  }
  __syncthreads();
  float* ob = a.dq + row0 * a.d + col0;
  for_each_2d(nq, min(DQ_SLICE, a.d - col0), [&](int r, int c) {
    float sum = part[r * PS + c];
    for (int x = 1; x < n_kg; ++x) sum += part[(x * a.q_rows + r) * PS + c];
    ob[r * a.d + c] = sum * a.scale;
  });
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

// The device's shared-memory opt-in limit less a kernel's static shared memory,
// set once per kernel as its dynamic limit (asking for the whole opt-in limit
// fails every launch); -1 when it cannot be set.
template <typename Kernel>
int smem_limit_of(Kernel kernel) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, kernel) != cudaSuccess)
    return -1;
  const int lim = optin - static_cast<int>(attr.sharedSizeBytes);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lim) != cudaSuccess)
    return -1;
  return lim;
}

template <bool SPLIT>
int dq_smem_limit() {
  static const int limit = smem_limit_of(flash_bwd_dq_kernel<SPLIT>);
  return limit;
}

// Shared memory, stages and blocks an SM of kernel 5 as SPLIT or not; blocks
// an SM 0 when it does not fit.
struct DqLaunch {
  size_t smem;
  int stages, per_sm;
};

template <bool SPLIT>
cudaError_t dq_config(const DqArgs& a, DqLaunch& c) {
  const int limit = dq_smem_limit<SPLIT>();
  if (limit < 0) return cudaErrorInvalidValue;
  const size_t ds = DQ_SLICE * a.n_js + 4;
  const size_t chunk = DQ_KT * (4 / (a.q_rows / 16));
  const size_t stage = sizeof(float) * 2 * chunk * ds;
  c.smem = sizeof(float) * (SPLIT ? 4 : 2) * a.q_rows * ds + 2 * stage;
  c.stages = 2;
  c.per_sm = 0;
  if (c.smem > static_cast<size_t>(limit)) {
    c.stages = 1;
    c.smem -= stage;
    if (c.smem > static_cast<size_t>(limit)) return cudaSuccess;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.per_sm, flash_bwd_dq_kernel<SPLIT>, DQ_THREADS,
                                                       c.smem);
}

// q and do are split once a block in shared memory where that costs no block an
// SM (by shared memory and registers), else where a fragment is formed: at the
// SASRec training shape the split copy would leave two blocks an SM instead of
// three, and ran slower.
cudaError_t launch_dq(DqArgs a, long long blocks, cudaStream_t stream) {
  a.n_qt = (a.t_q + a.q_rows - 1) / a.q_rows;
  a.n_js = (a.d + DQ_SLICE - 1) / DQ_SLICE;
  const void* bases[4] = {a.q, a.k, a.v, a.dout};
  a.vec = pio_mma::copy_vec(a.d, bases, 4);
  if (blocks != static_cast<long long>(a.n_bh) * a.n_qt * a.n_js || blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  DqLaunch split, plain;
  cudaError_t e = dq_config<true>(a, split);
  if (e == cudaSuccess) e = dq_config<false>(a, plain);
  if (e != cudaSuccess) return e;
  if (split.per_sm > 0 && split.per_sm >= plain.per_sm) {
    a.stages = split.stages;
    flash_bwd_dq_kernel<true><<<static_cast<unsigned>(blocks), DQ_THREADS, split.smem, stream>>>(a);
  } else if (plain.per_sm > 0) {
    a.stages = plain.stages;
    flash_bwd_dq_kernel<false><<<static_cast<unsigned>(blocks), DQ_THREADS, plain.smem, stream>>>(a);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Kernel 6's dynamic shared-memory limit, set once.
int dkv_smem_limit() {
  static const int limit = smem_limit_of(flash_bwd_dkv_kernel);
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
// dq (n_bh, t_q, d): float32, contiguous. q_rows (16, 32 or 64; 64 for a head
// wider than 128) and blocks are ops/flash_attention.dq_plan's: blocks must equal
// n_bh * ceil(t_q / q_rows) * ceil(d / 64). Launches on `stream` and does not
// synchronise; returns a cudaError_t.
int pio_flash_bwd_dq(const float* q, const float* k, const float* v, const float* dout,
                     const float* lse, const float* delta, float* dq, int n_bh, int t_q,
                     int t_kv, int d, int causal, float scale, int q_rows, long long blocks,
                     void* stream) {
  if (bad_shape(n_bh, t_q, t_kv, d)) return cudaErrorInvalidValue;
  if (q_rows != 16 && q_rows != 32 && q_rows != TILE) return cudaErrorInvalidValue;
  DqArgs a{q, k, v, dout, lse, delta, dq, n_bh, t_q, t_kv, d, causal != 0, scale, q_rows};
  return launch_dq(a, blocks, static_cast<cudaStream_t>(stream));
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
