// Exact softmax attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel predictionio_tpu/ops/flash_attention.py:_flash_kernel,
// reached through _flash_2d_res from flash_attention (every SASRec layer at a
// flash-eligible length) and flash_block_fwd (one block pair of ring attention).
//
// What it computes, per batch·head b and query row r (all float32):
//   s[c]  = sum_d (q[r,d] * scale) * k[c,d]         q·scale rounded once, as the TPU kernel
//   s[c]  = NEG_INF (-1e30) where causal and r < c   positions absolute, also for T_q != T_kv
//   m     = max_c s[c],  l = sum_c exp(s[c] - m),  acc = sum_c exp(s[c] - m) * v[c,:]
//   o[r]  = acc / max(l, 1e-30),  lse[r] = m + log(max(l, 1e-30))
// with the online (m, l, acc) update of the TPU kernel over key tiles:
//   m' = max(m, max_c s), alpha = exp(m - m'), l' = l*alpha + sum p, acc' = acc*alpha + p v.
// Both products run on the tensor cores in the 3xTF32 form (csrc/mma_tf32.cuh), at
// float32 accuracy; expf/logf and IEEE division, no fast math.
//
// What bounds it: each input is read once and each output written once,
// 4*BH*(2*T_q*h + 2*T_kv*h + T_q) bytes, against 4*h f32 operations a visible
// (query, key) pair (two products of h multiply-adds), which the tensor cores run
// as three TF32 products each. At the SASRec serving shape (BH = 1, T = 256,
// h = 50, causal) that is 0.2 MB and 6.6 MFLOP: under a microsecond either way.
// What limits a call there is parallelism and latency: four 64-row query tiles
// would give the card four blocks.
//
// Design. The TPU kernel walks a (q block, k block) grid of 128 x 128 tiles in
// order, carrying (m, l, acc) in VMEM scratch across the K axis. On Hopper:
//   - a block is four warps and takes one split of a query tile's visible keys;
//     one warp computes per 16 query rows of the tile (q_rows = 16 or 64) and
//     all four stage and merge. ops/flash_attention.split_plan picks q_rows
//     and the split: one split of 64-row tiles when those alone fill the card,
//     else 16-row tiles cut into splits of ks keys. The grid runs the heaviest
//     query tiles first;
//   - q (split once into TF32 hi and lo by the warp that owns its rows) and
//     32-key tiles of k and v are staged by cp.async, k and v in a two-stage
//     ring (one stage if two do not fit), row-major with a row stride of
//     64*NJ + 4 and zero columns past h, so the next tile's copy is in flight
//     while this one computes; one __syncthreads a key tile;
//   - a warp holds its 16 rows' (m, l, acc) in mma C fragments: s = (q·scale) kᵀ
//     for 16 rows x 32 keys, the online update with quad shuffles, then p v with
//     p taken straight from the score fragments (mma_tf32.cuh says how);
//   - keys a causal mask hides from every row of a warp are skipped in steps of
//     8: in the TPU kernel those scores are -1e30 and exp(-1e30 - m) is exactly
//     0, so o and lse come out the same;
//   - a query tile cut into splits writes each split's (m, l, acc) to a scratch
//     buffer; the block that takes the tile's last ticket (an atomicAdd that
//     counts arrivals and sums nothing, as csrc/score_topk.cu's merge) merges
//     them in split order: M = max m_s, w_s = exp(m_s - M), l = sum l_s w_s,
//     o = sum acc_s w_s / max(l, 1e-30). A split whose rows all see no key would
//     carry m = -1e30 and weight exactly 0. The result does not depend on which
//     block arrives last, and the merging block sets its ticket back to 0.
// The merge needs every split's record in the ring's shared memory at once, so
// split_plan cuts a tile into at most 8 splits.
// Head widths 1..256 through NJ = ceil(h / 64) in {1, 2, 3, 4}: a warp keeps
// 16 x 64*NJ accumulators (32*NJ registers a thread).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

using namespace pio_mma;


constexpr int TILE = 64;        // rows of the widest query tile (Python: TILE)
constexpr int KT = 32;          // keys of a staged k/v tile (64 ran slower at the path shapes)
constexpr int MIN_Q_ROWS = 16;  // one warp's rows
constexpr int MAX_HEAD = 256;
constexpr int MAX_THREADS = 2 * TILE;
constexpr float NEG_INF = -1e30f;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;
  float* part;    // [n_bh][n_qt][max_split][q_rows][d + 2] partial acc, m, l
  int* tickets;   // [n_bh][n_qt], zero between calls
  int n_bh, t_q, t_kv, d, causal;
  float scale;
  int q_rows, ks, n_qt, max_split, stages, vec;
};

__host__ __device__ inline int splits_of(const Args& a, int qt) {
  const int q0 = qt * a.q_rows;
  const int nq = a.t_q - q0 < a.q_rows ? a.t_q - q0 : a.q_rows;
  const int visible = a.causal && q0 + nq < a.t_kv ? q0 + nq : a.t_kv;
  return (visible + a.ks - 1) / a.ks;
}

template <int NJ>
__global__ void __launch_bounds__(MAX_THREADS) flash_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int last;
  // rows of 64*NJ floats and 4 more: every 8-column step of the unrolled p v
  // loop reads zeros past h, and the fragment patterns hit 32 distinct banks
  constexpr int DW = 64 * NJ;
  const int DS = DW + 4, nd = pad8(a.d) / 8;   // nd: 8-column steps of q kᵀ
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // block → (query tile, split, batch·head), the last (heaviest) tiles first
  int b = blockIdx.x, qt = a.n_qt - 1, n_split = splits_of(a, qt);
  while (b >= n_split * a.n_bh) {
    b -= n_split * a.n_bh;
    n_split = splits_of(a, --qt);
  }
  const int bh = b % a.n_bh, split = b / a.n_bh;
  const int q0 = qt * a.q_rows;
  const int nq = min(a.q_rows, a.t_q - q0);
  const int visible = a.causal ? min(a.t_kv, q0 + nq) : a.t_kv;
  const int kb = split * a.ks, ke = min(visible, kb + a.ks);
  const int n_kt = (ke - kb + KT - 1) / KT;

  float* qs = smem;                         // [q_rows][DS]  q, then q·scale's TF32 hi part
  float* ql = qs + a.q_rows * DS;           // [q_rows][DS]  q·scale's lo part
  float* ring = ql + a.q_rows * DS;         // stages x {k [KT][DS], v [KT][DS]}
  const int stage_floats = 2 * KT * DS;
  const float* qb = a.q + (static_cast<long long>(bh) * a.t_q + q0) * a.d;
  const float* kbase = a.k + static_cast<long long>(bh) * a.t_kv * a.d;
  const float* vbase = a.v + static_cast<long long>(bh) * a.t_kv * a.d;

  zero_pad_columns(qs, DS, a.q_rows, a.d, DW);
  for (int s = 0; s < a.stages; ++s) zero_pad_columns(ring + s * stage_floats, DS, 2 * KT, a.d, DW);
  auto issue = [&](int it, int stage) {
    // rows up to a multiple of 8 (zeros past nk): p v reads no further; q kᵀ
    // reads the rest of the tile and masks those scores
    const int k0 = kb + it * KT, nk = min(KT, ke - k0), rows = (nk + 7) & ~7;
    float* ks_ = ring + stage * stage_floats;
    stage_rows(ks_, DS, kbase + static_cast<long long>(k0) * a.d, rows, nk, a.d, a.vec);
    stage_rows(ks_ + KT * DS, DS, vbase + static_cast<long long>(k0) * a.d, rows, nk, a.d, a.vec);
  };
  stage_rows(qs, DS, qb, a.q_rows, nq, a.d, a.vec);
  issue(0, 0);
  cp_async_commit();

  // every block has four warps for staging and the merge; the first q_rows / 16
  // compute, a warp per 16 rows
  const bool computes = 16 * warp < a.q_rows;
  const int r_lo = q0 + 16 * warp + g;   // this thread's rows: r_lo and r_lo + 8
  const int warp_last = q0 + 16 * warp + 15;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[8 * NJ][4];
#pragma unroll
  for (int n = 0; n < 8 * NJ; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    cp_async_wait_all();
    __syncthreads();   // tile `it` is in; every warp is done with the stage refilled below
    if (it == 0 && computes) {
      // a warp splits its own 16 rows of q·scale (rounded once) into TF32 hi
      // and lo once, for every key tile: a lane walks a flat run of the rows
      const int cols = 8 * nd;
      int r = lane / cols, c = lane - r * cols;
      const int dr = 32 / cols, dc = 32 - dr * cols;
      while (r < 16) {
        float* x = qs + (16 * warp + r) * DS + c;
        uint32_t hi, lo;
        pio_mma::split(__fmul_rn(*x, a.scale), hi, lo);
        *x = __uint_as_float(hi);
        ql[(16 * warp + r) * DS + c] = __uint_as_float(lo);
        r += dr;
        c += dc;
        if (c >= cols) {
          c -= cols;
          ++r;
        }
      }
      __syncwarp();
    }
    if (a.stages == 2 && it + 1 < n_kt) {
      issue(it + 1, (it + 1) & 1);
      cp_async_commit();
    }
    const float* kt_s = ring + (a.stages == 2 ? (it & 1) : 0) * stage_floats;
    const float* vt_s = kt_s + KT * DS;
    const int k0 = kb + it * KT, nk = min(KT, ke - k0);
    // 8-key steps holding a key some row of this warp sees
    int nj = (nk + 7) / 8;
    if (a.causal) nj = warp_last < k0 ? 0 : min(nj, (warp_last - k0) / 8 + 1);
    if (!computes) nj = 0;

    if (nj > 0) {
      // all 8 key steps, unguarded, so their 8 chains of 3 dependent products
      // interleave; the steps past nj are masked below
      float s[KT / 8][4];
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const float* qh = qs + (16 * warp + g) * DS + t;
      const float* qo = ql + (16 * warp + g) * DS + t;
      for (int kk = 0; kk < nd; ++kk) {
        FragA aq;   // q·scale, split once above
        const int off[4] = {8 * kk, 8 * DS + 8 * kk, 8 * kk + 4, 8 * DS + 8 * kk + 4};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          aq.hi[i] = __float_as_uint(qh[off[i]]);
          aq.lo[i] = __float_as_uint(qo[off[i]]);
        }
        FragB bk[KT / 8];
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
          const float* kr = kt_s + (8 * j + g) * DS + 8 * kk + t;
          bk[j].set(kr[0], kr[4]);
        }
        mma3<KT / 8>(s, aq, bk);
      }
      // mask, then the online update of rows r_lo (e = 0, 1) and r_lo + 8 (e = 2, 3)
      float mb[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = k0 + 8 * j + 2 * t + (e & 1);
          const int r = r_lo + 8 * (e >> 1);
          float sv = s[j][e];
          if (j >= nj || c >= ke) {
            sv = -INFINITY;   // another split's key, past t_kv, or hidden from the whole warp
          } else if (a.causal && r < c) {
            sv = NEG_INF;
          }
          s[j][e] = sv;
          mb[e >> 1] = fmaxf(mb[e >> 1], sv);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mb[h] = fmaxf(mb[h], __shfl_xor_sync(0xffffffffu, mb[h], 1));
        mb[h] = fmaxf(mb[h], __shfl_xor_sync(0xffffffffu, mb[h], 2));
      }
      const float alpha[2] = {expf(m[0] - mb[0]), expf(m[1] - mb[1])};
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - mb[e >> 1]);
          rs[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
        l[h] = l[h] * alpha[h] + rs[h];
        m[h] = mb[h];
      }
      // acc = acc·alpha + p v: the score fragment is the A operand, v's rows
      // read as 2t, 2t+1; the tile's p v is summed in pv, then folded in
#pragma unroll
      for (int nb = 0; nb < NJ; ++nb) {   // unguarded: columns past h are zeros
        float pv[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
          if (j < nj) {
            FragA ap;
            ap.set(s[j][0], s[j][2], s[j][1], s[j][3]);
            const float* vr = vt_s + (8 * j + 2 * t) * DS + g + 64 * nb;
            FragB bv[8];
#pragma unroll
            for (int n = 0; n < 8; ++n) bv[n].set(vr[8 * n], vr[DS + 8 * n]);
            mma3<8>(pv, ap, bv);
          }
        }
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          float* c = acc[8 * nb + n];
          c[0] = fmaf(c[0], alpha[0], pv[n][0]);
          c[1] = fmaf(c[1], alpha[0], pv[n][1]);
          c[2] = fmaf(c[2], alpha[1], pv[n][2]);
          c[3] = fmaf(c[3], alpha[1], pv[n][3]);
        }
      }
    }
    if (a.stages == 1 && it + 1 < n_kt) {
      __syncthreads();   // every warp is done with the only stage
      issue(it + 1, 0);
      cp_async_commit();
    }
  }

  if (n_split == 1) {
    if (!computes) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_lo + 8 * h;
      if (r >= a.t_q) continue;
      const float lf = fmaxf(l[h], 1e-30f);
      float* orow = a.o + (static_cast<long long>(bh) * a.t_q + r) * a.d;
#pragma unroll
      for (int n = 0; n < 8 * NJ; ++n) {
        const int col = 8 * n + 2 * t;
        if (col < a.d) orow[col] = acc[n][2 * h] / lf;
        if (col + 1 < a.d) orow[col + 1] = acc[n][2 * h + 1] / lf;
      }
      if (t == 0) a.lse[static_cast<long long>(bh) * a.t_q + r] = m[h] + logf(lf);
    }
    return;
  }

  // this split's partial (m, l, acc) of its rows, then the tile's last block merges
  const int tile_id = bh * a.n_qt + qt;
  const int pw = a.q_rows * (a.d + 2);
  float* part = a.part + static_cast<long long>(tile_id) * a.max_split * pw;
  {
    float* mine = part + split * pw;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = 16 * warp + g + 8 * h;
      if (!computes || rl >= nq) continue;
#pragma unroll
      for (int n = 0; n < 8 * NJ; ++n) {
        const int col = 8 * n + 2 * t;
        if (col < a.d) mine[rl * a.d + col] = acc[n][2 * h];
        if (col + 1 < a.d) mine[rl * a.d + col + 1] = acc[n][2 * h + 1];
      }
      if (t == 0) {
        mine[a.q_rows * a.d + rl] = m[h];
        mine[a.q_rows * a.d + a.q_rows + rl] = l[h];
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.tickets + tile_id, 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // every split's record, all copies in flight at once, into the ring's space
  // (split_plan keeps n_split * q_rows * (d + 2) within it); a record is a
  // multiple of 16 floats, so 16-byte copies
  float* rec = ring;
  const int pieces = n_split * pw / 4;
  for (int u = threadIdx.x; u < pieces; u += blockDim.x) cp_async<16>(rec + 4 * u, part + 4 * u, true);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  float* w = rec + n_split * pw;   // [q_rows][n_split] weights
  float* lfs = w + a.q_rows * n_split;
  for (int rl = threadIdx.x; rl < nq; rl += blockDim.x) {
    float M = NEG_INF;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, rec[s * pw + a.q_rows * a.d + rl]);
    float lsum = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float ws = expf(rec[s * pw + a.q_rows * a.d + rl] - M);
      w[rl * n_split + s] = ws;
      lsum += rec[s * pw + a.q_rows * a.d + a.q_rows + rl] * ws;
    }
    const float lf = fmaxf(lsum, 1e-30f);
    lfs[rl] = lf;
    a.lse[static_cast<long long>(bh) * a.t_q + q0 + rl] = M + logf(lf);
  }
  __syncthreads();
  float* ob = a.o + (static_cast<long long>(bh) * a.t_q + q0) * a.d;
  for_each_2d(nq, a.d, [&](int rl, int c) {
    float sum = 0.f;
    for (int s = 0; s < n_split; ++s) sum = fmaf(rec[s * pw + rl * a.d + c], w[rl * n_split + s], sum);
    ob[rl * a.d + c] = sum / lfs[rl];
  });
  if (threadIdx.x == 0) a.tickets[tile_id] = 0;
}

// The device's shared-memory opt-in limit less a kernel's static shared memory,
// set once per kernel as its dynamic limit (asking for the whole opt-in limit
// fails every launch).
template <int NJ>
int smem_limit() {
  static const int limit = [] {
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
        cudaFuncGetAttributes(&attr, flash_fwd_kernel<NJ>) != cudaSuccess)
      return -1;
    const int lim = optin - static_cast<int>(attr.sharedSizeBytes);
    if (cudaFuncSetAttribute(flash_fwd_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, lim) !=
        cudaSuccess)
      return -1;
    return lim;
  }();
  return limit;
}

template <int NJ>
cudaError_t launch(Args a, long long blocks, cudaStream_t stream) {
  const int limit = smem_limit<NJ>();
  if (limit < 0) return cudaErrorInvalidValue;
  const size_t ds = 64 * NJ + 4;
  size_t smem = sizeof(float) * (2 * a.q_rows * ds + 2 * (2 * KT * ds));
  a.stages = 2;
  if (smem > static_cast<size_t>(limit)) {
    a.stages = 1;
    smem -= sizeof(float) * 2 * KT * ds;
    if (smem > static_cast<size_t>(limit)) return cudaErrorInvalidValue;
  }
  // the merge's records and weights must fit in the ring's space
  const size_t merge = static_cast<size_t>(a.max_split) * a.q_rows * (a.d + 3) + a.q_rows;
  if (a.max_split > 1 && merge > static_cast<size_t>(a.stages) * 2 * KT * ds)
    return cudaErrorInvalidValue;
  flash_fwd_kernel<NJ><<<static_cast<unsigned>(blocks), MAX_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pio_flash_fwd_limits(int* tile, int* max_head) {
  *tile = TILE;
  *max_head = MAX_HEAD;
  return 0;
}

const char* pio_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (n_bh, t_q, d), k and v (n_bh, t_kv, d), o (n_bh, t_q, d), lse (n_bh, t_q):
// float32, contiguous. q_rows (16, 32 or 64) and ks (keys a split, a multiple of
// q_rows, or >= t_kv for one split) are ops/flash_attention.split_plan's, and
// `blocks` its grid, which must equal the grid they give here. When a query tile
// has more than one split, part holds n_bh * n_qt * ceil(t_kv / ks) * q_rows *
// (d + 2) floats and tickets n_bh * n_qt int32 zeros (left at zero); else both
// may be null. Launches on `stream` and does not synchronise; returns a
// cudaError_t.
int pio_flash_fwd(const float* q, const float* k, const float* v, float* o, float* lse, float* part,
                  int* tickets, int n_bh, int t_q, int t_kv, int d, int causal, float scale,
                  int q_rows, int ks, long long blocks, void* stream) {
  if (n_bh < 1 || t_q < 1 || t_kv < 1 || d < 1 || d > MAX_HEAD) return cudaErrorInvalidValue;
  if (q_rows < MIN_Q_ROWS || q_rows > TILE || q_rows % MIN_Q_ROWS || ks < 1 ||
      (ks < t_kv && (ks % q_rows || ks % MIN_Q_ROWS)))
    return cudaErrorInvalidValue;
  Args a{q, k, v, o, lse, part, tickets, n_bh, t_q, t_kv, d, causal != 0, scale, q_rows, ks};
  a.n_qt = (t_q + q_rows - 1) / q_rows;
  a.max_split = (t_kv + ks - 1) / ks;
  const void* bases[3] = {q, k, v};
  a.vec = copy_vec(d, bases, 3);
  long long want = 0;
  int most = 0;
  for (int qt = 0; qt < a.n_qt; ++qt) {
    const int n = splits_of(a, qt);
    want += static_cast<long long>(n) * n_bh;
    most = n > most ? n : most;
  }
  if (want != blocks || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (most > 1 && (part == nullptr || tickets == nullptr)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 63) / 64) {
    case 1:
      return launch<1>(a, blocks, s);
    case 2:
      return launch<2>(a, blocks, s);
    case 3:
      return launch<3>(a, blocks, s);
    default:
      return launch<4>(a, blocks, s);
  }
}

}  // extern "C"
