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
// Plain f32 FMAs, expf/logf and IEEE division: no TF32, no fast math.
//
// What bounds it: each input is read once and each output written once,
// 4*BH*(4*T*h + T) bytes, against 4*BH*h*T(T+1)/2 f32 operations for a causal
// block (two products of T(T+1)/2 visible pairs, h multiply-adds each). At the
// SASRec serving shape (BH = 1, T = 256, h = 50) that is 0.2 MB against 6.6 MFLOP:
// operations bound it, at 0.1 us on 67 TFLOP/s. What really limits this first
// version is parallelism: four query tiles give the card four blocks.
//
// Design. The TPU kernel walks a (q block, k block) grid of 128 x 128 tiles in
// order, carrying (m, l, acc) in VMEM scratch across the K axis. On Hopper:
//   - one block of 256 threads per (batch·head, 64-row query tile); the key axis
//     becomes a loop inside the block, so (m, l, acc) live in registers;
//   - the q tile (scaled) and each 64-row k tile are staged transposed in shared
//     memory, [d][68]: thread (ty, tx) of a 16 x 16 grid owns rows 4ty..4ty+3 and
//     columns 4tx..4tx+3 of the 64 x 64 score tile and reads both operands as
//     float4s (16 FMAs for two shared loads); staging reads the tile's contiguous
//     rows*d floats one scalar at a time, so a head width that is not a multiple
//     of 4 (SASRec's 50) needs no special case;
//   - a row's max and sum over the tile are shuffles across the 16 threads that
//     share it; p goes to shared memory transposed, and each thread accumulates
//     its 4 rows x (4 * NJ) columns of p v, with v staged row-major [64][64*NJ];
//   - causal key tiles wholly above the diagonal are skipped, and so are the
//     columns of the diagonal tile that no row of the block sees. In the TPU
//     kernel those scores are -1e30 and exp(-1e30 - m) is exactly 0, so o and
//     lse come out the same;
//   - blocks run the heaviest query tiles (the last ones, under a causal mask)
//     first.
// Head widths 1..256 through NJ = ceil(h / 64) in {1, 2, 3, 4}. Tensor cores
// (wgmma on bf16 or tf32 operands) and several query tiles of one row per SM are
// later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;        // rows of a query and of a key/value tile (Python: TILE)
constexpr int THREADS = 256;    // a 16 x 16 thread grid
constexpr int MAX_HEAD = 256;   // (Python: MAX_HEAD)
constexpr int TS = TILE + 4;    // row stride of the transposed tiles: float4-aligned
constexpr float NEG_INF = -1e30f;

template <int NJ>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int n_bh, int n_qt, int t_q, int t_kv,
    int d, int causal, float scale) {
  constexpr int VS = 64 * NJ;   // row stride of the staged v tile
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;             // [d][TS]  q * scale, transposed
  float* kT = qT + d * TS;      // [d][TS]  k, transposed
  float* vs = kT + d * TS;      // [TILE][VS]
  float* pT = vs + TILE * VS;   // [TILE][TS]  p, transposed

  const int bh = blockIdx.x % n_bh;
  const int qt = n_qt - 1 - blockIdx.x / n_bh;   // heaviest tiles first
  const int q0 = qt * TILE;
  const int nq = min(TILE, t_q - q0);
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const float* qb = q + (static_cast<long long>(bh) * t_q + q0) * d;
  const float* kb = k + static_cast<long long>(bh) * t_kv * d;
  const float* vb = v + static_cast<long long>(bh) * t_kv * d;

  for (int u = tid; u < TILE * d; u += THREADS) {
    const int r = u / d, c = u - r * d;
    qT[c * TS + r] = r < nq ? __fmul_rn(qb[u], scale) : 0.f;
  }
  for (int u = tid; u < TILE * VS; u += THREADS) vs[u] = 0.f;   // columns >= d stay 0

  int n_kt = (t_kv + TILE - 1) / TILE;
  if (causal) n_kt = min(n_kt, (q0 + nq - 1) / TILE + 1);

  float m[4], l[4], acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * NJ; ++e) acc[i][e] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TILE;
    const int nk = min(TILE, t_kv - k0);
    __syncthreads();   // the previous tile's readers are done with kT, vs and pT
    const float* kt_b = kb + static_cast<long long>(k0) * d;
    const float* vt_b = vb + static_cast<long long>(k0) * d;
    for (int u = tid; u < TILE * d; u += THREADS) {
      const int r = u / d, c = u - r * d;
      const bool in = r < nk;
      kT[c * TS + r] = in ? kt_b[u] : 0.f;
      if (in) vs[r * VS + c] = vt_b[u];
    }
    __syncthreads();

    // scores of rows 4ty+i, columns 4tx+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(qT + c * TS + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(kT + c * TS + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // mask: keys past t_kv take no part; causal hides keys after the row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + 4 * tx + j;
        if (c >= t_kv) {
          s[i][j] = -INFINITY;
        } else if (causal && r < c) {
          s[i][j] = NEG_INF;
        }
      }
    }

    // online softmax: the 16 threads of a row share its max and sum
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mb = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
      const float mn = fmaxf(m[i], mb);
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = mn;
#pragma unroll
      for (int e = 0; e < 4 * NJ; ++e) acc[i][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pT + (4 * tx + j) * TS + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += p v over the columns some row of this block sees
    const int nc = causal ? min(nk, q0 + nq - k0) : nk;
    for (int c = 0; c < nc; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(pT + c * TS + 4 * ty);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 b = *reinterpret_cast<const float4*>(vs + c * VS + 64 * jj + 4 * tx);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][4 * jj + e] = fmaf(av[i], bv[e], acc[i][4 * jj + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r < t_q) {
      const float lf = fmaxf(l[i], 1e-30f);
      float* orow = o + (static_cast<long long>(bh) * t_q + r) * d;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 64 * jj + 4 * tx + e;
          if (col < d) orow[col] = acc[i][4 * jj + e] / lf;
        }
      if (tx == 0) lse[static_cast<long long>(bh) * t_q + r] = m[i] + logf(lf);
    }
  }
}

// Dynamic shared memory above 48 KB needs an opt-in, made once per kernel: the
// device's opt-in limit less the kernel's static shared memory.
template <int NJ>
cudaError_t opt_in_smem() {
  static const cudaError_t err = [] {
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, flash_fwd_kernel<NJ>);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_fwd_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - static_cast<int>(attr.sharedSizeBytes));
    return e;
  }();
  return err;
}

template <int NJ>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, float* lse,
                   int n_bh, int t_q, int t_kv, int d, int causal, float scale,
                   cudaStream_t stream) {
  const int n_qt = (t_q + TILE - 1) / TILE;
  const long long blocks = static_cast<long long>(n_bh) * n_qt;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(d) * TS + TILE * 64 * NJ + TILE * TS);
  if (smem > 48 * 1024) {
    const cudaError_t e = opt_in_smem<NJ>();
    if (e != cudaSuccess) return e;
  }
  flash_fwd_kernel<NJ><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      q, k, v, o, lse, n_bh, n_qt, t_q, t_kv, d, causal, scale);
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
// float32, contiguous. Launches on `stream` and does not synchronise; returns a
// cudaError_t.
int pio_flash_fwd(const float* q, const float* k, const float* v, float* o, float* lse,
                  int n_bh, int t_q, int t_kv, int d, int causal, float scale, void* stream) {
  if (n_bh < 1 || t_q < 1 || t_kv < 1 || d < 1 || d > MAX_HEAD) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 63) / 64) {
    case 1:
      return launch<1>(q, k, v, o, lse, n_bh, t_q, t_kv, d, causal, scale, s);
    case 2:
      return launch<2>(q, k, v, o, lse, n_bh, t_q, t_kv, d, causal, scale, s);
    case 3:
      return launch<3>(q, k, v, o, lse, n_bh, t_q, t_kv, d, causal, scale, s);
    default:
      return launch<4>(q, k, v, o, lse, n_bh, t_q, t_kv, d, causal, scale, s);
  }
}

}  // extern "C"
