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
// Design: one pass of scoring and threshold selection, and a merge by the last
// block of each row group, in one launch.
//   * Keys. A (score, index) pair is one 64-bit key: the score's bits made
//     order-preserving (-0 taken as +0, since the two compare equal) above the
//     complemented index. Larger key = earlier in the answer, so the two-key
//     order of lax.top_k is one unsigned compare, and key 0 (below every real
//     key) marks an empty slot.
//   * Blocks. The catalog is cut into slices (ops/score_kernel.py:slice_plan,
//     so that the grid has about two blocks per SM at every batch size). For k
//     up to WARP_MAX_K a block takes up to 8 rows, one warp each, and one slice;
//     for wider k a block takes one row and one slice, and its 8 warps share one
//     buffer in shared memory.
//   * Staging. The block copies its slice of V, with the mask and the item
//     scales, into shared memory a tile at a time with cp.async,
//     double-buffered, so the rows of a block read V from shared memory and V
//     crosses L2 once per row group. A lane scores 8 items of a tile at a time
//     (8 independent FMA chains over the rank).
//   * Selection (a warp). The warp keeps its best H = max(64, next_pow2(k))
//     keys so far in registers, sorted (the queue; key e in lane e % 32), and
//     their k-th key t. It offers 32 consecutive items at a time, one a lane;
//     only keys above t are appended to its buffer of H in shared memory, in
//     index order (a ballot and a prefix count). When a round could overflow
//     the buffer, the buffer is sorted in registers (bitonic, with shuffles)
//     and merged into the queue (the elementwise best of the queue and the
//     reversed buffer, then a bitonic merge), which raises t. t starts at 0, so
//     until k keys are in the queue every item is kept: masked items (-1e30)
//     can still enter the answer, as lax.top_k lets them when fewer than k
//     items are unmasked. Items past n_items are never offered.
//   * Selection (a block, k > WARP_MAX_K). The same with a buffer of
//     2 next_pow2(k) keys in shared memory, sorted there by the whole block
//     and cut back to its best k.
//   * Merge. Each (row, slice) writes its sorted best k (0-padded) to the
//     scratch; the block that takes a row group's last ticket (atomicAdd after
//     __threadfence) merges that group's rows. It first copies the head of
//     every list into shared memory; then each lane walks its share of the
//     lists, offering entry after entry to the same selection: since a list is
//     sorted, the first entry not kept ends that list. The answer is the k
//     best keys of all, which the ticket order cannot change: a ticket counts
//     arrivals, it sums no values. The merging block sets its ticket back to 0
//     for the next call on the stream.
// Making it faster (a cheaper first threshold, wgmma for wide ranks) is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;           // warps a block
constexpr int THREADS = WARPS * 32;
constexpr int MAX_K = 8192;        // (Python: MAX_K)
constexpr int WARP_MAX_K = 512;    // a warp's own queue up to here (Python: WARP_MAX_K)
constexpr int MAX_RANK = 256;      // (Python: MAX_RANK)
constexpr int TILE_BYTES = 40960;  // one staged tile of V, at most
constexpr int MAX_TILE_ITEMS = 1024;
constexpr int ITEMS = 8;           // items a thread scores at a time
constexpr int MAX_SLICES = 1024;   // a lane's lists fit one 32-bit mask (Python: MAX_SLICES)
constexpr float NEG = -1e30f;      // excluded / padded score
constexpr unsigned FULL = 0xffffffffu;

typedef unsigned long long Key;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ Key make_key(float v, int i) {
  unsigned b = __float_as_uint(__fadd_rn(v, 0.f));  // -0 + 0 is +0
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<Key>(b) << 32) | static_cast<unsigned>(~i);
}
__device__ __forceinline__ float key_value(Key key) {
  const unsigned o = static_cast<unsigned>(key >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}
__device__ __forceinline__ int key_index(Key key) {
  return static_cast<int>(~static_cast<unsigned>(key));
}

__host__ __device__ __forceinline__ int pow2ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Keys of one selection's buffer (Python: buffer_cap): a warp's queue and buffer
// hold H = max(64, next_pow2(k)) each; a block's buffer 2 next_pow2(k), so that a
// cut back to the best k leaves room for a round of 256 appends.
__host__ __device__ __forceinline__ int buffer_cap(int k) {
  const int q = pow2ceil(k);
  return k <= WARP_MAX_K ? (q < 64 ? 64 : q) : 2 * q;
}

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// ---- a warp's selection: its queue in registers ------------------------------

// One step of a bitonic network over 32 R keys, key e = 32 r + lane: pairs e and
// e ^ stride, the pair ordered best first where (e & size) == 0 (best last
// elsewhere), reversed when !best_first. Only the loop over a lane's R keys is
// unrolled, so v[] stays in registers and the network stays small.
template <int R, int RS>  // stride = 32 RS: a lane's keys r and r ^ RS
__device__ __forceinline__ void exchange_rows(Key (&v)[R], int size, bool best_first) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if ((r & RS) == 0) {
      const bool desc = ((((r << 5) | lane) & size) == 0) == best_first;
      const Key x = v[r], y = v[r | RS];
      const bool swap = desc ? y > x : x > y;
      v[r] = swap ? y : x;
      v[r | RS] = swap ? x : y;
    }
  }
}

template <int R>  // stride < 32: lanes lane and lane ^ stride
__device__ __forceinline__ void exchange_lanes(Key (&v)[R], int size, int stride, bool best_first) {
  const int lane = threadIdx.x & 31;
  const bool low = (lane & stride) == 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const Key y = __shfl_xor_sync(FULL, v[r], stride);
    const bool desc = ((((r << 5) | lane) & size) == 0) == best_first;
    const Key hi = v[r] > y ? v[r] : y;
    const Key lo = v[r] > y ? y : v[r];
    v[r] = low == desc ? hi : lo;
  }
}

template <int R>
__device__ __forceinline__ void exchange(Key (&v)[R], int size, int stride, bool best_first) {
  if (stride < 32) {
    exchange_lanes<R>(v, size, stride, best_first);
  } else if (stride == 32) {
    exchange_rows<R, 1>(v, size, best_first);
  } else if constexpr (R > 2) {
    if (stride == 64) {
      exchange_rows<R, 2>(v, size, best_first);
    } else if constexpr (R > 4) {
      if (stride == 128) {
        exchange_rows<R, 4>(v, size, best_first);
      } else if constexpr (R > 8) {
        exchange_rows<R, 8>(v, size, best_first);
      }
    }
  }
}

// sorts 32 R keys (bitonic), best first or best last
template <int R>
__device__ __forceinline__ void sort_regs(Key (&v)[R], bool best_first) {
#pragma unroll 1
  for (int size = 2; size <= 32 * R; size <<= 1)
#pragma unroll 1
    for (int stride = size >> 1; stride > 0; stride >>= 1) exchange<R>(v, size, stride, best_first);
}

template <int R>
struct WarpSel {
  Key q[R];   // the best H = 32 R keys so far, best first (key e in lane e % 32)
  Key* buf;   // H appended keys (shared memory)
  int fill, k;
  Key t;      // q's k-th key
};

template <int R>
__device__ __forceinline__ void warp_reset(WarpSel<R>& s) {
#pragma unroll
  for (int r = 0; r < R; ++r) s.q[r] = 0;
  s.fill = 0;
  s.t = 0;
}

// Merges the buffer into the queue: the buffer sorted best last, the elementwise
// best of the two (the best H of both, a bitonic sequence), a bitonic merge.
template <int R>
__device__ __forceinline__ void absorb(WarpSel<R>& s) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  Key b[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = (r << 5) | lane;
    b[r] = e < s.fill ? s.buf[e] : 0;
  }
  __syncwarp();  // every lane has read the buffer before it is written again
  sort_regs<R>(b, false);
#pragma unroll
  for (int r = 0; r < R; ++r) s.q[r] = s.q[r] > b[r] ? s.q[r] : b[r];
#pragma unroll 1
  for (int stride = 16 * R; stride > 0; stride >>= 1) exchange<R>(s.q, 64 * R, stride, true);
  s.fill = 0;
  const int kr = (s.k - 1) >> 5;
  Key x = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) x = r == kr ? s.q[r] : x;
  s.t = __shfl_sync(FULL, x, (s.k - 1) & 31);
}

// Every lane offers one key (ok = false: none); keys above t are appended in lane
// order. Returns whether this lane's key was kept.
template <int R>
__device__ __forceinline__ bool offer_warp(WarpSel<R>& s, bool ok, Key key) {
  const bool pass = ok && key > s.t;
  const unsigned bal = __ballot_sync(FULL, pass);
  const int total = __popc(bal);
  if (total == 0) return false;  // uniform over the warp
  if (s.fill + total > 32 * R) absorb<R>(s);
  if (pass) s.buf[s.fill + __popc(bal & lanes_below())] = key;
  s.fill += total;
  return pass;
}

// ---- a block's selection: one buffer in shared memory -------------------------

// n a power of two: the block sorts v[0, n) best first (bitonic)
__device__ void block_sort(Key* v, int n) {
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < n / 2; p += THREADS) {
        // stride is a power of two: pair p sits in run p / stride at offset p % stride
        const int i = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
        const int l = i + stride;
        const Key a = v[i], b = v[l];
        if ((i & size) == 0 ? b > a : a > b) { v[i] = b; v[l] = a; }
      }
      __syncthreads();
    }
}

struct BlockSel {
  Key* buf;  // cap entries (shared memory)
  int* counts;  // [2][WARPS] warp totals, taking turns
  int cap, k, fill, parity;
  Key t;     // the running k-th key; 0 until the buffer first fills
};

// Sorts the buffer's filled prefix (0-padded to a power of two), best first.
__device__ void block_sort_buffer(BlockSel& s) {
  const int n = pow2ceil(s.fill > 0 ? s.fill : 1);
  for (int p = s.fill + threadIdx.x; p < n; p += THREADS) s.buf[p] = 0;
  __syncthreads();
  block_sort(s.buf, n);
}

// Every thread of the block offers one key; keys above t are appended in thread
// order; a round that could overflow the buffer first cuts it back to its best k.
__device__ __forceinline__ bool offer_block(BlockSel& s, bool ok, Key key) {
  const bool pass = ok && key > s.t;
  const unsigned bal = __ballot_sync(FULL, pass);
  const int warp = threadIdx.x >> 5;
  // warp totals in a buffer of two that takes turns: a warp cannot write this
  // round's again before every warp has read it (the next round's sync)
  int* c = s.counts + s.parity * WARPS;
  if ((threadIdx.x & 31) == 0) c[warp] = __popc(bal);
  __syncthreads();
  int base = 0, total = 0;
  for (int w = 0; w < WARPS; ++w) {
    const int n = c[w];
    base += w < warp ? n : 0;
    total += n;
  }
  s.parity ^= 1;
  if (total == 0) return false;  // uniform over the block
  if (s.fill + total > s.cap) {  // fill > cap - 256 >= k
    block_sort_buffer(s);
    s.t = s.buf[s.k - 1];
    s.fill = s.k;
  }
  if (pass) s.buf[s.fill + base + __popc(bal & lanes_below())] = key;
  s.fill += total;
  return pass;
}

// ---- staging -------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Copies nbytes, 16 or 4 bytes a thread at a time where the addresses allow it,
// else a byte at a time (dst is 16-byte aligned).
__device__ void stage_bytes(unsigned char* dst, const unsigned char* src, int nbytes) {
  const unsigned align = static_cast<unsigned>(reinterpret_cast<uintptr_t>(src)) |
                         static_cast<unsigned>(nbytes);
  if ((align & 15u) == 0) {
    for (int c = threadIdx.x * 16; c < nbytes; c += blockDim.x * 16) cp_async16(dst + c, src + c);
  } else if ((align & 3u) == 0) {
    for (int c = threadIdx.x * 4; c < nbytes; c += blockDim.x * 4) cp_async4(dst + c, src + c);
  } else {
    for (int c = threadIdx.x; c < nbytes; c += blockDim.x) dst[c] = src[c];
  }
}

struct Args {
  const void* U;
  const float* us;            // (n_users,) or null
  const void* V;
  const float* vs;            // (n_items,) or null
  const int* u_idx;           // (batch,)
  const unsigned char* mask;  // (n_items,) or null
  Key* cand;                  // (batch, slices, k) scratch
  int* tickets;               // (groups,) zero before the launch, zero after it
  float* out_v;               // (batch, k)
  int* out_i;                 // (batch, k)
  int n_users, rank, n_items, batch, k, slices, slice_items, rows, tile_items, cap;
};

__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }

// one staged tile: V's rows, then the mask bytes, then the item scales
__host__ __device__ __forceinline__ int tile_v_bytes(int tile_items, int rank, int elem) {
  return round16(tile_items * rank * elem);
}
__host__ __device__ __forceinline__ int tile_bytes(int tile_items, int rank, int elem) {
  return tile_v_bytes(tile_items, rank, elem) + round16(tile_items) + 4 * tile_items;
}

template <typename T>
__device__ void stage_tile(const Args& a, unsigned char* dst, int i0, int n) {
  const int vb = tile_v_bytes(a.tile_items, a.rank, sizeof(T));
  stage_bytes(dst, static_cast<const unsigned char*>(a.V) + static_cast<size_t>(i0) * a.rank * sizeof(T),
              n * a.rank * static_cast<int>(sizeof(T)));
  if (a.mask != nullptr) stage_bytes(dst + vb, a.mask + i0, n);
  if (a.vs != nullptr)
    stage_bytes(dst + vb + round16(a.tile_items), reinterpret_cast<const unsigned char*>(a.vs + i0),
                4 * n);
  cp_async_commit();
}

// The scores of a thread's items of a staged tile's chunk at c0: item
// p = c0 + 32 G q + thread, q < ITEMS, p < n.
template <typename T, int G>
__device__ __forceinline__ void score_chunk(const Args& a, const float* u, const unsigned char* tile,
                                            int c0, int n, float (&s)[ITEMS]) {
  const T* v = reinterpret_cast<const T*>(tile);
  const int me = G == 1 ? static_cast<int>(threadIdx.x & 31) : static_cast<int>(threadIdx.x);
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) s[q] = 0.f;
  for (int j = 0; j < a.rank; ++j) {
    const float uj = u[j];
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const int p = c0 + q * 32 * G + me;
      if (p < n) s[q] = fmaf(uj, to_f32(v[p * a.rank + j]), s[q]);
    }
  }
  const int vb = tile_v_bytes(a.tile_items, a.rank, sizeof(T));
  const unsigned char* m = tile + vb;
  const float* sc = reinterpret_cast<const float*>(tile + vb + round16(a.tile_items));
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int p = c0 + q * 32 * G + me;
    if (p < n) {
      if (a.vs != nullptr) s[q] *= sc[p];
      if (a.mask != nullptr && m[p]) s[q] = NEG;
    }
  }
}

// ---- the kernel ------------------------------------------------------------------

// grid (slices, row groups). G = 1: a.rows rows a block, a warp each, a queue of
// 32 R keys; G = WARPS: one row a block, one buffer of a.cap keys.
template <typename T, int G, int R>
__global__ void __launch_bounds__(THREADS) score_select(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int me = G == 1 ? lane : static_cast<int>(threadIdx.x);
  const int rows = G == 1 ? a.rows : 1;
  const int tb = tile_bytes(a.tile_items, a.rank, sizeof(T));
  unsigned char* tiles = smem;  // two staged tiles; the merge reuses them
  Key* bufs = reinterpret_cast<Key*>(smem + 2 * tb);
  float* urows = reinterpret_cast<float*>(bufs + (G == 1 ? rows : 1) * a.cap);
  int* counts = reinterpret_cast<int*>(urows + rows * a.rank);  // [2][WARPS]
  int* last = counts + 2 * WARPS;

  const int group = blockIdx.y, slice = blockIdx.x;
  const int row0 = group * rows;
  for (int t = threadIdx.x; t < rows * a.rank; t += blockDim.x) {
    const int r = t / a.rank, j = t - r * a.rank;
    float x = 0.f;
    if (row0 + r < a.batch) {
      int u = a.u_idx[row0 + r];
      u = u < 0 ? 0 : (u >= a.n_users ? a.n_users - 1 : u);  // XLA's gather clamps
      x = to_f32(static_cast<const T*>(a.U)[static_cast<size_t>(u) * a.rank + j]);
      if (a.us != nullptr) x *= a.us[u];
    }
    urows[t] = x;
  }

  const int row = row0 + (G == 1 ? warp : 0);
  const bool active = row < a.batch;  // uniform over a warp, and over the block if G > 1
  WarpSel<G == 1 ? R : 1> ws;
  BlockSel bs{bufs, counts, a.cap, a.k, 0, 0, 0};
  if constexpr (G == 1) {
    warp_reset(ws);
    ws.buf = bufs + warp * a.cap;
    ws.k = a.k;
  }
  const float* u = urows + (G == 1 ? warp : 0) * a.rank;

  const int i0 = slice * a.slice_items;
  const int i1 = min(a.n_items, i0 + a.slice_items);
  const int n_tiles = (i1 - i0 + a.tile_items - 1) / a.tile_items;
  stage_tile<T>(a, tiles, i0, min(a.tile_items, i1 - i0));
  for (int t = 0; t < n_tiles; ++t) {
    const int it0 = i0 + t * a.tile_items;
    if (t + 1 < n_tiles) {
      const int nx = it0 + a.tile_items;
      stage_tile<T>(a, tiles + ((t + 1) & 1) * tb, nx, min(a.tile_items, i1 - nx));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and, the first time, the U rows) visible to all
    const int n = min(a.tile_items, i1 - it0);
    for (int c0 = 0; active && c0 < n; c0 += ITEMS * 32 * G) {
      float sc[ITEMS];
      score_chunk<T, G>(a, u, tiles + (t & 1) * tb, c0, n, sc);
#pragma unroll
      for (int q = 0; q < ITEMS; ++q) {
        if (c0 + q * 32 * G < n) {  // uniform over the group
          const int p = c0 + q * 32 * G + me;
          const bool ok = p < n;
          const Key key = ok ? make_key(sc[q], it0 + p) : 0;
          if constexpr (G == 1) offer_warp(ws, ok, key); else offer_block(bs, ok, key);
        }
      }
    }
    __syncthreads();  // every warp is done with tile t before tile t + 2 lands there
  }
  if (active) {
    Key* list = a.cand + (static_cast<size_t>(row) * a.slices + slice) * a.k;
    if constexpr (G == 1) {
      if (ws.fill > 0) absorb(ws);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (32 * r + lane < a.k) list[32 * r + lane] = ws.q[r];
    } else {
      block_sort_buffer(bs);
      for (int p = threadIdx.x; p < a.k; p += THREADS) list[p] = p < bs.fill ? bs.buf[p] : 0;
    }
  }

  // the last block of the row group to arrive merges the group's rows
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *last = atomicAdd(a.tickets + group, 1) == a.slices - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  // the first P entries of every list of the group's rows, into the tiles'
  // space, all copies in flight at once
  const int P = min(a.k, 2 * tb / (rows * a.slices * static_cast<int>(sizeof(Key))));
  Key* heads = reinterpret_cast<Key*>(tiles);  // [rows][slices][P]
  const int live_rows = min(rows, a.batch - row0);
  for (int r = 0; r < live_rows; ++r) {
    const Key* src = a.cand + static_cast<size_t>(row0 + r) * a.slices * a.k;
    Key* dst = heads + r * a.slices * P;
    for (int h = threadIdx.x; h < a.slices * P; h += blockDim.x) {
      const int l = h / P, p = h - (h / P) * P;
      cp_async8(dst + h, src + static_cast<size_t>(l) * a.k + p);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (active) {
    const Key* lists = a.cand + static_cast<size_t>(row) * a.slices * a.k;
    const Key* mine = heads + (G == 1 ? warp : 0) * a.slices * P;
    auto entry = [&](int l, int p) {
      return p < P ? mine[l * P + p] : __ldcg(lists + static_cast<size_t>(l) * a.k + p);
    };
    if constexpr (G == 1) warp_reset(ws); else { bs.fill = 0; bs.t = 0; }
    auto offer = [&](bool ok, Key key) {
      if constexpr (G == 1) return offer_warp(ws, ok, key); else return offer_block(bs, ok, key);
    };
    // every list's head first: a thread's lists are me, me + 32 G, ...; bit m of
    // kept_heads marks its m-th list's head as kept
    unsigned kept_heads = 0;
    for (int m = 0; m * 32 * G < a.slices; ++m) {
      const int l = me + m * 32 * G;
      if (offer(l < a.slices, l < a.slices ? entry(l, 0) : 0)) kept_heads |= 1u << m;
    }
    // then the lists whose head was kept, one after another from their second
    // entry: a list is sorted, so its first entry not kept ends it
    int m = __ffs(kept_heads) - 1, pos = 1;
    bool has = m >= 0 && pos < a.k;
    Key next = has ? entry(me + m * 32 * G, pos) : 0;
    while (G == 1 ? __any_sync(FULL, has) : __syncthreads_or(has) != 0) {
      const bool kept = offer(has, next);
      if (has) {
        if (!kept || ++pos == a.k) {
          kept_heads &= ~(1u << m);
          m = __ffs(kept_heads) - 1;
          pos = 1;
        }
        has = m >= 0 && pos < a.k;
        if (has) next = entry(me + m * 32 * G, pos);
      }
    }
    float* ov = a.out_v + static_cast<size_t>(row) * a.k;
    int* oi = a.out_i + static_cast<size_t>(row) * a.k;
    if constexpr (G == 1) {
      if (ws.fill > 0) absorb(ws);  // the lists hold at least k keys
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int e = 32 * r + lane;
        if (e < a.k) { ov[e] = key_value(ws.q[r]); oi[e] = key_index(ws.q[r]); }
      }
    } else {
      block_sort_buffer(bs);  // fill >= k: the lists hold at least k keys
      for (int p = threadIdx.x; p < a.k; p += THREADS) {
        ov[p] = key_value(bs.buf[p]);
        oi[p] = key_index(bs.buf[p]);
      }
    }
  }
  if (threadIdx.x == 0) a.tickets[group] = 0;
}

size_t smem_bytes(int rows, int cap, int rank, int tile_items, int elem, bool warp_route) {
  return 2 * static_cast<size_t>(tile_bytes(tile_items, rank, elem)) +
         sizeof(Key) * static_cast<size_t>(warp_route ? rows : 1) * cap +
         sizeof(float) * static_cast<size_t>(rows) * rank + sizeof(int) * (2 * WARPS + 4);
}

// Dynamic shared memory above 48 KB needs an opt-in, made once per kernel: the
// device's opt-in limit less the kernel's static shared memory (the limit covers
// both, so asking for the whole of it fails every launch).
template <typename T, int G, int R>
cudaError_t opt_in_smem(size_t smem) {
  static const int limit = [] {
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess ||
        cudaFuncGetAttributes(&attr, score_select<T, G, R>) != cudaSuccess)
      return -1;
    const int most = optin - static_cast<int>(attr.sharedSizeBytes);
    if (cudaFuncSetAttribute(score_select<T, G, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most) != cudaSuccess)
      return -1;
    return most;
  }();
  if (limit < 0) return cudaErrorInvalidDeviceFunction;
  return smem <= static_cast<size_t>(limit) ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int G, int R>
cudaError_t launch_route(Args a, cudaStream_t stream) {
  a.rows = G == 1 ? (a.batch < WARPS ? a.batch : WARPS) : 1;
  a.cap = buffer_cap(a.k);
  // as many items as TILE_BYTES hold, at most MAX_TILE_ITEMS and no more than a
  // slice: shared memory a block does not use lets more blocks share an SM
  int ti = TILE_BYTES / (a.rank * static_cast<int>(sizeof(T)));
  ti = min(ti, min(MAX_TILE_ITEMS, (a.slice_items + 31) / 32 * 32)) / 32 * 32;
  a.tile_items = ti < 32 ? 32 : ti;
  const size_t smem = smem_bytes(a.rows, a.cap, a.rank, a.tile_items,
                                 static_cast<int>(sizeof(T)), G == 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = opt_in_smem<T, G, R>(smem);
    if (e != cudaSuccess) return e;
  }
  const int groups = (a.batch + a.rows - 1) / a.rows;
  if (groups > 65535) return cudaErrorInvalidValue;
  const dim3 grid(a.slices, groups);
  score_select<T, G, R><<<grid, 32 * (G == 1 ? a.rows : G), smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  switch (a.k <= WARP_MAX_K ? buffer_cap(a.k) : 0) {
    case 64:
      return launch_route<T, 1, 2>(a, stream);
    case 128:
      return launch_route<T, 1, 4>(a, stream);
    case 256:
      return launch_route<T, 1, 8>(a, stream);
    case 512:
      return launch_route<T, 1, 16>(a, stream);
    default:
      return launch_route<T, WARPS, 1>(a, stream);
  }
}

}  // namespace

extern "C" {

int pio_score_topk_limits(int* max_k, int* warp_max_k, int* max_rank, int* max_slices) {
  *max_k = MAX_K;
  *warp_max_k = WARP_MAX_K;
  *max_rank = MAX_RANK;
  *max_slices = MAX_SLICES;
  return 0;
}

const char* pio_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 f32, 1 bf16, 2 int8. u_scale, v_scale and mask may be null. cand holds
// batch * slices * k 64-bit keys; tickets one int a row group (ceil(batch / 8) for
// k <= WARP_MAX_K, else batch), zero on entry and left zero. The catalog is cut
// into `slices` slices of `slice_items` items (the last may be shorter).
// Launches on `stream` and does not synchronise; returns a cudaError_t.
int pio_score_topk(const void* U, const float* u_scale, const void* V, const float* v_scale,
                   const int* u_idx, const unsigned char* mask, void* cand, int* tickets,
                   float* out_v, int* out_i, int n_users, int rank, int n_items, int batch,
                   int k, int slices, int slice_items, int dtype, void* stream) {
  if (n_users < 1 || rank < 1 || rank > MAX_RANK || n_items < 1 || batch < 1 || k < 1 ||
      k > n_items || k > MAX_K || slices < 1 || slices > MAX_SLICES || slice_items < 1 ||
      static_cast<long long>(slices) * slice_items < n_items ||
      static_cast<long long>(slices - 1) * slice_items >= n_items)
    return cudaErrorInvalidValue;
  Args a{U, u_scale, V, v_scale, u_idx, mask, static_cast<Key*>(cand), tickets, out_v, out_i,
         n_users, rank, n_items, batch, k, slices, slice_items, 0, 0, 0};
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
