// Tensor-core products at float32 accuracy (3xTF32) and cp.async staging, shared by
// the flash-attention kernels (csrc/flash_fwd.cu and csrc/flash_bwd.cu).
//
// 3xTF32. mma.sync.aligned.m16n8k8 takes TF32 operands (10 mantissa bits) and sums
// in float32. Each float operand x is split into hi = rna_tf32(x) and
// lo = rna_tf32(x - hi) (x - hi is exact in float32; rna_tf32 rounds as
// cvt.rna.tf32.f32 does), and a product is formed as
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, accumulated in float32: the terms dropped
// (a_lo*b_lo and lo's own rounding) are about 2^-22 of the product, near a float32
// FMA's rounding, where a single TF32 product is off by about 2^-11.
//
// Fragment layouts of m16n8k8 (.row.col, tf32 → f32), for lane = 4*g + t
// (g = lane >> 2, t = lane & 3):
//   A (16 x 8, row-major):  a0 = A[g][t]   a1 = A[g+8][t]   a2 = A[g][t+4]   a3 = A[g+8][t+4]
//   B (8 x 8, k x n):       b0 = B[t][g]   b1 = B[t+4][g]
//   C (16 x 8):             c0 = C[g][2t]  c1 = C[g][2t+1]  c2 = C[g+8][2t]  c3 = C[g+8][2t+1]
// A product whose A operand is a C fragment of an earlier product (p v, pᵀ do, dsᵀ q)
// takes it as it stands by renaming the 8-wide k axis: k index t stands for column
// 2t of the C tile and k index t+4 for column 2t+1, so a = {c0, c2, c1, c3} and the
// B operand's rows are read in the same order, b0 = B[2t][g], b1 = B[2t+1][g]. A sum
// over k does not depend on the names of its terms.
//
// Shared-memory tiles are row-major with a row stride of W + 4 floats, W a
// multiple of 8 at least the head width: the stride is 4 mod 8, so both fragment
// patterns (rows g, columns t; rows 2t, columns g) hit 32 distinct banks. Columns
// d..W-1 hold zeros written before the first copy: a product reads them, and
// garbage there could be NaN, which times 0 is still NaN.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pio_mma {

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero: the
// rounding of cvt.rna.tf32.f32, bit for bit on finite values, as two integer
// operations (half a TF32 ulp added to the magnitude, the 13 low bits cleared),
// which the card runs several times faster than the cvt.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x → (hi, lo), both TF32 bit patterns
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A operand split once, used against several B operands.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float x0, float x1, float x2, float x3) {
    split(x0, hi[0], lo[0]);
    split(x1, hi[1], lo[1]);
    split(x2, hi[2], lo[2]);
    split(x3, hi[3], lo[3]);
  }
};

struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float x0, float x1) {
    split(x0, hi[0], lo[0]);
    split(x1, hi[1], lo[1]);
  }
};

// c[i] += a b[i], i < N, at float32 accuracy, for one 8-deep step of k. The three
// TF32 products (the two small ones first) are summed from zero on the tensor
// cores and then added to c in float32, rounded to nearest: the tensor cores'
// own additions truncate, and a chain of them across steps drifts several times
// further from the exact sum than float32 FMAs. Each pass issues its N
// independent products back to back, so a product's latency hides behind the
// others' (one chain of three at a time leaves a lone warp idle).
template <int N>
__device__ __forceinline__ void mma3(float (*c)[4], const FragA& a, const FragB* b) {
  float t[N][4];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i][0] = t[i][1] = t[i][2] = t[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(t[i], a.lo, b[i].hi);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(t[i], a.hi, b[i].lo);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(t[i], a.hi, b[i].hi);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] += t[i][e];
}

// The same for two sets of N products, interleaved pass by pass.
template <int N>
__device__ __forceinline__ void mma3_pair(float (*c)[4], const FragA& a, const FragB* b,
                                          float (*e)[4], const FragA& x, const FragB* y) {
  float t[N][4], u[N][4];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) t[i][k] = u[i][k] = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mma_tf32(t[i], a.lo, b[i].hi);
    mma_tf32(u[i], x.lo, y[i].hi);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mma_tf32(t[i], a.hi, b[i].lo);
    mma_tf32(u[i], x.hi, y[i].lo);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mma_tf32(t[i], a.hi, b[i].hi);
    mma_tf32(u[i], x.hi, y[i].hi);
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[i][k] += t[i][k];
      e[i][k] += u[i][k];
    }
}

// ---- cp.async ---------------------------------------------------------------

// Copies BYTES (4, 8 or 16) from global to shared memory, or writes BYTES of
// zeros when !valid (src-size 0: src is not read).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(BYTES),
                 "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// f(r, c) for every r < rows and c < cols, spread over the block's threads in
// row-major order (neighbouring threads on neighbouring columns), with one
// division a thread. A warp walking rows while its lanes walk a row's columns
// (a trip count that differs by lane inside a warp-wide loop) ran many times
// slower on the card.
template <typename F>
__device__ __forceinline__ void for_each_2d(int rows, int cols, F f) {
  const int n = blockDim.x;
  const int dr = n / cols, dc = n - dr * cols;
  int r = threadIdx.x / cols, c = threadIdx.x - r * cols;
  while (r < rows) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// Rows [0, rows) of a row-major (rows x d) float tile starting at src, into dst
// with row stride ds; rows at or past `valid` are written as zeros. VEC floats a
// copy (4, 2 or 1: the caller checks that every row start is aligned to it).
template <int VEC>
__device__ __forceinline__ void stage_rows_vec(float* dst, int ds, const float* src, int rows,
                                               int valid, int d) {
  for_each_2d(rows, d / VEC, [&](int r, int p) {
    const bool in = r < valid;
    cp_async<4 * VEC>(dst + r * ds + VEC * p, src + static_cast<long long>(in ? r : 0) * d + VEC * p, in);
  });
}

__device__ __forceinline__ void stage_rows(float* dst, int ds, const float* src, int rows, int valid,
                                           int d, int vec) {
  if (vec == 4) {
    stage_rows_vec<4>(dst, ds, src, rows, valid, d);
  } else if (vec == 2) {
    stage_rows_vec<2>(dst, ds, src, rows, valid, d);
  } else {
    stage_rows_vec<1>(dst, ds, src, rows, valid, d);
  }
}

// floats [0, n) of src into dst, 4 bytes a copy, zeros at or past `valid`
__device__ __forceinline__ void stage_vector(float* dst, const float* src, int n, int valid) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async<4>(dst + i, src + (i < valid ? i : 0), i < valid);
}

// Columns [d, w) of `rows` rows of stride ds set to zero (cp.async never writes them).
__device__ __forceinline__ void zero_pad_columns(float* dst, int ds, int rows, int d, int w) {
  if (w > d) for_each_2d(rows, w - d, [&](int r, int c) { dst[r * ds + d + c] = 0.f; });
}

// The widest copy (floats) every row start allows: d floats a row from base.
__host__ __device__ inline int copy_vec(int d, const void* const* bases, int n) {
  uintptr_t bits = static_cast<uintptr_t>(d) * 4;
  for (int i = 0; i < n; ++i) bits |= reinterpret_cast<uintptr_t>(bases[i]);
  return bits % 16 == 0 ? 4 : bits % 8 == 0 ? 2 : 1;
}

__host__ __device__ inline int pad8(int d) { return (d + 7) & ~7; }

}  // namespace pio_mma
