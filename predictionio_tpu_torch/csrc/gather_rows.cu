// Rows of a factor matrix gathered by index and widened to f32, for Hopper (sm_90a).
//
// Replaces the TPU kernel predictionio_tpu/ops/train_kernel.py:_gather_rows_kernel,
// reached through fused_gather_rows (the segment solver's per-chunk gather,
// models/als.py:_half_step_local).
//
// What it computes: out[i, c] = f32(V[r, c]) with r = idx[i] clamped into [0, n_opp),
// times scale[r] for int8 (one rounded f32 multiply). bf16 and int8 widen to f32
// exactly, so the result equals "dequantize V, then gather" bit for bit: the plain
// version's order, and XLA's.
//
// What bounds it: each call reads idx (4 B a row), the distinct rows of V it names
// and writes n*k f32 values. At the segment solver's chunk (65,536 rows, rank 10,
// 18-43 thousand distinct rows) that is 3.6-4.6 MB, a bound of 1.1-1.4 us at
// 3.35 TB/s; it does one multiply a value at most, so bytes bound it.
//
// Design. The TPU kernel streams V into VMEM once and copies one row at a time from
// there into a block of 512 rows. On the H100, V (2.4 MB of items, 6.5 MB of users
// at f32, rank 10) stays in the 50 MB L2 across calls, so nothing has to be made
// resident: one thread per output value, consecutive threads on consecutive values
// of the (n, k) output, so the stores coalesce and each row of V is read by k
// neighbouring threads. The flat index is 32-bit: n * k must stay below 2^31
// (Python: MAX_ELEMENTS), which at rank 256 still allows 8.4 million rows a call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_ELEMENTS = 0x7fffffffLL;  // n * k (Python: MAX_ELEMENTS)

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(int8_t v) { return static_cast<float>(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS) gather_rows_kernel(
    const int* __restrict__ idx, const T* __restrict__ V, const float* __restrict__ scale,
    float* __restrict__ out, int total, int n_opp, int k) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const int i = t / k;
  const int c = t - i * k;
  int r = __ldg(idx + i);
  r = r < 0 ? 0 : (r >= n_opp ? n_opp - 1 : r);  // clamped, as XLA's gather
  float v = widen(V[static_cast<long long>(r) * k + c]);
  if (scale != nullptr) v = __fmul_rn(v, __ldg(scale + r));
  out[t] = v;
}

template <typename T>
cudaError_t launch(const int* idx, const void* V, const float* scale, float* out, int n,
                   int n_opp, int k, cudaStream_t stream) {
  const int total = n * k;
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  gather_rows_kernel<T><<<blocks, THREADS, 0, stream>>>(
      idx, static_cast<const T*>(V), scale, out, total, n_opp, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pio_gather_rows_limits(long long* max_elements) {
  *max_elements = MAX_ELEMENTS;
  return 0;
}

const char* pio_gather_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 f32, 1 bf16, 2 int8 (scale required, (n_opp, 1) f32). out: (n, k) f32.
// Launches on `stream` and does not synchronise; returns a cudaError_t.
int pio_gather_rows(const int* idx, const void* V, const float* scale, float* out, int n,
                    int n_opp, int k, int dtype, void* stream) {
  if (n < 1 || n_opp < 1 || k < 1 || static_cast<long long>(n) * k > MAX_ELEMENTS)
    return cudaErrorInvalidValue;
  if ((dtype == 2) != (scale != nullptr)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(idx, V, nullptr, out, n, n_opp, k, s);
    case 1:
      return launch<__nv_bfloat16>(idx, V, nullptr, out, n, n_opp, k, s);
    case 2:
      return launch<int8_t>(idx, V, scale, out, n, n_opp, k, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
