// The decode step's residual add and post-LayerNorm on Hopper, in one
// launch: out = LayerNorm(x + y) * weight + bias, a row at a time.
//
// It replaces no TPU kernel. The JAX package writes this epilogue as
// plain jnp (meshanything_tpu/models/shape_opt.py: `layer_norm(x + ...)`
// after the attention and after the MLP of each layer) and XLA fuses the
// add and the norm into the neighbouring ops of the compiled step. The port runs the step as a CUDA graph of eager ops,
// where `ln(x + y, m)` (models/layers.py) is six launches: the add, three
// casts to f32 (x, weight, bias), the norm and the cast back. This kernel
// is those six as one, at each of the decode step's two norm sites a
// layer (ops/add_layer_norm.py routes them).
//
// Numerics are the plain path's, point for point: the sum x + y is
// rounded to the activation dtype before any statistic (as the eager add
// rounds it), mean and biased variance are taken in f32, weight and bias
// are widened to f32 in registers (exact), the output is
// weight * (rstd * (s - mean)) + bias in f32, rounded once to the
// activation dtype. Only the order of the f32 sums differs from
// PyTorch's layer norm (two exact passes over registers here, Welford
// there), so a bf16 output differs from the plain one by at most one
// ulp, and rarely.
//
// What bounds it on this card: launches, not bytes. At the decode's
// sizes (B x d = 1-16 x 1,024, bf16) a call moves 10-160 KB, 3-48 ns of
// HBM time, against ~2-3 us for a launch inside a replayed graph. So the
// design is one launch that does the whole epilogue with nothing between
// its parts:
//   * one block a row, d / 8 threads for bf16 (d / 4 for f32): each
//     thread loads 16 bytes of x, y, weight and bias, all four issued
//     before any arithmetic, and keeps its slice of the row in registers;
//   * the row's two sums (mean, then the squared deviations from it) by
//     warp shuffles and one word a warp in shared memory, which every
//     thread adds in warp order, so every thread holds the same mean and
//     rstd: two block barriers, no scratch in device memory;
//   * one 16-byte store a thread.
// The kernel allocates nothing and launches on the caller's stream, so a
// CUDA graph captures it like any other node; the wrapper allocates the
// output and checks the shapes, the dtypes and the alignment.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDim = 4096;   // 512 threads a row in bf16, 1,024 in f32
constexpr int kMaxWarps = 32;   // 1,024 threads

template <typename T>
struct Lanes;  // elements of T in one 16-byte vector
template <>
struct Lanes<float> {
  static constexpr int n = 4;
};
template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int n = 8;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The sum of v over the block, the same in every thread: a butterfly of
// shuffles in each warp (every lane ends with the warp's sum), one word a
// warp in `part`, then each thread adds the warps' words in warp order.
__device__ __forceinline__ float block_sum(float v, float* part) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) total += part[w];
  return total;
}

// Block r normalizes row r of x + y (rows of d elements). blockDim.x is
// d / Lanes rounded up to a whole warp; threads past the row hold zeros.
template <typename T>
__global__ void __launch_bounds__(1024)
    add_layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ y,
                          const T* __restrict__ weight, const T* __restrict__ bias,
                          T* __restrict__ out, int d, float eps) {
  // A kernel launched after this one as a programmatic dependent (the
  // decode step's products, csrc/gemv.cu) may start now: it copies its
  // weights, which this kernel does not write, and waits for this grid to
  // finish before it reads anything else. Without such a dependent it is a
  // no-op.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  constexpr int kLanes = Lanes<T>::n;
  __shared__ float sum_part[kMaxWarps];
  __shared__ float sq_part[kMaxWarps];
  const int col = threadIdx.x * kLanes;
  const bool live = col < d;
  const int64_t at = static_cast<int64_t>(blockIdx.x) * d + col;

  uint4 xv = make_uint4(0u, 0u, 0u, 0u), yv = xv, wv = xv, bv = xv;
  if (live) {
    xv = *reinterpret_cast<const uint4*>(x + at);
    yv = *reinterpret_cast<const uint4*>(y + at);
    wv = *reinterpret_cast<const uint4*>(weight + col);
    bv = *reinterpret_cast<const uint4*>(bias + col);
  }
  const T* xe = reinterpret_cast<const T*>(&xv);
  const T* ye = reinterpret_cast<const T*>(&yv);
  const T* we = reinterpret_cast<const T*>(&wv);
  const T* be = reinterpret_cast<const T*>(&bv);
  float s[kLanes];
  float local = 0.0f;
#pragma unroll
  for (int i = 0; i < kLanes; ++i) {
    // the residual sum, rounded to T as the eager add rounds it
    s[i] = live ? widen(narrow<T>(widen(xe[i]) + widen(ye[i]))) : 0.0f;
    local += s[i];
  }
  const float mean = block_sum(local, sum_part) / static_cast<float>(d);
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < kLanes; ++i) {
    const float c = live ? s[i] - mean : 0.0f;
    sq += c * c;
  }
  const float var = block_sum(sq, sq_part) / static_cast<float>(d);
  const float rstd = rsqrtf(var + eps);
  if (!live) return;
  uint4 ov;
  T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
  for (int i = 0; i < kLanes; ++i) {
    oe[i] = narrow<T>(widen(we[i]) * (rstd * (s[i] - mean)) + widen(be[i]));
  }
  *reinterpret_cast<uint4*>(out + at) = ov;
}

template <typename T>
cudaError_t launch(const void* x, const void* y, const void* weight, const void* bias, void* out,
                   int64_t rows, int64_t d, float eps, cudaStream_t stream) {
  const int threads = static_cast<int>((d / Lanes<T>::n + 31) / 32 * 32);
  add_layer_norm_kernel<T><<<static_cast<unsigned>(rows), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(weight),
      static_cast<const T*>(bias), static_cast<T*>(out), static_cast<int>(d), eps);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes; returns the CUDA error of the launch
// (0 on success). x, y, out: (rows, d) contiguous; weight, bias: (d,);
// all of one dtype (0 = float32, 1 = bfloat16) and 16-byte aligned;
// d a multiple of 8 up to 4,096.
extern "C" int mt_add_layer_norm(const void* x, const void* y, const void* weight,
                                 const void* bias, void* out, int dtype, int64_t rows, int64_t d,
                                 double eps, void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || d < 8 || d > kMaxDim || d % 8 != 0 ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
        reinterpret_cast<uintptr_t>(weight) | reinterpret_cast<uintptr_t>(bias) |
        reinterpret_cast<uintptr_t>(out)) & 15u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float e = static_cast<float>(eps);   // as F.layer_norm takes it
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = launch<float>(x, y, weight, bias, out, rows, d, e, st);
  if (dtype == 1) err = launch<__nv_bfloat16>(x, y, weight, bias, out, rows, d, e, st);
  return static_cast<int>(err);
}

extern "C" const char* mt_add_layer_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
