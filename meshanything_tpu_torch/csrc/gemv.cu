// The decode step's layer matrices and lm_head on Hopper: y = x W^T (+ b)
// (then ReLU) for x of 1 to 16 bf16 rows, W (N, K) bf16 in nn.Linear's
// layout, y rounded once to bf16.
//
// It replaces no TPU kernel: the JAX package leaves these products to XLA.
// The port's decode step ran them on cuBLAS, which at 1-16 rows picks
// split-K GEMMs that read a 2-8 MB matrix at about a third of the card's
// rate, pays a second launch to reduce the splits and a third for fc1's
// ReLU. At M <= 16 rows a weight byte does at most 16 multiply-adds, far
// under the ~295 operations a byte at which the H100 turns compute-bound,
// so the product is bound by reading W once: ~0.6 us for a 1024 x 1024
// matrix at 3.35 TB/s, ~2.5 us for 1024 x 4096. At those sizes the fixed
// cost of a dependent launch (~2 us on this card) is as large, so the
// design streams W at the card's rate and hides what it can of the launch:
//   * block b owns output features [b R, (b + 1) R) over the whole of K,
//     so no two blocks touch one output: no cross-block reduction, no
//     second launch, no atomics;
//   * the warps of a block split K; their partial sums meet in shared
//     memory and are added in warp order;
//   * W and x stream through a ring of 16-byte cp.async copies in shared
//     memory, W with the L2 evict-first policy (each byte is read once a
//     step, and the step's 621 MB cannot stay in the 50 MB L2). Each
//     thread copies its own slots and reads only those back, so the ring
//     needs no barrier, and the copies in flight (stages - 1 of them) do
//     not depend on registers or on the compiler's schedule. A first
//     version that loaded W into registers kept only part of its loads in
//     flight and read 1024 x 4096 at M = 16 at under half the rate;
//   * programmatic dependent launch: the kernel is launched as a
//     programmatic dependent of the kernel before it, copies its first
//     stages of W (which no kernel of the step writes) before it waits
//     for that kernel (griddepcontrol.wait), and reads x and writes y only
//     after. So W's first bytes are in flight while the kernel before
//     finishes, where that kernel lets its dependents start early: this
//     one does after its main loop, the residual add and post-LN
//     (csrc/add_layer_norm.cu) at its start;
//   * epilogue: the bias in f32, the optional ReLU, one rounding to bf16:
//     F.linear with a bias, then F.relu.
// Two row tiles, one algorithm:
//   * M = 1 (4 features a block): each thread dots its 16-byte chunks of
//     the 4 rows with the same chunk of x in f32 FMAs (a warp reads 512
//     contiguous bytes of a row a copy), then a butterfly of shuffles;
//   * M = 2-16 (16 features a block): mma.sync m16n8k16 (bf16 in, f32
//     accumulators), x's rows padded with zeros to 16 as the A operand, 8
//     features of W as B. A lane of quad q copies 16 contiguous bytes of
//     its row, k = 8 q .. 8 q + 7 of a 32-wide block, and feeds them to
//     two k16 steps as the fragment positions of k = 2 q, 2 q + 8 (first
//     step) and 16 + 2 q, 24 + 2 q (second); its x chunks take the same
//     permutation, so each product pairs the right x and W elements and
//     the sum over k is the same set of products in another order. 16
//     features a block halve the L2 reads of x against 8 (each block
//     reads all of x), which at M = 16 outweighs covering fewer SMs.
// The tile sizes were chosen on the H100 over a decode step's products
// (PERF.md). Every sum runs in one fixed order, so two calls, and a graph
// replay and the eager call, are equal bit for bit. A row's result does
// not depend on the other rows, nor, at M = 2-16, on M.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 16;     // rows of x
constexpr int kMaxDevices = 64;
// M = 1: output features a block, warps a block (splitting K), stages of the ring
constexpr int kRowsM1 = 4;
constexpr int kWarpsM1 = 4;
constexpr int kStagesM1 = 4;
// M = 2-16: n tiles of 8 output features a block, warps a block (splitting K),
// stages of the ring
constexpr int kTilesMma = 2;
constexpr int kWarpsMma = 8;
constexpr int kStagesMma = 6;
constexpr int kRowsMma = 8 * kTilesMma;
// a thread's 16-byte slots a stage: a chunk of each row and one of x
constexpr int kSlotsM1 = kRowsM1 + 1;
// a lane's 16-byte slots a stage: a chunk of each tile's row, x rows g and g + 8
constexpr int kSlotsMma = kTilesMma + 2;
constexpr int kRingM1 = kStagesM1 * kSlotsM1 * 32 * kWarpsM1 * 16;      // bytes
constexpr int kRingMma = kStagesMma * kWarpsMma * kSlotsMma * 32 * 16;  // bytes

struct Args {
  const __nv_bfloat16* x;      // (M, K)
  const __nv_bfloat16* w;      // (N, K)
  const __nv_bfloat16* bias;   // (N,) or null
  __nv_bfloat16* out;          // (M, N)
  int64_t M, N, K;
  int relu;
};

__device__ __forceinline__ float lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// L2 policy for the weights: read once a step, first out of L2.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// 16 bytes from src into shared memory at dst, or 16 zero bytes where
// !valid (then src, a valid address of the same tensor, is not read).
__device__ __forceinline__ void copy16(void* dst, const void* src, bool valid, uint64_t policy) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0), "l"(policy)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until the kernel before (launched before this programmatic
// dependent) has finished and its writes are visible.
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Let the kernel after, if it is a programmatic dependent, start.
__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// acc + the 8 bf16 of w dotted with the 8 f32 of xf.
__device__ __forceinline__ float dot8(uint4 w, const float (&xf)[8], float acc) {
  acc = fmaf(lo(w.x), xf[0], acc);
  acc = fmaf(hi(w.x), xf[1], acc);
  acc = fmaf(lo(w.y), xf[2], acc);
  acc = fmaf(hi(w.y), xf[3], acc);
  acc = fmaf(lo(w.z), xf[4], acc);
  acc = fmaf(hi(w.z), xf[5], acc);
  acc = fmaf(lo(w.w), xf[6], acc);
  acc = fmaf(hi(w.w), xf[7], acc);
  return acc;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// c += a . b for one m16n8k16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Output (m, n0 + n): the warps' partials part[w][m][n] (rows of kRows
// features) added in warp order, then the bias, the ReLU, one rounding.
template <int kWarps, int kRows>
__device__ __forceinline__ void finish(const Args& a, const float* part, int64_t m, int n,
                                       int64_t n0) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += part[(w * kMaxRows + m) * kRows + n];
  if (a.bias != nullptr) s += __bfloat162float(a.bias[n0 + n]);
  if (a.relu && s < 0.f) s = 0.f;   // NaN passes, as F.relu passes it
  a.out[m * a.N + n0 + n] = __float2bfloat16_rn(s);
}

// M = 1. Stage j of thread t is the 16-byte chunk c = j * threads + t of
// each of the block's rows n0 .. n0 + kRowsM1 - 1 and of x.
__global__ void __launch_bounds__(32 * kWarpsM1) decode_gemv_kernel_m1(const Args a) {
  constexpr int kThreads = 32 * kWarpsM1;
  extern __shared__ __align__(16) uint4 ring[];   // [stage][slot][thread]
  __shared__ float part[kWarpsM1 * kMaxRows * kRowsM1];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kRowsM1;
  const int64_t chunks = a.K / 8;
  const int64_t stages = (chunks + kThreads - 1) / kThreads;
  const int live = static_cast<int>(a.N - n0 < kRowsM1 ? a.N - n0 : kRowsM1);
  const uint64_t policy = evict_first();
  auto slots = [&](int64_t j) { return ring + (j % kStagesM1) * kSlotsM1 * kThreads + tid; };
  auto copy_w = [&](int64_t j) {
    if (j >= stages) return;
    const int64_t c = j * kThreads + tid;
#pragma unroll
    for (int r = 0; r < kRowsM1; ++r) {
      const bool ok = c < chunks && r < live;
      copy16(slots(j) + r * kThreads, ok ? a.w + (n0 + r) * a.K + 8 * c : a.w, ok, policy);
    }
  };
  // x's chunk, then the stage's group is closed (an empty one past the end)
  auto copy_x = [&](int64_t j) {
    if (j < stages) {
      const int64_t c = j * kThreads + tid;
      copy16(slots(j) + kRowsM1 * kThreads, c < chunks ? a.x + 8 * c : a.x, c < chunks, policy);
    }
    commit();
  };
  float acc[kRowsM1];
#pragma unroll
  for (int r = 0; r < kRowsM1; ++r) acc[r] = 0.f;
#pragma unroll
  for (int j = 0; j < kStagesM1 - 1; ++j) copy_w(j);
  wait_for_previous();
#pragma unroll
  for (int j = 0; j < kStagesM1 - 1; ++j) copy_x(j);
  for (int64_t j = 0; j < stages; ++j) {
    copy_w(j + kStagesM1 - 1);
    copy_x(j + kStagesM1 - 1);
    wait_copies<kStagesM1 - 1>();   // stage j has landed
    const uint4* slot = slots(j);
    const uint4 xv = slot[kRowsM1 * kThreads];
    const float xf[8] = {lo(xv.x), hi(xv.x), lo(xv.y), hi(xv.y),
                         lo(xv.z), hi(xv.z), lo(xv.w), hi(xv.w)};
#pragma unroll
    for (int r = 0; r < kRowsM1; ++r) acc[r] = dot8(slot[r * kThreads], xf, acc[r]);
  }
  let_next_start();
#pragma unroll
  for (int r = 0; r < kRowsM1; ++r) {
    const float s = warp_sum(acc[r]);
    if (lane == 0) part[warp * kMaxRows * kRowsM1 + r] = s;
  }
  __syncthreads();
  if (tid < live) finish<kWarpsM1, kRowsM1>(a, part, 0, tid, n0);
}

// M = 2-16. Stage j of warp w is the 32-wide k block b = j * kWarpsMma + w;
// lane (g, q) = (lane / 4, lane % 4) copies row n0 + 8 t + g of W for each
// tile t, and rows g and g + 8 of x (g + 8 only where M > 8), at
// k = 32 b + 8 q .. + 7.
__global__ void __launch_bounds__(32 * kWarpsMma) decode_gemv_kernel_mma(const Args a) {
  constexpr int kThreads = 32 * kWarpsMma;
  extern __shared__ __align__(16) uint4 ring[];   // [stage][warp][slot][lane]
  __shared__ float part[kWarpsMma * kMaxRows * kRowsMma];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kRowsMma;
  const int64_t K = a.K;
  const int64_t stages = ((K + 31) / 32 + kWarpsMma - 1) / kWarpsMma;
  const bool x_lo = g < a.M, x_hi = g + 8 < a.M, two = a.M > 8;
  const uint64_t policy = evict_first();
  auto slots = [&](int64_t j) {
    return ring + ((j % kStagesMma) * kWarpsMma + warp) * kSlotsMma * 32 + lane;
  };
  auto k_of = [&](int64_t j) { return 32 * (j * kWarpsMma + warp) + 8 * q; };
  auto copy_w = [&](int64_t j) {
    if (j >= stages) return;
    const int64_t k = k_of(j);
#pragma unroll
    for (int t = 0; t < kTilesMma; ++t) {
      const int64_t row = n0 + 8 * t + g;
      const bool ok = k < K && row < a.N;
      copy16(slots(j) + t * 32, ok ? a.w + row * K + k : a.w, ok, policy);
    }
  };
  // x's chunks, then the stage's group is closed (an empty one past the end)
  auto copy_x = [&](int64_t j) {
    if (j < stages) {
      const int64_t k = k_of(j);
      const bool lo_ok = k < K && x_lo, hi_ok = k < K && x_hi;
      copy16(slots(j) + kTilesMma * 32, lo_ok ? a.x + g * K + k : a.x, lo_ok, policy);
      if (two) {
        copy16(slots(j) + (kTilesMma + 1) * 32, hi_ok ? a.x + (g + 8) * K + k : a.x, hi_ok,
               policy);
      }
    }
    commit();
  };
  float acc[kTilesMma][4];
#pragma unroll
  for (int t = 0; t < kTilesMma; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
#pragma unroll
  for (int j = 0; j < kStagesMma - 1; ++j) copy_w(j);
  wait_for_previous();
#pragma unroll
  for (int j = 0; j < kStagesMma - 1; ++j) copy_x(j);
  for (int64_t j = 0; j < stages; ++j) {
    copy_w(j + kStagesMma - 1);
    copy_x(j + kStagesMma - 1);
    wait_copies<kStagesMma - 1>();   // stage j has landed
    const uint4* slot = slots(j);
    const uint4 xa = slot[kTilesMma * 32];
    const uint4 xb = two ? slot[(kTilesMma + 1) * 32] : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int t = 0; t < kTilesMma; ++t) {
      const uint4 wv = slot[t * 32];
      mma(acc[t], xa.x, xb.x, xa.y, xb.y, wv.x, wv.y);
      mma(acc[t], xa.z, xb.z, xa.w, xb.w, wv.z, wv.w);
    }
  }
  let_next_start();
  // acc[t]: (row g, features 8 t + 2 q, + 1) and (row g + 8, the same features)
  float* mine = part + warp * kMaxRows * kRowsMma;
#pragma unroll
  for (int t = 0; t < kTilesMma; ++t) {
    const int n = 8 * t + 2 * q;
    mine[g * kRowsMma + n] = acc[t][0];
    mine[g * kRowsMma + n + 1] = acc[t][1];
    mine[(g + 8) * kRowsMma + n] = acc[t][2];
    mine[(g + 8) * kRowsMma + n + 1] = acc[t][3];
  }
  __syncthreads();
  const int live = static_cast<int>(a.N - n0 < kRowsMma ? a.N - n0 : kRowsMma);
  for (int i = tid; i < a.M * kRowsMma; i += kThreads) {
    const int m = i / kRowsMma, n = i % kRowsMma;
    if (n < live) finish<kWarpsMma, kRowsMma>(a, part, m, n, n0);
  }
}

// Let `kernel` take `bytes` of dynamic shared memory on the current
// device (once a device).
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes, bool (&done)[kMaxDevices]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done[device] = true;
  return err;
}

// One launch of `kernel` (blocks of `rows` output features) on `st`, as a
// programmatic dependent of the kernel before it there.
template <typename Kernel>
cudaError_t launch(Kernel kernel, int64_t rows, int threads, int smem,
                   bool (&opted)[kMaxDevices], cudaStream_t st, const Args& a) {
  cudaError_t err = opt_in(kernel, smem, opted);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>((a.N + rows - 1) / rows));
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes; returns the CUDA error of the launch
// (0 on success). bf16 x (M, K) with 1 <= M <= 16, w (N, K), bias (N,) or
// null, out (M, N); x and w contiguous and 16-byte aligned, out and bias
// contiguous; K a multiple of 8. relu: 0 or 1.
extern "C" int mt_gemv(const void* x, const void* w, const void* bias, void* out, int64_t M,
                       int64_t N, int64_t K, int relu, void* stream) {
  if (M < 1 || M > kMaxRows || N < 1 || N > 0x3fffffffLL || K < 8 || K % 8 != 0 ||
      x == nullptr || w == nullptr || out == nullptr ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15u) != 0 ||
      ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(bias)) & 1u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const __nv_bfloat16*>(bias);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.M = M;
  a.N = N;
  a.K = K;
  a.relu = relu != 0;
  static bool opted_m1[kMaxDevices] = {};
  static bool opted_mma[kMaxDevices] = {};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      M == 1 ? launch(decode_gemv_kernel_m1, kRowsM1, 32 * kWarpsM1, kRingM1, opted_m1, st, a)
             : launch(decode_gemv_kernel_mma, kRowsMma, 32 * kWarpsMma, kRingMma, opted_mma, st,
                      a);
  return static_cast<int>(err);
}

extern "C" const char* mt_gemv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
