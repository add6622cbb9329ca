// The routed experts of a mixture-of-experts layer in the Moonlight
// decoder's decode step on Hopper: for token b and slot s,
//
//   hidden[b, s] = silu(gate_s x[b]) * (up_s x[b])             (I values)
//   out[b]       = sum over s, in order, of w[b, s] * down_s hidden[b, s]
//
// where slot s < K is the token's s-th chosen expert (ids[b, s], read on
// the device, its weight w[b, s]) and slot K + j is slice j of the shared
// experts (weight 1): rows [j I, (j + 1) I) of their gate and up, those
// columns of their down (ops/experts.py).
//
// It replaces no TPU kernel: the JAX package has no expert layer. At B=1
// a step reads only the chosen experts' matrices (6 of 64, 17.3 MB each on
// Moonlight) and the shared ones, which is most of the step's bytes, so
// the design is two launches that stream those matrices at the card's
// read rate:
//   * gate_up: one warp an intermediate row i of one slot of one token,
//     reading the gate row and the up row together (16-byte loads, four a
//     lane in flight per row) against x in shared memory, summed by a
//     butterfly of shuffles, silu(g) * u written as f32;
//   * down: one warp an output column of one token, its shared-memory
//     copy of the token's hidden rows, each slot's row of down read in
//     turn, weighted and added in slot order (a lane's loads of all slots
//     in one loop, each chunk weighted as it is added, ran 11% slower on
//     the H100: it reads no more, and the weighted sums cost more).
// No float atomics anywhere: a call's output is the same bit for bit from
// run to run. The ids are read by the kernels, so a CUDA graph replays
// them whatever the routing. The first block of each chosen slot also
// adds the token to counts[layer, expert] (an integer atomic) and writes
// the id into the routing record, routes[layer, b, pos, s] (pos read on
// the device), so neither needs a launch of its own. At B > 1 a token
// reads its experts' matrices for itself: correct, not fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;           // warps a block
constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 232448;    // dynamic shared memory a block may opt in to

struct Args {
  const __nv_bfloat16* x;      // (B, d)
  const int64_t* ids;          // (B, K)
  const float* weights;        // (B, K)
  const __nv_bfloat16* gate;   // (E, I, d)
  const __nv_bfloat16* up;     // (E, I, d)
  const __nv_bfloat16* down;   // (E, d, I)
  const __nv_bfloat16* sgate;  // (n_shared I, d), or null
  const __nv_bfloat16* sup;    // (n_shared I, d)
  const __nv_bfloat16* sdown;  // (d, n_shared I)
  float* hidden;               // (B, K + n_shared, I)
  float* out;                  // (B, d)
  int* counts;                 // (layers, E), or null
  int* routes;                 // (layers, B, S, K), or null
  const int64_t* pos;          // the position whose routes row this call writes
  int64_t B, K, n_shared, E, I, d, layer, S;
};

__device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// The 8 bf16 of `w` dotted with 8 f32 at `v` (16-byte aligned shared memory), added to acc.
__device__ __forceinline__ float dot8(uint4 w, const float* v, float acc) {
  const float4 a = *reinterpret_cast<const float4*>(v);
  const float4 c = *reinterpret_cast<const float4*>(v + 4);
  acc = fmaf(lo(w.x), a.x, acc);
  acc = fmaf(hi(w.x), a.y, acc);
  acc = fmaf(lo(w.y), a.z, acc);
  acc = fmaf(hi(w.y), a.w, acc);
  acc = fmaf(lo(w.z), c.x, acc);
  acc = fmaf(hi(w.z), c.y, acc);
  acc = fmaf(lo(w.w), c.z, acc);
  acc = fmaf(hi(w.w), c.w, acc);
  return acc;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A weight read once and never again this step: around L1.
__device__ __forceinline__ uint4 stream_load(const __nv_bfloat16* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

// grid (ceil(I / kWarps), K + n_shared, B): warp w of block (x, s, b) makes
// hidden[b, s, x * kWarps + w].
__global__ void __launch_bounds__(32 * kWarps) expert_gate_up_kernel(const Args a) {
  extern __shared__ __align__(16) float xs[];   // x[b] as f32
  const int64_t b = blockIdx.z;
  const int s = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t d = a.d, I = a.I;
  for (int64_t c = threadIdx.x; c < d; c += blockDim.x) xs[c] = __bfloat162float(a.x[b * d + c]);
  int64_t e = -1;
  if (s < a.K) {
    e = a.ids[b * a.K + s];
    if (e < 0 || e >= a.E) e = -1;   // an id outside the table: the slot adds nothing
  }
  if (blockIdx.x == 0 && threadIdx.x == 0 && s < a.K) {
    if (a.counts != nullptr && e >= 0) atomicAdd(a.counts + a.layer * a.E + e, 1);
    const int64_t p = a.routes != nullptr ? *a.pos : -1;
    if (p >= 0 && p < a.S) {
      a.routes[((a.layer * a.B + b) * a.S + p) * a.K + s] = static_cast<int>(a.ids[b * a.K + s]);
    }
  }
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (i >= I) return;
  const __nv_bfloat16 *g, *u;
  if (s < a.K) {
    if (e < 0) {
      if (lane == 0) a.hidden[(b * (a.K + a.n_shared) + s) * I + i] = 0.f;
      return;
    }
    g = a.gate + (e * I + i) * d;
    u = a.up + (e * I + i) * d;
  } else {
    const int64_t j = s - a.K;
    g = a.sgate + (j * I + i) * d;
    u = a.sup + (j * I + i) * d;
  }
  float ag = 0.f, au = 0.f;
  const int64_t chunks = d / 8;
  // four 16-byte chunks of a row a lane in flight
#pragma unroll 4
  for (int64_t c = lane; c < chunks; c += 32) {
    const uint4 wg = stream_load(g + 8 * c);
    const uint4 wu = stream_load(u + 8 * c);
    ag = dot8(wg, xs + 8 * c, ag);
    au = dot8(wu, xs + 8 * c, au);
  }
  ag = warp_sum(ag);
  au = warp_sum(au);
  if (lane == 0) {
    a.hidden[(b * (a.K + a.n_shared) + s) * I + i] = ag / (1.f + expf(-ag)) * au;
  }
}

// grid (ceil(d / kWarps), B): warp w of block (x, b) makes out[b, x * kWarps + w].
__global__ void __launch_bounds__(32 * kWarps) expert_down_kernel(const Args a) {
  extern __shared__ __align__(16) float hs[];   // hidden[b]: (K + n_shared, I)
  const int64_t b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t I = a.I, d = a.d;
  const int64_t slots = a.K + a.n_shared;
  const float4* src = reinterpret_cast<const float4*>(a.hidden + b * slots * I);
  for (int64_t c = threadIdx.x; c < slots * I / 4; c += blockDim.x) {
    reinterpret_cast<float4*>(hs)[c] = src[c];
  }
  __syncthreads();
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (col >= d) return;
  const int64_t chunks = I / 8;
  float acc = 0.f;
  for (int64_t s = 0; s < slots; ++s) {
    const __nv_bfloat16* row;
    float w = 1.f;
    if (s < a.K) {
      const int64_t e = a.ids[b * a.K + s];
      if (e < 0 || e >= a.E) continue;
      row = a.down + (e * d + col) * I;
      w = a.weights[b * a.K + s];
    } else {
      row = a.sdown + col * (a.n_shared * I) + (s - a.K) * I;
    }
    float part = 0.f;
    const float* h = hs + s * I;
    // four 16-byte chunks of a row a lane in flight
#pragma unroll 4
    for (int64_t c = lane; c < chunks; c += 32) {
      part = dot8(stream_load(row + 8 * c), h + 8 * c, part);
    }
    acc = fmaf(w, warp_sum(part), acc);
  }
  if (lane == 0) a.out[b * d + col] = acc;
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int64_t bytes, int64_t (&opted)[kMaxDevices]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= opted[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) opted[device] = bytes;
  return err;
}

}  // namespace

// C interface, loaded with ctypes; returns the CUDA error of the launches
// (0 on success). bf16 x (B, d), gate and up (E, I, d), down (E, d, I),
// the shared experts' gate and up (n_shared I, d) and down (d, n_shared I)
// or null with n_shared 0; int64 ids and f32 weights (B, K); f32 hidden
// (B, K + n_shared, I) scratch and out (B, d); counts (layers, E) int32 or
// null; routes (layers, B, S, K) int32 and pos (1,) int64 on the device, or
// null. All contiguous and 16-byte aligned; d and I multiples of 8.
extern "C" int mt_routed_experts(const void* x, const void* ids, const void* weights,
                                 const void* gate, const void* up, const void* down,
                                 const void* sgate, const void* sup, const void* sdown,
                                 void* hidden, void* out, int64_t B, int64_t K, int64_t n_shared,
                                 int64_t E, int64_t I, int64_t d, int64_t layer, void* counts,
                                 void* routes, const void* pos, int64_t S, void* stream) {
  if (B < 1 || B > 65535 || K < 0 || n_shared < 0 || K + n_shared < 1 ||
      K + n_shared > 65535 || E < 1 || I < 8 || I % 8 || d < 8 || d % 8 || layer < 0 ||
      (n_shared > 0 && (sgate == nullptr || sup == nullptr || sdown == nullptr)) ||
      (routes != nullptr && (pos == nullptr || S < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.ids = static_cast<const int64_t*>(ids);
  a.weights = static_cast<const float*>(weights);
  a.gate = static_cast<const __nv_bfloat16*>(gate);
  a.up = static_cast<const __nv_bfloat16*>(up);
  a.down = static_cast<const __nv_bfloat16*>(down);
  a.sgate = static_cast<const __nv_bfloat16*>(sgate);
  a.sup = static_cast<const __nv_bfloat16*>(sup);
  a.sdown = static_cast<const __nv_bfloat16*>(sdown);
  a.hidden = static_cast<float*>(hidden);
  a.out = static_cast<float*>(out);
  a.counts = static_cast<int*>(counts);
  a.routes = static_cast<int*>(routes);
  a.pos = static_cast<const int64_t*>(pos);
  a.S = S;
  a.B = B;
  a.K = K;
  a.n_shared = n_shared;
  a.E = E;
  a.I = I;
  a.d = d;
  a.layer = layer;
  const int64_t x_bytes = 4 * d;
  const int64_t h_bytes = 4 * (K + n_shared) * I;
  if (x_bytes > kMaxSmem || h_bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static int64_t opted_gate_up[kMaxDevices] = {};
  static int64_t opted_down[kMaxDevices] = {};
  cudaError_t err = opt_in(expert_gate_up_kernel, x_bytes, opted_gate_up);
  if (err == cudaSuccess) err = opt_in(expert_down_kernel, h_bytes, opted_down);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid1(static_cast<unsigned>((I + kWarps - 1) / kWarps),
                   static_cast<unsigned>(K + n_shared), static_cast<unsigned>(B));
  expert_gate_up_kernel<<<grid1, 32 * kWarps, static_cast<size_t>(x_bytes), st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2(static_cast<unsigned>((d + kWarps - 1) / kWarps), static_cast<unsigned>(B));
  expert_down_kernel<<<grid2, 32 * kWarps, static_cast<size_t>(h_bytes), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mt_routed_experts_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
