// The router of a mixture-of-experts layer in the Moonlight decoder's
// decode step on Hopper (DeepSeek-V3's noaux_tc gate over one group), in
// one launch: for each token row t of h (T, d) bf16 and the gate's
// weight (E, d) bf16 and correction bias (E,) bf16, in f32,
//
//   logit[t, e]  = h[t] . W[e]
//   score[t, e]  = sigmoid(logit[t, e])                 1 / (1 + exp(-x))
//   choice[t, e] = score[t, e] + bias[e]
//   ids[t, :]    = the K experts of highest choice, in descending order
//                  of choice, an equal choice going to the lower expert
//   weights[t,k] = score[t, ids[t, k]] / (sum over k + 1e-20) * scale
//                  (without the division where norm is 0)
//
// the ids int64 and the weights f32 (T, K), as ops/experts.py's kernel
// reads them (ops/router.py::route_reference is the same function in plain
// PyTorch).
//
// It replaces no TPU kernel: the JAX package has no expert layer. The
// step ran the router as twelve eager launches a MoE layer (the weight
// cast to f32, an f32 cuBLAS product, sigmoid, the bias, a two-kernel
// top-k, a gather, the normalisation), each a few microseconds of launch
// for 64 values. What the router must read is the 256 KB bf16 weight
// (0.08 us at 3.35 TB/s) and T rows of h, so latency bounds it, not bytes:
// one launch that reads W once, with few dependent steps and little code
// on its path, and nothing in device memory but the outputs:
//   * one cluster of 8 blocks, 8 warps a block, a warp an expert (64
//     experts; E < 64 leaves warps idle). Each warp's loads of its row of
//     W (16-byte streaming loads, eight a lane in flight) go out first;
//     then h's T rows are copied into shared memory (cp.async, all at
//     once); the lane's chunks of W, widened to f32 once, are dotted with
//     each row in a loop over the rows (a loop keeps the code a few cache
//     lines: unrolled over 16 rows, a call took 7.2 us at T = 1 against
//     5.0), the lanes' sums meet in shared memory and lane t adds row t's
//     in lane order;
//   * lane t writes row t's logit into block 0's shared memory
//     (distributed shared memory; every block has arrived at the cluster's
//     barrier at its start, and waits on it before writing), then the
//     cluster's barrier; the other blocks end;
//   * block 0, a warp a row: each lane takes experts lane and lane + 32,
//     scores and choices; an expert's place is how many of the E choices
//     come before it (higher choice, then lower id), counted against the
//     row's choices in shared memory; the first K places give the ids in
//     order, their scores summed in that order.
//   No atomics and no second launch; every sum runs in one fixed order, so
//   two calls, and a graph replay and the eager call, are equal bit for
//   bit. Against the plain version the logits' sums run in another order
//   than cuBLAS's, so a choice that lies within f32 rounding of the next
//   may differ; the products (bf16 x bf16) and the widening are exact.
// On the H100 a call takes 4.7 us at T = 1 (1.0 of it a launch of an empty
// kernel, 1.4 the product, 0.9 the exchange and the cluster's barrier, 1.3
// the choosing) and 17 us at T = 16 (PERF.md). The kernel before it in
// the step is the post-attention RMSNorm, which does not let dependents
// start early, so it is not launched as a programmatic dependent.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;                      // blocks of the one cluster
constexpr int kWarps = 8;                        // warps a block: an expert each
constexpr int kMaxExperts = kCluster * kWarps;   // 64
constexpr int kMaxRows = 16;                     // token rows of h
constexpr int kMaxChosen = 32;                   // experts a token chooses
constexpr int kInFlight = 8;                     // 16-byte loads of W a lane in flight
constexpr int kMaxDevices = 64;
constexpr int kMaxStage = 160 * 1024;            // bytes of h a block stages

struct Args {
  const __nv_bfloat16* h;      // (T, d)
  const __nv_bfloat16* w;      // (E, d)
  const __nv_bfloat16* bias;   // (E,)
  int64_t* ids;                // (T, K)
  float* weights;              // (T, K)
  int T, E, K, d;
  int norm;
  float scale;
};

__device__ __forceinline__ float lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// acc + the 8 bf16 of h dotted with the 8 f32 of wf.
__device__ __forceinline__ float dot8(uint4 h, const float (&wf)[8], float acc) {
  acc = fmaf(lo(h.x), wf[0], acc);
  acc = fmaf(hi(h.x), wf[1], acc);
  acc = fmaf(lo(h.y), wf[2], acc);
  acc = fmaf(hi(h.y), wf[3], acc);
  acc = fmaf(lo(h.z), wf[4], acc);
  acc = fmaf(hi(h.z), wf[5], acc);
  acc = fmaf(lo(h.w), wf[6], acc);
  acc = fmaf(hi(h.w), wf[7], acc);
  return acc;
}

// 16 bytes from global src to shared dst, asynchronously.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Wait until this thread's asynchronous copies have landed.
__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The cluster's barrier in two halves: this thread's arrival (ordering
// nothing), then the wait for every thread of the cluster to arrive.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Whether candidate (ka, ia) comes before (kb, ib): the higher choice, then
// the lower expert.
__device__ __forceinline__ int before(float ka, int ia, float kb, int ib) {
  return static_cast<int>(ka > kb) | (static_cast<int>(ka == kb) & static_cast<int>(ia < ib));
}

// grid: one cluster of kCluster blocks; warp w of block r computes the
// logits of expert r * kWarps + w and writes them into block 0's shared
// memory; block 0 then chooses, a warp a row.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(32 * kWarps)
    router_gemv_topk_kernel(const Args a) {
  extern __shared__ __align__(16) uint4 hs[];           // (T, d / 8) chunks of h
  __shared__ float part[kWarps][kMaxRows][33];         // a warp's lanes' sums (33: no conflicts)
  __shared__ float logits[kMaxRows][kMaxExperts];       // block 0's: every expert's
  __shared__ __align__(16) float keys[kWarps][kMaxExperts];   // a warp's row: its choices
  __shared__ int chosen[kWarps][kMaxChosen];            //   and its top K, in order
  __shared__ float chosen_score[kWarps][kMaxChosen];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunks = a.d / 8;
  const int e = rank * kWarps + warp;
  const bool live = e < a.E;
  const uint4* row =
      reinterpret_cast<const uint4*>(a.w) + static_cast<int64_t>(live ? e : 0) * chunks;
  cluster_arrive_relaxed();   // this block has started (waited on before block 0 is written)
  // W's first chunks, and block 0's bias, in flight before h is staged
  uint4 wv[kInFlight];
#pragma unroll
  for (int j = 0; j < kInFlight; ++j) {
    const int c = j * 32 + lane;
    wv[j] = live && c < chunks ? __ldcs(row + c) : make_uint4(0u, 0u, 0u, 0u);
  }
  float bias[2] = {0.f, 0.f};
  if (rank == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (lane + 32 * i < a.E) bias[i] = __bfloat162float(a.bias[lane + 32 * i]);
    }
  }
  // h's rows into shared memory, every thread's copies in flight at once
  const uint4* hg = reinterpret_cast<const uint4*>(a.h);
  for (int i = tid; i < a.T * chunks; i += 32 * kWarps) copy16(hs + i, hg + i);
  copies_done();
  __syncthreads();
  // a row at a time (a loop, so the code stays a few cache lines however
  // many rows): the lane's eight chunks of W, widened once, against the
  // row's chunks in shared memory, in four sums; the lanes' sums meet in
  // shared memory and lane t adds row t's 32 in lane order
  float mine = 0.f;   // lane t: row t's logit
  for (int c0 = 0; c0 < chunks; c0 += 32 * kInFlight) {
    if (c0 > 0) {
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        const int c = c0 + j * 32 + lane;
        wv[j] = live && c < chunks ? __ldcs(row + c) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    float wf[kInFlight][8];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      wf[j][0] = lo(wv[j].x), wf[j][1] = hi(wv[j].x), wf[j][2] = lo(wv[j].y);
      wf[j][3] = hi(wv[j].y), wf[j][4] = lo(wv[j].z), wf[j][5] = hi(wv[j].z);
      wf[j][6] = lo(wv[j].w), wf[j][7] = hi(wv[j].w);
    }
    for (int t = 0; t < a.T; ++t) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        const int c = c0 + j * 32 + lane;
        if (c < chunks) acc[j % 4] = dot8(hs[t * chunks + c], wf[j], acc[j % 4]);
      }
      part[warp][t][lane] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
    __syncwarp();
    if (lane < a.T) {
      float s = 0.f;
      for (int l = 0; l < 32; ++l) s += part[warp][lane][l];
      mine += s;
    }
    __syncwarp();
  }
  cluster_wait();   // every block has started: block 0's shared memory is there
  if (live && lane < a.T) *cluster.map_shared_rank(&logits[lane][e], 0) = mine;
  cluster.sync();   // every logit written into block 0 and visible there
  if (rank != 0) return;
  for (int t = warp; t < a.T; t += kWarps) {
    // lane takes experts lane and lane + 32: score, choice
    // (past E: a choice of minus infinity, after every expert's)
    float score[2], key[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = lane + 32 * i;
      score[i] = 0.f;
      if (id < a.E) {
        score[i] = 1.f / (1.f + expf(-logits[t][id]));
        key[i] = score[i] + bias[i];
        if (isnan(key[i])) key[i] = INFINITY;   // a NaN choice first, as torch.topk has it
      }
      keys[warp][id] = key[i];
    }
    __syncwarp();
    // a candidate's place: how many come before it (a total order, so the
    // places of the E candidates are 0 .. E - 1, each once)
    int place[2] = {0, 0};
#pragma unroll 4
    for (int j = 0; j < kMaxExperts; j += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(&keys[warp][j]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int id = lane + 32 * i;
        place[i] += before(k4.x, j, key[i], id) + before(k4.y, j + 1, key[i], id) +
                    before(k4.z, j + 2, key[i], id) + before(k4.w, j + 3, key[i], id);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (lane + 32 * i < a.E && place[i] < a.K) {
        chosen[warp][place[i]] = lane + 32 * i;
        chosen_score[warp][place[i]] = score[i];
      }
    }
    __syncwarp();
    if (lane < a.K) {
      float sum = 0.f;   // the chosen scores in the order chosen
      for (int k = 0; k < a.K; ++k) sum += chosen_score[warp][k];
      const float s = chosen_score[warp][lane];
      const float w = a.norm ? s / (sum + 1e-20f) : s;
      a.ids[t * a.K + lane] = chosen[warp][lane];
      a.weights[t * a.K + lane] = w * a.scale;
    }
    __syncwarp();   // the row's scratch is read before the next row writes it
  }
}

}  // namespace

// C interface, loaded with ctypes; returns the CUDA error of the launch (0
// on success). bf16 h (T, d) with 1 <= T <= 16, w (E, d) with 1 <= E <= 64,
// bias (E,); int64 ids and f32 weights (T, K) with 1 <= K <= min(E, 32); h
// and w contiguous and 16-byte aligned, d a multiple of 8 with T d 2 bytes
// at most 160 KiB. norm: 0 or 1; scale multiplies every weight.
extern "C" int mt_router(const void* h, const void* w, const void* bias, void* ids, void* weights,
                         int64_t T, int64_t E, int64_t K, int64_t d, int norm, float scale,
                         void* stream) {
  if (T < 1 || T > kMaxRows || E < 1 || E > kMaxExperts || K < 1 || K > E || K > kMaxChosen ||
      d < 8 || d % 8 != 0 || T * d * 2 > kMaxStage || h == nullptr || w == nullptr ||
      bias == nullptr || ids == nullptr || weights == nullptr ||
      ((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(w)) & 15u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.h = static_cast<const __nv_bfloat16*>(h);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const __nv_bfloat16*>(bias);
  a.ids = static_cast<int64_t*>(ids);
  a.weights = static_cast<float*>(weights);
  a.T = static_cast<int>(T);
  a.E = static_cast<int>(E);
  a.K = static_cast<int>(K);
  a.d = static_cast<int>(d);
  a.norm = norm != 0;
  a.scale = scale;
  const int smem = static_cast<int>(T * d * 2);
  static bool opted[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted[device]) {
    err = cudaFuncSetAttribute(router_gemv_topk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxStage);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[device] = true;
  }
  router_gemv_topk_kernel<<<kCluster, 32 * kWarps, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mt_router_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
