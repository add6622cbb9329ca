// K5 on Hopper: one whole decode step of the OPT stack in one launch.
//
// Replaces the TPU kernel
//   meshanything_tpu/ops/megakernel.py::_megakernel
// (reached through decode_step_megakernel from the decode step of
// models/shape_opt.py with attn="megakernel"). For every layer it computes
//   qkv = bf16(x) . Wqkv + b;  q = qkv[:D] / sqrt(hd);  K/V rows -> cache[write_pos]
//   o   = softmax(q . K[s < cur_len]) . V          (per head, f32)
//   x   = LN(x + (bf16(o) . Wout + b))
//   x   = LN(x + (bf16(relu(bf16(x) . W1 + b1)) . W2 + b2))
// over the cache laid out as (2, L, B, S, D), K at plane 0, V at plane 1.
// The residual stream stays in f32 across all layers and is cast to x's
// dtype once at the end; products take bf16 operands and accumulate in
// f32; biases and LayerNorm affines are f32.
//
// What bounds it on this card: bytes. A step reads the 24 layers' bf16
// weights once (604 MB at the 350M width) plus the live K/V rows
// (2 * L * B * cur_len * D * sizeof(cache)), far below the H100's ~295
// flops/byte balance point at B <= 16.
//
// What the design does about it:
//   * one persistent cooperative launch (grid = resident blocks, one a SM
//     at the full width); six grid-wide barriers a layer separate
//       (1) the QKV GEMV with the K/V row append,
//       (2) attention partials over (b, h, context split) work items,
//       (3) the combine into o,
//       (4) the out projection + bias + residual,
//       (5) LayerNorm and fc1 + bias + ReLU,
//       (6) fc2 + bias + residual (its LayerNorm runs at the start of the
//           next layer's phase 1, or at the end);
//   * weights are stored (L, out, in), so a warp streams contiguous 512-wide
//     row slices with 16-byte loads, all of a block's share in flight at
//     once, and every row of a batch group (G = 1, 2 or 16 rows, one
//     kernel instance each, staged in shared memory as bf16) shares that
//     load: the weights leave HBM once a step for B <= 16, and B=1 carries
//     one accumulator, not 16 (B=1 and B=2 are the measured single-request
//     and two-mesh batches; every other B runs groups of 16);
//   * attention reads only rows < cur_len; a masked row is never loaded,
//     so NaN past cur_len cannot reach the output;
//   * data written inside the launch (scratch, the new K/V rows) is read
//     with ld.global.cg (L2, coherent), never through the read-only path;
//   * all offsets are 64-bit: a B=16 bf16 cache plane is 6 GB.
// The kernel allocates nothing and does not synchronise; the Python
// wrapper allocates the f32 scratch and the output.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroup = 16;     // batch rows a GEMV pass serves from shared memory
constexpr int kSliceVecs = 64;    // 16-byte vectors (512 bf16) in a GEMV item's K slice
constexpr int kChunkItems = 64;   // GEMV items a block reduces through shared memory
constexpr int kMaxWidth = 1024;   // hidden size: the layer norm keeps a row in registers
static_assert(kMaxGroup <= kWarps, "the layer norm runs one warp per row of a group");
static_assert(kSliceVecs == 64, "a lane holds two vectors of a slice");

struct Params {
  const void* x;                 // (B, D) f32 or bf16
  void* x_out;                   // (B, D) x's dtype
  void* kv;                      // (2, L, B, S, D) f32 or bf16, rows written in place
  const __nv_bfloat16* qkv_w;    // (L, 3D, D)
  const __nv_bfloat16* out_w;    // (L, D, D)
  const __nv_bfloat16* fc1_w;    // (L, F, D)
  const __nv_bfloat16* fc2_w;    // (L, D, F)
  const float* qkv_b;            // (L, 3D)
  const float* out_b;            // (L, D)
  const float* fc1_b;            // (L, F)
  const float* fc2_b;            // (L, D)
  const float* ln_a_w;           // (L, D) attention LayerNorm scale
  const float* ln_a_b;
  const float* ln_f_w;           // (L, D) FFN LayerNorm scale
  const float* ln_f_b;
  // f32 scratch, written and read inside the launch
  float* xs;                     // (B, D) residual stream
  float* q;                      // (B, D) scaled queries
  float* o;                      // (B, D) attention output
  float* y;                      // (B, D) pre-LayerNorm sums
  float* h1;                     // (B, F) ReLU(fc1)
  float* o_part;                 // (B*H*nsplit, hd) unnormalized partial outputs
  float* ml_part;                // (B*H*nsplit, 2) running max and sum
  int64_t B, L, S, D, F, H, write_pos, cur_len, rows_per_split, nsplit, act_bytes;
  int x_bf16, head_dim;
  float ln_eps, scale;
};

enum Epilogue { kQkv, kOut, kFc1, kFc2 };

__device__ __forceinline__ void bf16x8_to_float(const uint4& v, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 16-byte vectors of cache rows (read through L2 as uint4: the new row was
// written by another block in this launch), unpacked to f32.
template <typename T>
struct CacheVec;
template <>
struct CacheVec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& v, float* out) {
    out[0] = __uint_as_float(v.x);
    out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z);
    out[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};
template <>
struct CacheVec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& v, float* out) {
    bf16x8_to_float(v, out);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
};

template <typename TC>
__device__ __forceinline__ void epilogue(const Params& p, int kind, int64_t layer, int64_t n,
                                         int64_t b, float s) {
  const int64_t D = p.D;
  switch (kind) {
    case kQkv: {
      const float v = s + p.qkv_b[layer * 3 * D + n];
      if (n < D) {
        p.q[b * D + n] = v * p.scale;   // q is scaled before the dot
      } else {
        const int64_t plane = n < 2 * D ? 0 : 1;
        const int64_t col = n - (1 + plane) * D;
        TC* kv = static_cast<TC*>(p.kv);
        CacheVec<TC>::store(kv + (((plane * p.L + layer) * p.B + b) * p.S + p.write_pos) * D + col,
                            v);
      }
      break;
    }
    case kOut:
      p.y[b * D + n] = __ldcg(p.xs + b * D + n) + (s + p.out_b[layer * D + n]);
      break;
    case kFc1:
      p.h1[b * p.F + n] = fmaxf(s + p.fc1_b[layer * p.F + n], 0.f);
      break;
    default:  // kFc2
      p.y[b * D + n] = __ldcg(p.xs + b * D + n) + (s + p.fc2_b[layer * D + n]);
      break;
  }
}

// Slices of K a GEMV output row is cut into: 512-wide slices where K is a
// multiple of 512, else one slice of K <= 512 (checked by the host).
__device__ __forceinline__ int k_slices(int64_t K) {
  return K % (8 * kSliceVecs) == 0 ? static_cast<int>(K / (8 * kSliceVecs)) : 1;
}

// out[b, n] = act[b] . W[n] for the nb <= G rows of the group staged in
// `act` (bf16, row stride K) and every output n < N, then the epilogue.
// Block i owns a contiguous range of output rows; an item is one (row, K
// slice), and a warp first issues the weight loads of all its items (up to
// PASS, two 16-byte loads a lane each), so one HBM round trip serves the
// block's share of the matrix. The slices' partial sums meet in shared
// memory (red: kChunkItems x G) and are added in a fixed order.
template <typename TC, int G>
__device__ void gemv(const Params& p, int kind, int64_t layer, const __nv_bfloat16* W,
                     int64_t N, int64_t K, const __nv_bfloat16* act, int nb, int64_t g0,
                     float* red) {
  constexpr int PASS = G > 2 ? 2 : 4;   // G accumulators and 8 * PASS load registers a lane
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ks = k_slices(K);
  const int64_t kslice = K / ks;
  const int nvec = static_cast<int>(kslice / 8);
  const int64_t per_block = (N + gridDim.x - 1) / gridDim.x;
  const int64_t r_begin = blockIdx.x * per_block;
  const int64_t r_end = r_begin + per_block < N ? r_begin + per_block : N;
  const int chunk_rows = kChunkItems / ks;
  for (int64_t c0 = r_begin; c0 < r_end; c0 += chunk_rows) {
    const int rows = static_cast<int>(r_end - c0 < chunk_rows ? r_end - c0 : chunk_rows);
    const int items = rows * ks;
    int pass = (items + kWarps - 1) / kWarps;
    pass = pass < PASS ? pass : PASS;
    for (int i0 = warp * pass; i0 < items; i0 += kWarps * pass) {
      uint4 w[PASS][2];
#pragma unroll
      for (int u = 0; u < PASS; ++u) {
        const int it = i0 + u;
        const uint4* wrow =
            reinterpret_cast<const uint4*>(W + (c0 + it / ks) * K + (it % ks) * kslice);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int v = lane + 32 * h;
          if (u < pass && it < items && v < nvec) w[u][h] = __ldg(wrow + v);  // never written
        }
      }
#pragma unroll
      for (int u = 0; u < PASS; ++u) {
        const int it = i0 + u;
        if (u < pass && it < items) {   // the same for every lane of the warp
          const __nv_bfloat16* arow = act + (it % ks) * kslice;
          float acc[G];
#pragma unroll
          for (int b = 0; b < G; ++b) acc[b] = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int v = lane + 32 * h;
            if (v < nvec) {
              float wf[8];
              bf16x8_to_float(w[u][h], wf);
#pragma unroll
              for (int b = 0; b < G; ++b) {
                if (b < nb) {
                  float af[8];
                  bf16x8_to_float(*reinterpret_cast<const uint4*>(arow + b * K + v * 8), af);
#pragma unroll
                  for (int e = 0; e < 8; ++e) acc[b] = fmaf(wf[e], af[e], acc[b]);
                }
              }
            }
          }
#pragma unroll
          for (int b = 0; b < G; ++b) {
            if (b < nb) {
              const float sum = warp_sum(acc[b]);
              if (lane == 0) red[it * G + b] = sum;
            }
          }
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * nb; i += kThreads) {
      const int r = i / nb;
      const int b = i % nb;
      float sum = 0.f;
      for (int j = 0; j < ks; ++j) sum += red[(r * ks + j) * G + b];
      epilogue<TC>(p, kind, layer, c0 + r, g0 + b, sum);
    }
    __syncthreads();  // red is rewritten by the next chunk
  }
}

// Per-instance choices, measured on the H100 (tools/k5_breakdown.py): for groups
// of 1-2 rows the layer norm runs as a call of its own with every load
// ahead of the first store, and attention keeps two passes of K/V in
// flight; groups of 16 inline the layer norm, load its affine at the
// store, and keep four passes (otherwise ptxas spills).
template <int G>
struct Tuning {
  static constexpr bool kSmall = G <= 2;
  static constexpr int kRowUnroll = kSmall ? 2 : 4;
};

// One warp per row of the group: LayerNorm (f32 statistics) of rows
// [g0, g0 + nb) of src (B, D), the row held in registers (D <= kMaxWidth).
// The result goes to `act` (bf16, the next GEMV's input) and, where given,
// to the f32 residual stream `dst` and to the step's output `out` (x's
// dtype). HOIST: read the affine before the first store.
template <bool HOIST>
__device__ __forceinline__ void layer_norm_body(const Params& p, const float* src, const float* w,
                                                const float* bias, int64_t g0, int nb,
                                                __nv_bfloat16* act, float* dst, void* out) {
  constexpr int kPerLane = kMaxWidth / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= nb) return;
  const int64_t D = p.D;
  const int64_t r = g0 + warp;
  const float* row = src + r * D;
  float x[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int64_t c = lane + 32 * i;
    x[i] = c < D ? __ldcg(row + c) : 0.f;
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) s += x[i];
  const float mean = warp_sum(s) / static_cast<float>(D);
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const float t = lane + 32 * i < D ? x[i] - mean : 0.f;
    v = fmaf(t, t, v);
  }
  const float inv = rsqrtf(warp_sum(v) / static_cast<float>(D) + p.ln_eps);
  if (HOIST) {   // every load before the first store, which the compiler cannot move them past
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int64_t c = lane + 32 * i;
      if (c < D) x[i] = (x[i] - mean) * inv * __ldg(w + c) + __ldg(bias + c);
    }
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int64_t c = lane + 32 * i;
    if (c >= D) continue;
    const float val = HOIST ? x[i] : (x[i] - mean) * inv * __ldg(w + c) + __ldg(bias + c);
    if (act != nullptr) act[warp * D + c] = __float2bfloat16(val);
    if (dst != nullptr) dst[r * D + c] = val;
    if (out != nullptr) {
      if (p.x_bf16) {
        static_cast<__nv_bfloat16*>(out)[r * D + c] = __float2bfloat16(val);
      } else {
        static_cast<float*>(out)[r * D + c] = val;
      }
    }
  }
}

__device__ __noinline__ void layer_norm_call(const Params& p, const float* src, const float* w,
                                            const float* bias, int64_t g0, int nb,
                                            __nv_bfloat16* act, float* dst, void* out) {
  layer_norm_body<true>(p, src, w, bias, g0, nb, act, dst, out);
}

template <int G>
__device__ __forceinline__ void layer_norm_rows(const Params& p, const float* src,
                                                const float* w, const float* bias, int64_t g0,
                                                int nb, __nv_bfloat16* act, float* dst,
                                                void* out) {
  if (Tuning<G>::kSmall) {
    layer_norm_call(p, src, w, bias, g0, nb, act, dst, out);
  } else {
    layer_norm_body<false>(p, src, w, bias, g0, nb, act, dst, out);
  }
}

// Layer 0's input: x (x's dtype) -> bf16 GEMV input, and (block 0) the f32
// residual stream.
__device__ void stage_input(const Params& p, int64_t g0, int nb, __nv_bfloat16* act) {
  const int64_t n = nb * p.D;
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    const int64_t gi = g0 * p.D + i;
    const float v = p.x_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.x)[gi])
                             : static_cast<const float*>(p.x)[gi];
    act[i] = __float2bfloat16(v);
    if (blockIdx.x == 0) p.xs[gi] = v;
  }
}

// Rows [g0, g0 + nb) of an f32 scratch matrix (row width K, K % 4 == 0)
// -> bf16 GEMV input.
__device__ void stage_rows(const float* src, int64_t K, int64_t g0, int nb,
                           __nv_bfloat16* act) {
  const int64_t n = nb * K;
  for (int64_t i = 4 * threadIdx.x; i < n; i += 4 * kThreads) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(src + g0 * K + i));
    __nv_bfloat162* a = reinterpret_cast<__nv_bfloat162*>(act + i);
    a[0] = __floats2bfloat162_rn(v.x, v.y);
    a[1] = __floats2bfloat162_rn(v.z, v.w);
  }
}

// Phase 2: work item (b, h, split) -> the unnormalized f32 output, the max
// and the sum of rows [split * rows_per_split, min(cur_len, ...)). TPR
// lanes cover one head row (head_dim 8 or 64, checked by the host); the
// warp's RPP row groups each keep an online softmax and merge at the end.
template <typename TC, int kRowUnroll>
__device__ void attention_partials(const Params& p, int64_t layer) {
  constexpr int VEC = CacheVec<TC>::N;   // kRowUnroll passes in flight: raw 16-byte K and V
  const int HD = p.head_dim;
  const int TPR = HD / VEC;
  const int RPP = 32 / TPR;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane % TPR;
  const int r0 = lane / TPR;
  const int64_t D = p.D;
  const int64_t items = p.B * p.H * p.nsplit;
  const TC* kv = static_cast<const TC*>(p.kv);
  for (int64_t item = static_cast<int64_t>(blockIdx.x) * kWarps + warp; item < items;
       item += static_cast<int64_t>(gridDim.x) * kWarps) {
    const int64_t bh = item / p.nsplit;
    const int64_t split = item % p.nsplit;
    const int64_t b = bh / p.H;
    const int64_t h = bh % p.H;
    const int64_t start = split * p.rows_per_split;
    const int64_t stop = start + p.rows_per_split;
    const int64_t end = stop < p.cur_len ? stop : p.cur_len;
    float qf[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) qf[e] = __ldcg(p.q + b * D + h * HD + g * VEC + e);
    const int64_t k_base = ((layer * p.B + b) * p.S) * D + h * HD + g * VEC;
    const int64_t v_base = k_base + p.L * p.B * p.S * D;

    float m = -INFINITY;
    float l = 0.f;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

    for (int64_t t0 = start; t0 < end; t0 += RPP * kRowUnroll) {
      uint4 kr[kRowUnroll];
      uint4 vr[kRowUnroll];
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const int64_t row = t0 + u * RPP + r0;
        if (row < end) {
          kr[u] = __ldcg(reinterpret_cast<const uint4*>(kv + k_base + row * D));
          vr[u] = __ldcg(reinterpret_cast<const uint4*>(kv + v_base + row * D));
        }
      }
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const int64_t row = t0 + u * RPP + r0;
        float dot = 0.f;
        if (row < end) {
          float kf[VEC];
          CacheVec<TC>::unpack(kr[u], kf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot = fmaf(qf[e], kf[e], dot);
        }
        for (int off = TPR / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (row < end) {   // a row past `end` is skipped by selection, never weighted by 0
          float vf[VEC];
          CacheVec<TC>::unpack(vr[u], vf);
          const float m_new = fmaxf(m, dot);
          const float corr = expf(m - m_new);   // 0 on the group's first row
          const float pr = expf(dot - m_new);
          l = fmaf(l, corr, pr);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = fmaf(acc[e], corr, pr * vf[e]);
          m = m_new;
        }
      }
    }
    // merge the RPP row groups of the warp
    for (int off = TPR; off < 32; off <<= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
      const float m_new = fmaxf(m, m_o);
      const float a = m == -INFINITY ? 0.f : expf(m - m_new);
      const float c = m_o == -INFINITY ? 0.f : expf(m_o - m_new);
      l = l * a + l_o * c;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[e], off);
        acc[e] = acc[e] * a + acc_o * c;
      }
      m = m_new;
    }
    if (r0 == 0) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) p.o_part[item * HD + g * VEC + e] = acc[e];
    }
    if (lane == 0) {
      p.ml_part[2 * item] = m;
      p.ml_part[2 * item + 1] = l;
    }
  }
}

// Phase 3: one warp per (b, h): rescale the splits to the global max and
// normalize, o = acc / max(l, 1e-30). The lanes first take a split each
// (max, weight, sum), then each lane owns HD / 32 output columns and walks
// the splits with the weights broadcast from their lanes.
__device__ void combine(const Params& p) {
  constexpr int DPL = 2;                // output columns a lane owns: head_dim <= 64
  const int HD = p.head_dim;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t pairs = p.B * p.H;
  const int64_t nsplit = p.nsplit;
  for (int64_t bh = static_cast<int64_t>(blockIdx.x) * kWarps + warp; bh < pairs;
       bh += static_cast<int64_t>(gridDim.x) * kWarps) {
    const float* ml = p.ml_part + 2 * bh * nsplit;
    const float* part = p.o_part + bh * nsplit * HD;
    float m = -INFINITY;
    for (int64_t s = lane; s < nsplit; s += 32) m = fmaxf(m, __ldcg(ml + 2 * s));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    float o[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[e] = 0.f;
    for (int64_t s0 = 0; s0 < nsplit; s0 += 32) {
      const int64_t s = s0 + lane;
      const float ms = s < nsplit ? __ldcg(ml + 2 * s) : -INFINITY;
      const float w = ms == -INFINITY ? 0.f : expf(ms - m);   // a split past cur_len: 0
      if (s < nsplit) l = fmaf(__ldcg(ml + 2 * s + 1), w, l);
      const int count = static_cast<int>(nsplit - s0 < 32 ? nsplit - s0 : 32);
#pragma unroll 8
      for (int j = 0; j < count; ++j) {
        const float wj = __shfl_sync(0xffffffffu, w, j);
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          const int d = lane + 32 * e;
          if (d < HD) o[e] = fmaf(__ldcg(part + (s0 + j) * HD + d), wj, o[e]);
        }
      }
    }
    l = warp_sum(l);
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      // (b, h, d) is row b, column h * HD + d
      if (d < HD) p.o[bh * HD + d] = o[e] / fmaxf(l, 1e-30f);
    }
  }
}

// G: batch rows a GEMV pass serves (the group); groups of G rows cover B.
template <typename TC, int G>
__global__ void __launch_bounds__(kThreads, 1) megakernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem);   // (G, max(D, F))
  float* red = reinterpret_cast<float*>(smem + p.act_bytes);      // (kChunkItems, G)
  cg::grid_group grid = cg::this_grid();
  const int64_t D = p.D;
  const int64_t F = p.F;
  float* const xs_writer = blockIdx.x == 0 ? p.xs : nullptr;

  for (int64_t layer = 0; layer < p.L; ++layer) {
    // (1) the previous layer's FFN LayerNorm (or the input), QKV, K/V append
    for (int64_t g0 = 0; g0 < p.B; g0 += G) {
      const int nb = static_cast<int>(p.B - g0 < G ? p.B - g0 : G);
      if (layer == 0) {
        stage_input(p, g0, nb, act);
      } else {
        layer_norm_rows<G>(p, p.y, p.ln_f_w + (layer - 1) * D, p.ln_f_b + (layer - 1) * D, g0, nb,
                        act, xs_writer, nullptr);
      }
      __syncthreads();
      gemv<TC, G>(p, kQkv, layer, p.qkv_w + layer * 3 * D * D, 3 * D, D, act, nb, g0, red);
      __syncthreads();
    }
    grid.sync();
    // (2) attention partials over the live rows, the new row included
    attention_partials<TC, Tuning<G>::kRowUnroll>(p, layer);
    grid.sync();
    // (3) combine
    combine(p);
    grid.sync();
    // (4) out projection + bias + residual
    for (int64_t g0 = 0; g0 < p.B; g0 += G) {
      const int nb = static_cast<int>(p.B - g0 < G ? p.B - g0 : G);
      stage_rows(p.o, D, g0, nb, act);
      __syncthreads();
      gemv<TC, G>(p, kOut, layer, p.out_w + layer * D * D, D, D, act, nb, g0, red);
      __syncthreads();
    }
    grid.sync();
    // (5) attention LayerNorm, fc1 + bias + ReLU
    for (int64_t g0 = 0; g0 < p.B; g0 += G) {
      const int nb = static_cast<int>(p.B - g0 < G ? p.B - g0 : G);
      layer_norm_rows<G>(p, p.y, p.ln_a_w + layer * D, p.ln_a_b + layer * D, g0, nb, act,
                      xs_writer, nullptr);
      __syncthreads();
      gemv<TC, G>(p, kFc1, layer, p.fc1_w + layer * F * D, F, D, act, nb, g0, red);
      __syncthreads();
    }
    grid.sync();
    // (6) fc2 + bias + residual
    for (int64_t g0 = 0; g0 < p.B; g0 += G) {
      const int nb = static_cast<int>(p.B - g0 < G ? p.B - g0 : G);
      stage_rows(p.h1, F, g0, nb, act);
      __syncthreads();
      gemv<TC, G>(p, kFc2, layer, p.fc2_w + layer * D * F, D, F, act, nb, g0, red);
      __syncthreads();
    }
    grid.sync();
  }
  // the last FFN LayerNorm, cast to x's dtype
  if (blockIdx.x == 0) {
    for (int64_t g0 = 0; g0 < p.B; g0 += G) {
      const int nb = static_cast<int>(p.B - g0 < G ? p.B - g0 : G);
      layer_norm_rows<G>(p, p.y, p.ln_f_w + (p.L - 1) * D, p.ln_f_b + (p.L - 1) * D, g0, nb,
                      nullptr, nullptr, p.x_out);
    }
  }
}

template <typename TC, int G>
cudaError_t resident_blocks(int64_t smem_bytes, int* blocks) {
  const void* fn = reinterpret_cast<const void*>(&megakernel<TC, G>);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      static_cast<size_t>(smem_bytes));
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

template <typename TC, int G>
cudaError_t launch(const Params& p, int64_t blocks, int64_t smem_bytes, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(&megakernel<TC, G>);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  Params args = p;
  void* kernel_args[] = {&args};
  // every block must be resident for the grid barriers: a grid larger than
  // the occupancy allows is refused here (cudaErrorCooperativeLaunchTooLarge)
  err = cudaLaunchCooperativeKernel(fn, dim3(static_cast<unsigned>(blocks)), dim3(kThreads),
                                    kernel_args, static_cast<size_t>(smem_bytes), stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// cache_fmt: 0 = float32, 1 = bfloat16; group: 1, 2 or 16 batch rows.
#define MT_DISPATCH_G(CALL, TC)                                             \
  switch (group) {                                                          \
    case 1: return CALL(TC, 1);                                             \
    case 2: return CALL(TC, 2);                                             \
    case 16: return CALL(TC, 16);                                           \
    default: return static_cast<int>(cudaErrorInvalidValue);               \
  }
#define MT_DISPATCH(CALL)                                                   \
  if (cache_fmt == 0) MT_DISPATCH_G(CALL, float)                            \
  if (cache_fmt == 1) MT_DISPATCH_G(CALL, __nv_bfloat16)                    \
  return static_cast<int>(cudaErrorInvalidValue);

}  // namespace

// Blocks of K5 that fit on the current device at once with `smem_bytes`
// of dynamic shared memory (the cooperative launch's largest grid).
extern "C" int mt_megakernel_blocks(int cache_fmt, int64_t group, int64_t smem_bytes,
                                    int* blocks) {
#define MT_BLOCKS(TC, G) static_cast<int>(resident_blocks<TC, G>(smem_bytes, blocks))
  MT_DISPATCH(MT_BLOCKS)
#undef MT_BLOCKS
}

// One decode step. x_fmt / cache_fmt: 0 = float32, 1 = bfloat16. scratch is
// f32: xs, q, o, y (B*D each), h1 (B*F), o_part (B*H*nsplit*hd), ml_part
// (B*H*nsplit*2), in that order. Returns the launch's cudaError_t (0 on
// success).
extern "C" int mt_megakernel(const void* x, void* x_out, void* kv, const void* qkv_w,
                             const void* out_w, const void* fc1_w, const void* fc2_w,
                             const void* qkv_b, const void* out_b, const void* fc1_b,
                             const void* fc2_b, const void* ln_a_w, const void* ln_a_b,
                             const void* ln_f_w, const void* ln_f_b, void* scratch, int x_fmt,
                             int cache_fmt, int64_t B, int64_t L, int64_t S, int64_t D,
                             int64_t F, int64_t H, int64_t write_pos, int64_t cur_len,
                             int64_t rows_per_split, int64_t nsplit, int64_t group,
                             int64_t blocks, float ln_eps, void* stream) {
  // a GEMV's K (D or F) is a multiple of 512 or at most 512; the layer norm holds D <= 1024
  const bool k_ok = (D % 512 == 0 || D <= 512) && (F % 512 == 0 || F <= 512);
  if (H <= 0 || D % H != 0 || (D / H != 8 && D / H != 64) || D % 8 != 0 || F % 8 != 0 ||
      D > kMaxWidth || !k_ok || group < 1 || group > kMaxGroup ||
      (x_fmt != 0 && x_fmt != 1) || cur_len < 1 || cur_len > S || write_pos < 0 ||
      write_pos >= S || nsplit < 1 || rows_per_split * nsplit < cur_len || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t head_dim = D / H;
  Params p;
  p.x = x;
  p.x_out = x_out;
  p.kv = kv;
  p.qkv_w = static_cast<const __nv_bfloat16*>(qkv_w);
  p.out_w = static_cast<const __nv_bfloat16*>(out_w);
  p.fc1_w = static_cast<const __nv_bfloat16*>(fc1_w);
  p.fc2_w = static_cast<const __nv_bfloat16*>(fc2_w);
  p.qkv_b = static_cast<const float*>(qkv_b);
  p.out_b = static_cast<const float*>(out_b);
  p.fc1_b = static_cast<const float*>(fc1_b);
  p.fc2_b = static_cast<const float*>(fc2_b);
  p.ln_a_w = static_cast<const float*>(ln_a_w);
  p.ln_a_b = static_cast<const float*>(ln_a_b);
  p.ln_f_w = static_cast<const float*>(ln_f_w);
  p.ln_f_b = static_cast<const float*>(ln_f_b);
  p.xs = static_cast<float*>(scratch);
  p.q = p.xs + B * D;
  p.o = p.q + B * D;
  p.y = p.o + B * D;
  p.h1 = p.y + B * D;
  p.o_part = p.h1 + B * F;
  p.ml_part = p.o_part + B * H * nsplit * head_dim;
  p.B = B;
  p.L = L;
  p.S = S;
  p.D = D;
  p.F = F;
  p.H = H;
  p.write_pos = write_pos;
  p.cur_len = cur_len;
  p.rows_per_split = rows_per_split;
  p.nsplit = nsplit;
  p.head_dim = static_cast<int>(head_dim);
  const int64_t kmax = D > F ? D : F;
  p.act_bytes = group * kmax * static_cast<int64_t>(sizeof(__nv_bfloat16));
  p.x_bf16 = x_fmt;
  p.ln_eps = ln_eps;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(head_dim)));
  const int64_t smem_bytes = p.act_bytes + kChunkItems * group * static_cast<int64_t>(sizeof(float));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MT_LAUNCH(TC, G) static_cast<int>(launch<TC, G>(p, blocks, smem_bytes, st))
  MT_DISPATCH(MT_LAUNCH)
#undef MT_LAUNCH
}

extern "C" const char* mt_megakernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
