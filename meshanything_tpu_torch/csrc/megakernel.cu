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
// flops/byte balance point at B <= 16. Then the grid barriers: a step is
// L * 5 of them.
//
// What the design does about it:
//   * one persistent cooperative launch (grid = one block an SM); five
//     grid-wide barriers a layer separate
//       (A) the FFN LayerNorm of the layer before (or the input), the QKV
//           GEMV and the K/V row append,
//       (B) attention over (b, context split) tasks, folded in place,
//       (C) the out projection + bias + residual,
//       (D) the attention LayerNorm and fc1 + bias + ReLU,
//       (E) fc2 + bias + residual;
//   * weights never depend on activations, so they are streamed one
//     weighted phase ahead: a block owns a contiguous range of output rows
//     of each (L, out, in) matrix, and warp 0 starts its share of the next
//     matrix (one cp.async.bulk a row, landing at a stride of K * 2 + 16
//     bytes so that ldmatrix reads eight rows without a bank conflict) into
//     one of two shared-memory buffers, tracked by that buffer's mbarrier,
//     as soon as the phase before has finished reading it. The copies run
//     on across the grid barrier that precedes their phase (QKV, fc1 in
//     buffer 0; out, fc2 in buffer 1: four weighted phases a layer, so each
//     buffer's barrier completes twice a layer and its parities are fixed);
//   * attention is K1's (decode_attention.cu): a task is one batch row and
//     one split of the context, whose whole flat rows (all heads) stream
//     through the TMA ring of row_stream.cuh (pad 0, one copy a plane's
//     tile), one warp a head; the splits fold in the same phase through the
//     ticket counters of split_fold.cuh, in split order (bit-equal from run
//     to run), straight into the bf16 input of the out projection. The ring
//     lies over buffer 0, the activations and the partial sums, which
//     phase (B) does not use;
//   * the GEMVs read weights and activations from shared memory. Groups of
//     up to 16 batch rows (G = 16) run on tensor cores: mma.sync.m16n8k16,
//     weights as A (16 output rows), the staged activations as B (the
//     batch as N), f32 sums; a warp takes one (16-row tile, K range) task
//     and the K ranges meet in shared memory in a fixed order. Groups of 1
//     and 2 rows (the single-request and two-mesh batches) stay on CUDA
//     cores: a warp a row, 16-byte reads;
//   * the new K/V rows are written by one block with generic stores and read
//     by other blocks' bulk copies (the async proxy) after the grid barrier:
//     the writers' fence.proxy.async before the barrier, the barrier's
//     release and acquire, and the readers' fence.proxy.async before they
//     start the copies order the store before the copy's read. Scratch
//     written in the launch is read with ld.global.cg (L2, coherent);
//   * attention reads only rows < cur_len, so NaN past cur_len cannot
//     reach the output; all offsets into the cache are 64-bit (a B=16 bf16
//     cache plane is 6 GB).
//
// Shared memory a block (232,448 bytes at most; the wrapper's smem_plan
// sizes it, this file checks it): [buffer 1 | buffer 0 | activations |
// partial sums], each buffer ceil(N / grid) rows of K * 2 + 16 bytes for
// the largest matrix (66,048 bytes at the 350M width over 132 blocks: 32
// fc1 rows of 2,064), the activations G rows of KC * 2 + 16 bytes (KC = D
// for G = 16, whose fc2 input is staged in chunks of D; max(D, F) for G <=
// 2), the partial sums 16 tasks x 16 x 16 f32 for G = 16. The ring, at
// buffer 0's offset, has 2-4 slots of 2 * TR rows (TR = 8 bf16 or 4 f32
// rows: 32 KiB a slot at the 350M width). At the 350M width the launch
// asks for 197,120 bytes (G = 16: 2 * 66,048 + 33,024 + 16,384 = 181,504
// for the weighted phases; 66,048 + 4 slots of 32,768 for the ring), beside
// 8,448 static bytes (a layer norm's affine, the barriers).
//
// The kernel allocates nothing and does not synchronise; the Python
// wrapper allocates the scratch and the output and holds the fold's
// counters and partials.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "row_stream.cuh"
#include "split_fold.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroup = 16;     // batch rows a GEMV pass serves from shared memory
constexpr int kMaxWidth = 1024;   // hidden size: the layer norm keeps a row in registers
constexpr int kMaxHeads = kWarps; // attention: one warp a head
constexpr int kPad = 16;          // bytes after each staged row (weights, activations)
constexpr int kTaskFloats = 16 * 16;   // one G = 16 task's partial sums: 16 rows x 16 batch rows
// static shared memory: a layer norm's affine, the barriers and the fold's ticket
constexpr int kStaticSmem = 2 * kMaxWidth * 4 + 256;
static_assert(kMaxGroup <= kWarps, "the layer norm runs one warp per row of a group");

// Parts that tools/k5_breakdown.py cuts out to time the rest, by text
// substitution of one of these lines. All false here: K5 is the full step.
constexpr bool kCutBarriers = false;   // grid barriers -> block barriers
constexpr bool kCutWeights = false;    // no weight copies and no waits for them
constexpr bool kCutPrefetch = false;   // a phase's weights started at its own start
constexpr bool kCutGemv = false;       // the GEMVs' arithmetic and epilogues
constexpr bool kCutAttention = false;  // phase (B) entirely
constexpr bool kCutFold = false;       // the splits' partials left unfolded
constexpr bool kCutNorm = false;       // layer norms and activation staging

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
  // scratch, written and read inside the launch
  float* xs;                     // (B, D) f32 residual stream
  float* q;                      // (B, D) f32 scaled queries
  float* y;                      // (B, D) f32 pre-LayerNorm sums
  __nv_bfloat16* o;              // (B, D) attention output, the out projection's input
  __nv_bfloat16* h1;             // (B, F) ReLU(fc1), fc2's input
  split_fold::Plan fold;         // (b, split) partials and ticket counters
  int64_t B, L, S, D, F, H, write_pos, cur_len;
  int64_t wbuf;                  // bytes of one weight buffer (a multiple of 128)
  int64_t act_off, red_off;      // offsets of the activations and the partial sums
  int depth;                     // slots of the attention ring
  int x_bf16, head_dim;
  float ln_eps, scale;
};

enum Matrix { kQkv = 0, kOut = 1, kFc1 = 2, kFc2 = 3 };

__device__ __forceinline__ void grid_barrier(cg::grid_group& grid) {
  if (kCutBarriers) {
    __syncthreads();
  } else {
    grid.sync();
  }
}

// Orders this thread's generic accesses (shared and global) before bulk
// copies started after the next barrier, and generic stores before other
// blocks' bulk copies after the next grid barrier.
__device__ __forceinline__ void fence_proxy_async_all() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_inval(uint32_t bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

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

__device__ __forceinline__ void store_cache(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_cache(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// ------------------------------------------------------------ weights

// Matrix `m` of `layer`: its (N, K) and its rows.
__device__ __forceinline__ const __nv_bfloat16* matrix(const Params& p, int m, int64_t layer,
                                                       int64_t* n, int64_t* k) {
  const int64_t D = p.D, F = p.F;
  switch (m) {
    case kQkv: *n = 3 * D; *k = D; return p.qkv_w + layer * 3 * D * D;
    case kOut: *n = D; *k = D; return p.out_w + layer * D * D;
    case kFc1: *n = F; *k = D; return p.fc1_w + layer * F * D;
    default: *n = D; *k = F; return p.fc2_w + layer * D * F;
  }
}

// The output rows [r0, r1) of an N-row matrix that this block owns.
__device__ __forceinline__ void share(int64_t n, int64_t* r0, int64_t* r1) {
  *r0 = static_cast<int64_t>(blockIdx.x) * n / gridDim.x;
  *r1 = static_cast<int64_t>(blockIdx.x + 1) * n / gridDim.x;
}

// Buffer of matrix m: QKV and fc1 in buffer 0 (at wbuf), out and fc2 in
// buffer 1 (at 0); the parity of the barrier's phase that m completes.
__device__ __forceinline__ uint32_t buffer_offset(const Params& p, int m) {
  return (m & 1) ? 0u : static_cast<uint32_t>(p.wbuf);
}
__device__ __forceinline__ uint32_t buffer_parity(int m) { return static_cast<uint32_t>(m >> 1); }

// Start the copies of this block's share of matrix m of `layer` into its
// buffer. Called by every thread: the block first finishes its reads of
// that buffer (and of whatever overlays it), then warp 0 starts one bulk
// copy a row, all reported to the buffer's barrier.
__device__ void start_weights(const Params& p, int m, int64_t layer, unsigned char* smem,
                              uint64_t* wbars) {
  if (kCutWeights) return;
  row_stream::fence_proxy_async();   // shared memory only: weights are never written
  __syncthreads();
  if (threadIdx.x >= 32) return;
  int64_t n, k;
  const __nv_bfloat16* w = matrix(p, m, layer, &n, &k);
  int64_t r0, r1;
  share(n, &r0, &r1);
  const int rows = static_cast<int>(r1 - r0);
  const uint32_t row_bytes = static_cast<uint32_t>(k * 2);
  const uint32_t stride = row_bytes + kPad;
  const uint32_t bar = row_stream::smem_addr(wbars + (m & 1));
  const uint32_t dst = row_stream::smem_addr(smem) + buffer_offset(p, m);
  const int lane = threadIdx.x;
  if (lane == 0) row_stream::mbar_expect_tx(bar, rows * row_bytes);   // 0 bytes: completes
  __syncwarp();
  for (int j = lane; j < rows; j += 32) {
    row_stream::bulk_load(dst + j * stride, w + (r0 + j) * k, row_bytes, bar);
  }
}

// Wait until matrix m's share has landed (every thread).
__device__ __forceinline__ void wait_weights(uint64_t* wbars, int m) {
  if (kCutWeights) return;
  row_stream::mbar_wait(row_stream::smem_addr(wbars + (m & 1)), buffer_parity(m));
}

// ------------------------------------------------------------ epilogues

// What the epilogue of output (n, b) adds besides the product: (its bias,
// the residual row's element for out and fc2). Loaded before the product
// is computed, so that their latency hides under it.
__device__ __forceinline__ float2 epilogue_inputs(const Params& p, int m, int64_t layer,
                                                  int64_t n, int64_t b) {
  const int64_t D = p.D;
  switch (m) {
    case kQkv: return make_float2(p.qkv_b[layer * 3 * D + n], 0.f);
    case kOut: return make_float2(p.out_b[layer * D + n], __ldcg(p.xs + b * D + n));
    case kFc1: return make_float2(p.fc1_b[layer * p.F + n], 0.f);
    default: return make_float2(p.fc2_b[layer * D + n], __ldcg(p.xs + b * D + n));
  }
}

template <typename TC>
__device__ __forceinline__ void epilogue(const Params& p, int m, int64_t layer, int64_t n,
                                         int64_t b, float s, float2 in) {
  const int64_t D = p.D;
  switch (m) {
    case kQkv: {
      const float v = s + in.x;
      if (n < D) {
        p.q[b * D + n] = v * p.scale;   // q is scaled before the dot
      } else {
        const int64_t plane = n < 2 * D ? 0 : 1;
        const int64_t col = n - (1 + plane) * D;
        TC* kv = static_cast<TC*>(p.kv);
        store_cache(kv + (((plane * p.L + layer) * p.B + b) * p.S + p.write_pos) * D + col, v);
      }
      break;
    }
    case kFc1:
      p.h1[b * p.F + n] = __float2bfloat16(fmaxf(s + in.x, 0.f));
      break;
    default:  // kOut, kFc2: the residual
      p.y[b * D + n] = in.y + (s + in.x);
      break;
  }
}

// ------------------------------------------------------------ staging

// Columns a G-row GEMV pass stages at once: D for the tensor-core groups
// (fc2's input in F / D chunks), the whole K for the others.
template <int G>
__device__ __forceinline__ int64_t chunk_cols(const Params& p, int64_t k) {
  return G == kMaxGroup ? p.D : k;
}

// Rows [g0, g0 + nb), columns [c0, c0 + kc) of a bf16 (B, k) matrix
// written in this launch -> act (row stride kc + kPad / 2 elements).
__device__ void stage_bf16(const __nv_bfloat16* src, int64_t k, int64_t c0, int64_t kc,
                           int64_t g0, int nb, __nv_bfloat16* act) {
  if (kCutNorm) return;
  const int64_t vecs = kc / 8;
  const int64_t stride = kc + kPad / 2;
  for (int64_t i = threadIdx.x; i < nb * vecs; i += kThreads) {
    const int64_t r = i / vecs;
    const int64_t v = i % vecs;
    *reinterpret_cast<uint4*>(act + r * stride + 8 * v) =
        __ldcg(reinterpret_cast<const uint4*>(src + (g0 + r) * k + c0 + 8 * v));
  }
}

// Layer 0's input: x (x's dtype) -> act, and (block 0) the f32 residual stream.
__device__ void stage_input(const Params& p, int64_t g0, int nb, __nv_bfloat16* act) {
  if (kCutNorm) return;
  const int64_t D = p.D;
  const int64_t stride = D + kPad / 2;
  for (int64_t i = threadIdx.x; i < nb * D; i += kThreads) {
    const int64_t r = i / D;
    const int64_t c = i % D;
    const int64_t gi = (g0 + r) * D + c;
    const float v = p.x_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.x)[gi])
                             : static_cast<const float*>(p.x)[gi];
    act[r * stride + c] = __float2bfloat16(v);
    if (blockIdx.x == 0) p.xs[gi] = v;
  }
}

// One warp per row of the group: LayerNorm (f32 statistics) of rows
// [g0, g0 + nb) of src (B, D), the row held in registers (D <= kMaxWidth).
// The result goes to `act` (bf16, row stride D + kPad / 2) and, where
// given, to the f32 residual stream `dst` and to the step's output `out`
// (x's dtype). Called by every thread of the block: the rows' loads are
// issued first, then the whole block loads the affine into `affine`
// (shared, 2 * D floats), so that both take one trip to memory.
__device__ void layer_norm_rows(const Params& p, const float* src, const float* w,
                                const float* bias, int64_t g0, int nb, __nv_bfloat16* act,
                                float* dst, void* out, float* affine) {
  constexpr int kPerLane = kMaxWidth / 32;
  if (kCutNorm) return;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t D = p.D;
  const int64_t r = g0 + warp;
  const bool mine = warp < nb;
  float x[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int64_t c = lane + 32 * i;
    x[i] = mine && c < D ? __ldcg(src + r * D + c) : 0.f;
  }
  __syncthreads();   // the affine of the call before has been read
  for (int64_t c = threadIdx.x; c < D; c += kThreads) {
    affine[c] = __ldg(w + c);
    affine[kMaxWidth + c] = __ldg(bias + c);
  }
  __syncthreads();
  if (!mine) return;
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
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int64_t c = lane + 32 * i;
    if (c >= D) continue;
    const float val = (x[i] - mean) * inv * affine[c] + affine[kMaxWidth + c];
    if (act != nullptr) act[warp * (D + kPad / 2) + c] = __float2bfloat16(val);
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

// ------------------------------------------------------------ GEMVs

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// G = 1 or 2 rows on CUDA cores: out[b, n] = act[b] . W[n] for the block's
// rows n of matrix m (in shared memory, row stride K + 8 elements) and
// the nb <= G rows of the staged input (the whole K). A warp a row,
// lane-strided 16-byte reads, a butterfly sum.
template <typename TC, int G>
__device__ void gemv_cuda_cores(const Params& p, int m, int64_t layer, const unsigned char* smem,
                                const __nv_bfloat16* act, int nb, int64_t g0) {
  if (kCutGemv) return;
  int64_t n, k, r0, r1;
  matrix(p, m, layer, &n, &k);
  share(n, &r0, &r1);
  const __nv_bfloat16* w = reinterpret_cast<const __nv_bfloat16*>(smem + buffer_offset(p, m));
  const int64_t stride = k + kPad / 2;   // the weights' and the activations'
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int vecs = static_cast<int>(k / 8);
  for (int64_t j = warp; j < r1 - r0; j += kWarps) {
    const uint4* wrow = reinterpret_cast<const uint4*>(w + j * stride);
    float2 in[G];
#pragma unroll
    for (int b = 0; b < G; ++b) {
      if (lane == 0 && b < nb) in[b] = epilogue_inputs(p, m, layer, r0 + j, g0 + b);
    }
    float acc[G];
#pragma unroll
    for (int b = 0; b < G; ++b) acc[b] = 0.f;
    for (int v = lane; v < vecs; v += 32) {
      float wf[8];
      bf16x8_to_float(wrow[v], wf);
#pragma unroll
      for (int b = 0; b < G; ++b) {
        if (b < nb) {
          float af[8];
          bf16x8_to_float(*reinterpret_cast<const uint4*>(act + b * stride + 8 * v), af);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[b] = fmaf(wf[e], af[e], acc[b]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < G; ++b) {
      if (b < nb) {
        const float s = warp_sum(acc[b]);
        if (lane == 0) epilogue<TC>(p, m, layer, r0 + j, g0 + b, s, in[b]);
      }
    }
  }
}

// G = 16 rows on tensor cores. The block's rows of matrix m are cut into
// 16-row tiles (mt of them, at most 16: checked by the host), each tile's
// K into 16 / mt ranges; a warp takes one (tile, range) task and runs
// mma.sync.m16n8k16 over it, the weight tile as A (ldmatrix from the
// padded rows; rows past the share read the last row, and only their own
// discarded outputs see it), the activations as B (batch rows as N: two
// n8 halves, the second skipped for nb <= 8). With `src`, the input is the
// bf16 (B, K) matrix staged here D columns at a time (fc2); otherwise act
// already holds the whole K = D. The tasks' sums meet in shared memory and
// are added in range order, so the result does not depend on timing.
template <typename TC>
__device__ void gemv_tensor_cores(const Params& p, int m, int64_t layer, unsigned char* smem,
                                  __nv_bfloat16* act, const __nv_bfloat16* src, int nb,
                                  int64_t g0) {
  int64_t n, k, r0, r1;
  matrix(p, m, layer, &n, &k);
  share(n, &r0, &r1);
  const int rows = static_cast<int>(r1 - r0);
  const int64_t kc = p.D;
  const int64_t chunks = k / kc;
  const int tiles = (rows + 15) / 16;
  const int per = tiles > 0 ? tiles : 1;
  const int ranges = kWarps / per;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool active = tiles > 0 && warp < per * ranges;
  const int tile = warp % per;
  const int range = warp / per;
  const int steps = static_cast<int>(kc / 16);
  const int s0 = range * steps / ranges;
  const int s1 = (range + 1) * steps / ranges;
  // ldmatrix: lane l gives the address of row l % 8 of matrix l / 8
  const int mi = lane >> 3;
  const int mr = lane & 7;
  int arow = tile * 16 + mr + 8 * (mi & 1);
  arow = arow < rows ? arow : (rows > 0 ? rows - 1 : 0);
  const uint32_t a_addr = row_stream::smem_addr(smem + buffer_offset(p, m)) +
                          arow * static_cast<uint32_t>(k * 2 + kPad) + 16 * (mi >> 1);
  const uint32_t b_addr = row_stream::smem_addr(act) +
                          (mr + 8 * (mi >> 1)) * static_cast<uint32_t>(kc * 2 + kPad) +
                          16 * (mi & 1);
  // the epilogue's inputs of this thread's first output (there is one an
  // output at most for up to 32 rows of 16 batch rows)
  const int first = threadIdx.x;
  float2 in0 = make_float2(0.f, 0.f);
  if (!kCutGemv && first < rows * nb) {
    in0 = epilogue_inputs(p, m, layer, r0 + first / nb, g0 + first % nb);
  }
  float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int64_t ch = 0; ch < chunks; ++ch) {
    if (src != nullptr) {
      if (ch > 0) __syncthreads();   // every warp is done with the chunk before
      stage_bf16(src, k, ch * kc, kc, g0, nb, act);
      __syncthreads();
    }
    if (kCutGemv || !active) continue;
    for (int s = s0; s < s1; ++s) {
      uint32_t a[4], b[4];
      ldmatrix_x4(a, a_addr + static_cast<uint32_t>((ch * kc + 16 * s) * 2));
      ldmatrix_x4(b, b_addr + static_cast<uint32_t>(32 * s));
      mma_bf16(c[0], a, b[0], b[1]);
      if (nb > 8) mma_bf16(c[1], a, b[2], b[3]);
    }
  }
  float* red = reinterpret_cast<float*>(smem + p.red_off);
  if (active) {
    // c[nt][2h + e] is (row lane / 4 + 8 h, batch row 8 nt + 2 (lane % 4) + e)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* dst = red + warp * kTaskFloats + (lane / 4 + 8 * h) * 16 + 8 * nt + 2 * (lane % 4);
        dst[0] = c[nt][2 * h];
        dst[1] = c[nt][2 * h + 1];
      }
    }
  }
  __syncthreads();
  if (kCutGemv) return;
  for (int idx = threadIdx.x; idx < rows * nb; idx += kThreads) {
    const int j = idx / nb;
    const int b = idx % nb;
    const float* part = red + (j / 16) * kTaskFloats + (j % 16) * 16 + b;
    float sum = 0.f;
    for (int r = 0; r < ranges; ++r) sum += part[r * per * kTaskFloats];
    const float2 in = idx == first ? in0 : epilogue_inputs(p, m, layer, r0 + j, g0 + b);
    epilogue<TC>(p, m, layer, r0 + j, g0 + b, sum, in);
  }
}

// The GEMV of matrix m over one group of the batch.
template <typename TC, int G>
__device__ __forceinline__ void gemv(const Params& p, int m, int64_t layer, unsigned char* smem,
                                     __nv_bfloat16* act, const __nv_bfloat16* src, int nb,
                                     int64_t g0) {
  if constexpr (G == kMaxGroup) {
    gemv_tensor_cores<TC>(p, m, layer, smem, act, src, nb, g0);
  } else {
    if (src != nullptr) {
      int64_t n, k;
      matrix(p, m, layer, &n, &k);
      stage_bf16(src, k, 0, k, g0, nb, act);
      __syncthreads();
    }
    gemv_cuda_cores<TC, G>(p, m, layer, smem, act, nb, g0);
  }
}

// ------------------------------------------------------------ attention

// Rows of a ring tile: 16 bytes of rows a lane, 8 bf16 or 4 f32 rows
// (32 KiB a slot at the 350M width, so that four slots fit beside a
// weight buffer).
template <typename TC>
__host__ __device__ constexpr int tile_rows() {
  return 16 / static_cast<int>(sizeof(TC));
}

// One 16-byte chunk of a row in shared memory, widened to f32.
__device__ __forceinline__ void load_chunk(const unsigned char* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load_chunk(const unsigned char* p, float (&out)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);  // bf16 -> f32 is a shift
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The last split of batch row b to finish folds the row's partials into o.
template <int HD>
__device__ __forceinline__ void fold_into_o(const Params& p, int64_t b, int split) {
  split_fold::finish<__nv_bfloat16, HD, true>(p.fold, b, split, static_cast<int>(p.H),
                                              p.o + b * p.D);
}

// Phase (B): tasks (b, split), block i taking tasks i, i + grid, ... A
// split is whole tiles of rows [0, cur_len), balanced to within one tile
// (as K1's split_bounds). Per task the body is K1's with the queries
// already scaled: warp h (< H) reads head h's slice of each landed row,
// lane (g, c) = (lane / NCH, lane % NCH) takes 16-byte chunk c in rows g,
// g + GR, ..; the online softmax in f32; the split's unnormalized
// accumulator, max and sum go to the fold's partials, and the last split of
// a batch row to finish folds them into o (bf16).
template <typename TC, int HD>
__device__ void attention(const Params& p, int64_t layer, unsigned char* ring_smem,
                          uint64_t* bars, bool* ring_used) {
  constexpr int TR = tile_rows<TC>();
  constexpr int EPC = 16 / static_cast<int>(sizeof(TC));   // elements of a 16-byte chunk
  constexpr int NCH = HD / EPC;                             // chunks of a head's slice of a row
  constexpr int GR = 32 / NCH;                              // row groups of a warp
  constexpr int RPL = TR / GR > 0 ? TR / GR : 1;            // rows a lane
  static_assert(HD % EPC == 0 && NCH <= 32 && 32 % NCH == 0,
                "head_dim must be whole 16-byte chunks, at most 32 of them");
  const int H = static_cast<int>(p.H);
  const int h = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = lane % NCH;
  const int g = lane / NCH;
  const int nsplit = p.fold.nsplit;
  const int slots = nsplit + p.fold.ngroups;
  const int64_t tiles = (p.cur_len + TR - 1) / TR;
  const uint32_t row_bytes = static_cast<uint32_t>(p.D * sizeof(TC));
  for (int64_t task = blockIdx.x; task < p.B * nsplit; task += gridDim.x) {
    const int64_t b = task / nsplit;
    const int split = static_cast<int>(task % nsplit);
    const int64_t row0 = (split * tiles / nsplit) * TR;
    int64_t row1 = ((split + 1) * tiles / nsplit) * TR;
    row1 = row1 < p.cur_len ? row1 : p.cur_len;
    const int64_t first = (layer * p.B + b) * p.S;   // flat row 0 of (layer, b)
    const unsigned char* kp = static_cast<const unsigned char*>(p.kv) + first * row_bytes;
    const unsigned char* vp = kp + p.L * p.B * p.S * row_bytes;
    // the ring's barriers are made anew a task: the block is done with the
    // last task's (and the weights' generic reads of this memory are done)
    __syncthreads();
    if (*ring_used && threadIdx.x == 0) {
      for (int i = 0; i < p.depth; ++i) mbar_inval(row_stream::smem_addr(bars + i));
    }
    *ring_used = true;
    float qf[EPC];   // loaded ahead of the ring's first tile
    if (h < H) {
#pragma unroll
      for (int j = 0; j < EPC; ++j) qf[j] = __ldcg(p.q + b * p.D + h * HD + c * EPC + j);
    }
    row_stream::fence_proxy_async();   // this thread's reads of the region before the copies
    row_stream::Ring ring;
    ring.init(ring_smem, bars, p.depth, TR, row_bytes, 0, kp, vp, row0, row1);
    float m_run = -INFINITY;
    float l_run = 0.f;
    float acc[EPC];
#pragma unroll
    for (int j = 0; j < EPC; ++j) acc[j] = 0.f;

    for (int i = 0; i < ring.ntiles; ++i) {
      int rows;
      const unsigned char* ks = ring.acquire(i, &rows);
      if (h >= H) continue;   // a warp past the heads only keeps the ring's barriers
      const unsigned char* kc = ks + h * HD * sizeof(TC) + c * 16;   // this lane's chunk of row 0
      const unsigned char* vc = kc + ring.plane_bytes;
      // the logits of this lane's rows (rows past `rows` hold an earlier tile: masked)
      float logit[RPL];
      float m_tile = -INFINITY;
#pragma unroll
      for (int it = 0; it < RPL; ++it) {
        const int rr = g + it * GR;
        const bool live = rr < rows;
        float dot = 0.f;
        if (live) {
          float kf[EPC];
          load_chunk(kc + rr * ring.row_stride, kf);
#pragma unroll
          for (int e = 0; e < EPC; ++e) dot = fmaf(qf[e], kf[e], dot);
        }
#pragma unroll
        for (int off = 1; off < NCH; off <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        logit[it] = live ? dot : -INFINITY;
        m_tile = fmaxf(m_tile, logit[it]);
      }
#pragma unroll
      for (int off = NCH; off < 32; off <<= 1)
        m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, off));
      const float m_new = fmaxf(m_run, m_tile);   // finite: row 0 of a tile is live
      float pr[RPL];
      float psum = 0.f;
#pragma unroll
      for (int it = 0; it < RPL; ++it) {
        pr[it] = g + it * GR < rows ? expf(logit[it] - m_new) : 0.f;
        psum += pr[it];
      }
#pragma unroll
      for (int off = NCH; off < 32; off <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float corr = expf(m_run - m_new);  // 0 on the first tile
      l_run = l_run * corr + psum;
      m_run = m_new;
#pragma unroll
      for (int j = 0; j < EPC; ++j) acc[j] *= corr;
#pragma unroll
      for (int it = 0; it < RPL; ++it) {
        const int rr = g + it * GR;
        if (rr < rows) {
          float vf[EPC];
          load_chunk(vc + rr * ring.row_stride, vf);
#pragma unroll
          for (int e = 0; e < EPC; ++e) acc[e] = fmaf(pr[it], vf[e], acc[e]);
        }
      }
    }
    if (h < H) {
      // sum the row groups of the accumulator, in a fixed order
#pragma unroll
      for (int off = NCH; off < 32; off <<= 1) {
#pragma unroll
        for (int e = 0; e < EPC; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
      }
      const int64_t slot = (b * slots + split) * H + h;
      if (g == 0) {
        float* o = p.fold.o_part + slot * HD + c * EPC;
#pragma unroll
        for (int e = 0; e < EPC; ++e) o[e] = acc[e];
      }
      if (lane == 0) {
        p.fold.ml_part[2 * slot] = m_run;
        p.fold.ml_part[2 * slot + 1] = l_run;
      }
    }
    if (!kCutFold) fold_into_o<HD>(p, b, split);
  }
}

template <typename TC>
__device__ __forceinline__ void attention_phase(const Params& p, int64_t layer,
                                                unsigned char* ring_smem, uint64_t* bars,
                                                bool* ring_used) {
  if (kCutAttention) return;
  if (p.head_dim == 64) {   // the 350M model (hidden 1024, 16 heads)
    attention<TC, 64>(p, layer, ring_smem, bars, ring_used);
  } else {                  // small_test_config (hidden 32, 4 heads)
    attention<TC, 8>(p, layer, ring_smem, bars, ring_used);
  }
}

// ------------------------------------------------------------ the step

// G: batch rows a GEMV pass serves (the group); groups of G rows cover B.
template <typename TC, int G>
__global__ void __launch_bounds__(kThreads, 1) megakernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t wbars[2];                       // the weight buffers'
  __shared__ __align__(8) uint64_t rbars[row_stream::kMaxDepth];   // the attention ring's
  __shared__ float affine[2 * kMaxWidth];                          // a layer norm's scale, bias
  cg::grid_group grid = cg::this_grid();
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem + p.act_off);
  unsigned char* ring_smem = smem + p.wbuf;   // over buffer 0, act and the partial sums
  bool ring_used = false;
  const int64_t D = p.D;
  float* const xs_writer = blockIdx.x == 0 ? p.xs : nullptr;
  if (threadIdx.x == 0) {
    row_stream::mbar_init(row_stream::smem_addr(wbars), 1);
    row_stream::mbar_init(row_stream::smem_addr(wbars + 1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (!kCutPrefetch) start_weights(p, kQkv, 0, smem, wbars);

  for (int64_t layer = 0; layer < p.L; ++layer) {
    // (A) the previous layer's FFN LayerNorm (or the input), QKV, K/V append
    start_weights(p, kCutPrefetch ? kQkv : kOut, layer, smem, wbars);
    for (int64_t g0 = 0; g0 < p.B; g0 += G) {
      const int nb = static_cast<int>(p.B - g0 < G ? p.B - g0 : G);
      if (layer == 0) {
        stage_input(p, g0, nb, act);
      } else {
        layer_norm_rows(p, p.y, p.ln_f_w + (layer - 1) * D, p.ln_f_b + (layer - 1) * D, g0, nb,
                        act, xs_writer, nullptr, affine);
      }
      __syncthreads();
      wait_weights(wbars, kQkv);
      gemv<TC, G>(p, kQkv, layer, smem, act, nullptr, nb, g0);
      __syncthreads();
    }
    fence_proxy_async_all();   // the new K/V rows before other blocks' bulk copies read them
    grid_barrier(grid);
    // (B) attention over the live rows, the new row included, folded into o
    fence_proxy_async_all();
    attention_phase<TC>(p, layer, ring_smem, rbars, &ring_used);
    grid_barrier(grid);
    // (C) out projection + bias + residual
    start_weights(p, kCutPrefetch ? kOut : kFc1, layer, smem, wbars);
    for (int64_t g0 = 0; g0 < p.B; g0 += G) {
      const int nb = static_cast<int>(p.B - g0 < G ? p.B - g0 : G);
      stage_bf16(p.o, D, 0, D, g0, nb, act);
      __syncthreads();
      wait_weights(wbars, kOut);
      gemv<TC, G>(p, kOut, layer, smem, act, nullptr, nb, g0);
      __syncthreads();
    }
    grid_barrier(grid);
    // (D) attention LayerNorm, fc1 + bias + ReLU
    start_weights(p, kCutPrefetch ? kFc1 : kFc2, layer, smem, wbars);
    for (int64_t g0 = 0; g0 < p.B; g0 += G) {
      const int nb = static_cast<int>(p.B - g0 < G ? p.B - g0 : G);
      layer_norm_rows(p, p.y, p.ln_a_w + layer * D, p.ln_a_b + layer * D, g0, nb, act,
                      xs_writer, nullptr, affine);
      __syncthreads();
      wait_weights(wbars, kFc1);
      gemv<TC, G>(p, kFc1, layer, smem, act, nullptr, nb, g0);
      __syncthreads();
    }
    grid_barrier(grid);
    // (E) fc2 + bias + residual; the next layer's QKV weights start
    if (kCutPrefetch) {
      start_weights(p, kFc2, layer, smem, wbars);
    } else if (layer + 1 < p.L) {
      start_weights(p, kQkv, layer + 1, smem, wbars);
    }
    for (int64_t g0 = 0; g0 < p.B; g0 += G) {
      const int nb = static_cast<int>(p.B - g0 < G ? p.B - g0 : G);
      wait_weights(wbars, kFc2);
      gemv<TC, G>(p, kFc2, layer, smem, act, p.h1, nb, g0);
      __syncthreads();
    }
    grid_barrier(grid);
  }
  // the last FFN LayerNorm, cast to x's dtype
  if (blockIdx.x == 0) {
    for (int64_t g0 = 0; g0 < p.B; g0 += G) {
      const int nb = static_cast<int>(p.B - g0 < G ? p.B - g0 : G);
      layer_norm_rows(p, p.y, p.ln_f_w + (p.L - 1) * D, p.ln_f_b + (p.L - 1) * D, g0, nb,
                      nullptr, nullptr, p.x_out, affine);
    }
  }
}

// ------------------------------------------------------------ host

// The shared-memory layout of a launch (ops/megakernel.py::smem_plan is
// the same formula): false where it does not fit.
struct Layout {
  int64_t wbuf, act_off, red_off, depth, total;
};

inline int64_t round_up(int64_t v, int64_t m) { return (v + m - 1) / m * m; }

inline bool make_layout(int64_t group, int64_t D, int64_t F, int64_t blocks, Layout* l) {
  const int64_t mats[4][2] = {{3 * D, D}, {D, D}, {F, D}, {D, F}};   // (N, K)
  int64_t wbuf = 0, most_rows = 0;
  for (const auto& nk : mats) {
    const int64_t rows = (nk[0] + blocks - 1) / blocks;
    const int64_t bytes = rows * (nk[1] * 2 + kPad);
    wbuf = bytes > wbuf ? bytes : wbuf;
    most_rows = rows > most_rows ? rows : most_rows;
  }
  wbuf = round_up(wbuf, 128);
  const int64_t kc = group == kMaxGroup ? D : (D > F ? D : F);
  const int64_t act = round_up(group * (kc * 2 + kPad), 128);
  const int64_t red = group == kMaxGroup ? kWarps * kTaskFloats * 4 : 0;
  const int64_t slot = 32 * D;   // 2 planes x 16 bytes of rows a lane x D / 8 lanes' worth
  const int64_t budget = row_stream::kMaxSmem - kStaticSmem;   // dynamic bytes a block may have
  int64_t depth = (budget - wbuf) / slot;
  depth = depth < row_stream::kMaxDepth ? depth : row_stream::kMaxDepth;
  const int64_t weighted = 2 * wbuf + act + red;
  const int64_t ring = wbuf + depth * slot;
  l->wbuf = wbuf;
  l->act_off = 2 * wbuf;
  l->red_off = 2 * wbuf + act;
  l->depth = depth;
  l->total = weighted > ring ? weighted : ring;
  // a G = 16 block's rows of a matrix make at most 16 tiles, one a warp
  return depth >= 2 && l->total <= budget &&
         (group != kMaxGroup || most_rows <= 16 * kWarps);
}

template <typename TC, int G>
cudaError_t opt_in(int64_t smem_bytes) {
  static int64_t opted_in[row_stream::kMaxDevices] = {};   // one record an instance
  return row_stream::opt_in_smem(megakernel<TC, G>, smem_bytes, opted_in);
}

template <typename TC, int G>
cudaError_t resident_blocks(int64_t smem_bytes, int* blocks) {
  cudaError_t err = opt_in<TC, G>(smem_bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, megakernel<TC, G>, kThreads,
                                                      static_cast<size_t>(smem_bytes));
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

template <typename TC, int G>
cudaError_t launch(const Params& p, int64_t blocks, int64_t smem_bytes, cudaStream_t stream) {
  cudaError_t err = opt_in<TC, G>(smem_bytes);
  if (err != cudaSuccess) return err;
  Params args = p;
  void* kernel_args[] = {&args};
  // every block must be resident for the grid barriers: a grid larger than
  // the occupancy allows is refused here (cudaErrorCooperativeLaunchTooLarge)
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(&megakernel<TC, G>),
                                    dim3(static_cast<unsigned>(blocks)), dim3(kThreads),
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

// One decode step. x_fmt / cache_fmt: 0 = float32, 1 = bfloat16. scratch:
// xs, q, y (B*D f32 each), then o (B*D bf16) and h1 (B*F bf16). The fold:
// nsplit splits a batch row in groups of fold_group, o_part (B, nsplit +
// ngroups, H, hd) f32, ml_part (B, nsplit + ngroups, H, 2) f32, counters
// B * (1 + ngroups) int32, zero between launches. smem_bytes must be the
// layout's (ops/megakernel.py::smem_plan). Returns the launch's
// cudaError_t (0 on success).
extern "C" int mt_megakernel(const void* x, void* x_out, void* kv, const void* qkv_w,
                             const void* out_w, const void* fc1_w, const void* fc2_w,
                             const void* qkv_b, const void* out_b, const void* fc1_b,
                             const void* fc2_b, const void* ln_a_w, const void* ln_a_b,
                             const void* ln_f_w, const void* ln_f_b, void* scratch, void* o_part,
                             void* ml_part, void* counters, int x_fmt, int cache_fmt, int64_t B,
                             int64_t L, int64_t S, int64_t D, int64_t F, int64_t H,
                             int64_t write_pos, int64_t cur_len, int64_t nsplit,
                             int64_t fold_group, int64_t group, int64_t blocks,
                             int64_t smem_bytes, float ln_eps, void* stream) {
  const int64_t tile = cache_fmt == 0 ? tile_rows<float>() : tile_rows<__nv_bfloat16>();
  const int64_t tiles = (cur_len + tile - 1) / tile;
  Layout lay;
  if (H <= 0 || H > kMaxHeads || D % H != 0 || (D / H != 8 && D / H != 64) || D % 16 != 0 ||
      F % 8 != 0 || D > kMaxWidth || (group == kMaxGroup && F % D != 0) ||
      (x_fmt != 0 && x_fmt != 1) || cur_len < 1 || cur_len > S || write_pos < 0 ||
      write_pos >= S || nsplit < 1 || nsplit > tiles || fold_group < 1 || blocks < 1 ||
      !make_layout(group, D, F, blocks, &lay) || lay.total != smem_bytes) {
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
  p.y = p.q + B * D;
  p.o = reinterpret_cast<__nv_bfloat16*>(p.y + B * D);
  p.h1 = p.o + B * D;
  p.fold.o_part = static_cast<float*>(o_part);
  p.fold.ml_part = static_cast<float*>(ml_part);
  p.fold.counters = static_cast<int*>(counters);
  p.fold.nsplit = static_cast<int>(nsplit);
  p.fold.group = static_cast<int>(fold_group);
  p.fold.ngroups = static_cast<int>((nsplit + fold_group - 1) / fold_group);
  p.B = B;
  p.L = L;
  p.S = S;
  p.D = D;
  p.F = F;
  p.H = H;
  p.write_pos = write_pos;
  p.cur_len = cur_len;
  p.wbuf = lay.wbuf;
  p.act_off = lay.act_off;
  p.red_off = lay.red_off;
  p.depth = static_cast<int>(lay.depth);
  p.x_bf16 = x_fmt;
  p.head_dim = static_cast<int>(head_dim);
  p.ln_eps = ln_eps;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(head_dim)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MT_LAUNCH(TC, G) static_cast<int>(launch<TC, G>(p, blocks, smem_bytes, st))
  MT_DISPATCH(MT_LAUNCH)
#undef MT_LAUNCH
}

extern "C" const char* mt_megakernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
