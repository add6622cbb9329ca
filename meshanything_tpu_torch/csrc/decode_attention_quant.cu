// K2 and K3 on Hopper: single-query flash-decoding over the int8 and int4
// caches, on K1's design.
//
// Replaces the TPU kernel
//   meshanything_tpu/ops/decode_attention.py::_flash_decode_pipelined_kernel
// with a quantized cache:
//   K2  an int8 cache (decode_attention_int8_impl(pipelined=True), from the
//       quantized decode step of models/shape_opt.py);
//   K3  an int4 "plane" cache (bits=4, _unpack4; decode_attention_int4_impl).
// For every batch row b and head h, over the rows s < cur_len of layer
// `layer` of the (2, L, B, S, packed) codes and (2, L, B, 1, S) f32 scales:
//   logit = (q . codes) * (1/sqrt(D)) * k_scale[s]               in f32
//   m, l  the running max and sum of the UNSCALED p = exp(logit - m)
//   p    <- p * v_scale[s], rounded to bf16 when q is bf16 (JAX's `lowp`)
//   out   = (sum of p * codes_v in f32) / max(l, 1e-30), cast to q's dtype.
// Codes are exact in f32, so the dots are the TPU kernel's up to
// summation order. The logits are taken in the log2 domain, exp(x) =
// 2^(x log2 e) by ex2.approx (2 ulp), and m goes to the fold as m ln 2.
// Scales reach the sums only through selects: rows past cur_len may hold
// NaN scales, and NaN * 0 is NaN.
//
// What bounds it on this card: the bytes of the live rows (int8: 2 * B *
// cur_len * H*D codes + 8 bytes of scales a row, 245 MB at B=16, cur_len
// 7459; int4 half the codes), and close behind them the CUDA cores'
// widening of every code (two instructions a code: quant_codes.cuh) and
// its FMA. One query has nothing for tensor cores to batch.
//
// The design is K1's (decode_attention.cu), with the codes:
//   * grid (B, splits), about one block an SM (`split_plan`); a block
//     streams whole flat rows of its split through the TMA ring of
//     row_stream.cuh, one bulk copy a plane's tile, and the tile's K and
//     V scales as two more copies on the same barrier (RingT<true>);
//   * tiles of 32 rows: 32 KiB a plane of int8, 16 KiB of int4. An int4
//     tile is unpacked once by the whole block into a byte a code (each
//     word read once; one more block barrier a tile) in a staging tile
//     beside the ring, so K3 runs K2's body. A 64-row int4 tile would need
//     a 64 KiB staging tile a plane: the int4 ring is four slots deep
//     instead, three tiles in flight. (Two staging tiles, one unpacked
//     while the other is attended with no barrier between, measured no
//     faster: PERF.md.);
//   * one warp a head: lane (g, c) widens 16-byte chunk c (16 codes; 8 at
//     head width 8) of the head's slice in rows g, g + G, ..: the dot by
//     shuffles within the row's lanes, the softmax by shuffles across the
//     row groups, P.V into the lane's own columns;
//   * the combine is folded into the launch (split_fold.cuh): one launch
//     a call, through the stream's FoldWorkspace, as K1;
//   * the live length is read on the device and the grid planned for a
//     host bound, as K1: each block runs the live length's plan;
//   * offsets into the cache are 64-bit (the B=16 int8 cache's K->V plane
//     stride is 3.02 GB).
// The kernel allocates nothing and does not synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "quant_codes.cuh"
#include "row_stream.cuh"
#include "split_fold.cuh"

namespace {

constexpr int kMaxHeads = 16;  // one warp a head
constexpr int kTile = 32;      // rows a tile

enum Fmt : int { kI8 = 2, kI4 = 3 };

// Cuts for tools/quant_breakdown.py, which builds copies of this file
// with some of them on; only times mean anything then. All off here.
constexpr bool kCutMath = false;     // tiles streamed, nothing computed
constexpr bool kCutUnpack = false;   // int4 tiles not unpacked: the math reads stale codes
constexpr bool kCutConvert = false;  // codes not widened: raw words taken as the numbers
constexpr bool kCutFold = false;     // the splits' partials left unfolded

// slots of the ring: two int8 tiles in flight, three int4 ones
__host__ __device__ constexpr int ring_depth(int fmt) { return fmt == kI4 ? 4 : 3; }

__host__ __device__ constexpr int64_t smem_bytes(int fmt, int64_t code_bytes) {
  const int64_t row_bytes = fmt == kI4 ? code_bytes / 2 : code_bytes;
  return ring_depth(fmt) * (row_stream::slot_bytes(kTile, static_cast<uint32_t>(row_bytes), 0) +
                            row_stream::side_bytes(kTile)) +
         (fmt == kI4 ? 2 * kTile * code_bytes : 0);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Four codes of a word as f32: int8 codes, or the int4 staging's biased ones
template <int F>
__device__ __forceinline__ void word_to_f32(uint32_t w, float* out) {
  if constexpr (F == kI4) {
    quant_codes::biased4x4_to_f32(w, *reinterpret_cast<float(*)[4]>(out));
  } else {
    quant_codes::codes4_to_f32(w, *reinterpret_cast<float(*)[4]>(out));
  }
}

// CB codes (8 or 16 bytes) of shared memory as f32
template <int F, int CB>
__device__ __forceinline__ void load_codes(const unsigned char* p, float (&out)[CB]) {
  if constexpr (kCutConvert) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int j = 0; j < CB; ++j) out[j] = __uint_as_float(w[j / 4] << (8 * (j % 4)));
  } else if constexpr (CB == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) word_to_f32<F>(w[i], out + 4 * i);
  } else {
    static_assert(CB == 8, "chunks of 8 or 16 codes");
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    word_to_f32<F>(v.x, out);
    word_to_f32<F>(v.y, out + 4);
  }
}

struct Args {
  const void* q;           // (B, H, D) f32 or bf16
  const unsigned char* kv; // (2, L, B, S, packed) codes
  const float* scales;     // (2, L, B, 1, S)
  void* out;               // (B, H, D) in q's dtype
  split_fold::Plan fold;    // the grid's plan, made for max_len rows
  const int32_t* cur_len;   // the live length, read on the device
  int64_t B, H, L, S, layer, max_len;
  float scale;             // 1 / sqrt(D)
};

// One block = batch row b and one split of the context: tiles
// [split * tiles / nsplit, (split + 1) * tiles / nsplit); one warp a head.
// Writes the split's unnormalized f32 accumulator, running max and
// running sum, then folds (split_fold.cuh).
template <int F, typename QT, int D>
__global__ void __launch_bounds__(32 * kMaxHeads, 1) quant_split_kernel(const Args a) {
  constexpr int CB = D < 16 ? D : 16;     // codes of a lane's chunk of the head's slice
  constexpr int NCH = D / CB;             // chunks of the slice
  constexpr int G = 32 / NCH;             // row groups of a warp
  constexpr int RPL = kTile / G > 0 ? kTile / G : 1;   // rows a lane
  constexpr bool kLowP = std::is_same<QT, __nv_bfloat16>::value;
  static_assert(D % CB == 0 && 32 % NCH == 0, "head_dim 8 or a multiple of 16 up to 512");

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[row_stream::kMaxDepth];

  const int64_t b = blockIdx.x;
  const int split = blockIdx.y;
  const int H = static_cast<int>(a.H);
  const int h = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = lane % NCH;
  const int g = lane / NCH;

  // the live plan, as in K1 (split_fold.cuh): the grid's surplus blocks leave here
  const int64_t cur_len = split_fold::live_length(a.cur_len, a.max_len);
  const int64_t plan_len = cur_len;
  const split_fold::Plan fold = split_fold::plan_for(a.fold, (plan_len + kTile - 1) / kTile);
  if (split >= fold.nsplit) return;

  const int64_t tiles = (cur_len + kTile - 1) / kTile;
  const int64_t row0 = (split * tiles / fold.nsplit) * kTile;
  int64_t row1 = ((split + 1) * tiles / fold.nsplit) * kTile;
  row1 = row1 < cur_len ? row1 : cur_len;
  const uint32_t code_bytes = static_cast<uint32_t>(H * D);   // int8 codes of a row
  const uint32_t row_bytes = F == kI4 ? code_bytes / 2 : code_bytes;
  const int64_t plane_rows = a.L * a.B * a.S;
  const int64_t first = (a.layer * a.B + b) * a.S;   // flat row 0 of (layer, b)
  const unsigned char* kp = a.kv + first * row_bytes;
  const unsigned char* vp = kp + plane_rows * row_bytes;
  const float* ksp = a.scales + first;
  const float* vsp = ksp + plane_rows;

  row_stream::RingT<true> ring;
  ring.init(smem, bars, ring_depth(F), kTile, row_bytes, 0, kp, vp, row0, row1, ksp, vsp);
  unsigned char* stage = smem + ring.depth * ring.slot_size;   // int4: the tile, a byte a code

  float qf[CB];
  {
    const QT* q = static_cast<const QT*>(a.q) + (b * H + h) * D + c * CB;
#pragma unroll
    for (int j = 0; j < CB; ++j) qf[j] = to_float(q[j]);
  }

  float m_run = -INFINITY;
  float l_run = 0.f;
  float acc[CB];
#pragma unroll
  for (int j = 0; j < CB; ++j) acc[j] = 0.f;

  // logits in the log2 domain: exp(x) = 2^(x log2 e); m is written back as m ln 2
  const float scale2 = a.scale * 1.4426950408889634f;
  // One tile of `rows` rows: codes at `codes` (K; V a plane later, rows
  // at code_bytes), scales ks / vs.
  auto attend = [&](const unsigned char* codes, uint32_t plane, int rows, const float* ks,
                    const float* vs) {
    const unsigned char* kc = codes + h * D + c * CB;   // this lane's chunk of row 0
    const unsigned char* vc = kc + plane;

    float logit[RPL];
    float m_tile = -INFINITY;
#pragma unroll
    for (int it = 0; it < RPL; ++it) {
      const int rr = g + it * G;
      const bool live = rr < rows;
      float dot = 0.f;
      if (live) {
        float kf[CB];
        load_codes<F, CB>(kc + rr * code_bytes, kf);
#pragma unroll
        for (int e = 0; e < CB; ++e) dot = fmaf(qf[e], kf[e], dot);
      }
#pragma unroll
      for (int off = 1; off < NCH; off <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      logit[it] = live ? dot * scale2 * ks[rr] : -INFINITY;
      m_tile = fmaxf(m_tile, logit[it]);
    }
#pragma unroll
    for (int off = NCH; off < 32; off <<= 1)
      m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, off));

    const float m_new = fmaxf(m_run, m_tile);   // finite: row 0 of a tile is live
    float p[RPL];
    float psum = 0.f;
#pragma unroll
    for (int it = 0; it < RPL; ++it) {
      const int rr = g + it * G;
      const bool live = rr < rows;
      const float e = live ? quant_codes::ex2(logit[it] - m_new) : 0.f;
      psum += e;                                  // the sum of the unscaled p
      float pv = live ? e * vs[rr] : 0.f;         // a select: vs past the rows may be NaN
      if constexpr (kLowP) pv = __bfloat162float(__float2bfloat16_rn(pv));
      p[it] = pv;
    }
#pragma unroll
    for (int off = NCH; off < 32; off <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
    const float corr = quant_codes::ex2(m_run - m_new);   // 0 on the first tile
    l_run = l_run * corr + psum;
    m_run = m_new;
#pragma unroll
    for (int j = 0; j < CB; ++j) acc[j] *= corr;

#pragma unroll
    for (int it = 0; it < RPL; ++it) {
      const int rr = g + it * G;
      if (rr < rows) {
        float vf[CB];
        load_codes<F, CB>(vc + rr * code_bytes, vf);
#pragma unroll
        for (int e = 0; e < CB; ++e) acc[e] = fmaf(p[it], vf[e], acc[e]);
      }
    }
  };

  for (int i = 0; i < ring.ntiles; ++i) {
    int rows;
    const unsigned char* slot = ring.acquire(i, &rows);
    if constexpr (kCutMath) continue;
    const float* ks = ring.side(slot);
    if constexpr (F == kI4) {
      if constexpr (!kCutUnpack) {
        quant_codes::unpack_int4_tile(slot, ring.plane_bytes, stage, kTile * code_bytes,
                                      code_bytes, rows, static_cast<int>(row_bytes / 4));
        __syncthreads();
      }
      attend(stage, kTile * code_bytes, rows, ks, ks + ring.side_stride() / 4);
    } else {
      attend(slot, ring.plane_bytes, rows, ks, ks + ring.side_stride() / 4);
    }
  }

  // sum the G row groups of the accumulator, in a fixed order
#pragma unroll
  for (int off = NCH; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < CB; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  }
  const int slots = fold.nsplit + fold.ngroups;
  const int64_t slot = (b * slots + split) * H + h;
  if (g == 0) {
    float* o = a.fold.o_part + slot * D + c * CB;
#pragma unroll
    for (int e = 0; e < CB; ++e) o[e] = acc[e];
  }
  if (lane == 0) {
    a.fold.ml_part[2 * slot] = m_run * 0.6931471805599453f;   // natural domain for the fold
    a.fold.ml_part[2 * slot + 1] = l_run;
  }
  if constexpr (!kCutFold) {
    split_fold::finish<QT, D, true>(fold, b, split, H, static_cast<QT*>(a.out) + b * H * D);
  }
}

template <int F, typename QT, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int64_t tiles = (a.max_len + kTile - 1) / kTile;
  const int64_t code_bytes = a.H * D;
  if (a.H < 1 || a.H > kMaxHeads || code_bytes % 32 || a.S % 4 || a.cur_len == nullptr ||
      a.max_len < 1 || a.max_len > a.S || a.fold.nsplit < 1 ||
      a.fold.nsplit > tiles || a.fold.nsplit > 65535 || a.fold.group < 1 ||
      a.fold.ngroups != (a.fold.nsplit + a.fold.group - 1) / a.fold.group)
    return cudaErrorInvalidValue;
  const int64_t bytes = smem_bytes(F, code_bytes);
  if (bytes > row_stream::kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = quant_split_kernel<F, QT, D>;
  static int64_t opted_in[row_stream::kMaxDevices] = {};   // one record an instantiation
  const cudaError_t opt = row_stream::opt_in_smem(kernel, bytes, opted_in);
  if (opt != cudaSuccess) return opt;
  const dim3 grid(static_cast<unsigned>(a.B), static_cast<unsigned>(a.fold.nsplit));
  kernel<<<grid, 32 * static_cast<unsigned>(a.H), static_cast<size_t>(bytes), stream>>>(a);
  return cudaGetLastError();
}

template <int F, typename QT>
cudaError_t dispatch_d(const Args& a, int64_t D, cudaStream_t stream) {
  switch (D) {
    case 8:  // small_test_config (hidden 32, 4 heads)
      return launch<F, QT, 8>(a, stream);
    case 64:  // the 350M model (hidden 1024, 16 heads)
      return launch<F, QT, 64>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, loaded with ctypes. fmt: 2 = int8 codes (K2), 3 = int4
// plane words (K3); qdtype: 0 = float32, 1 = bfloat16. S % 4 == 0 (the
// scales' copies) and H*D % 32 == 0. cur_len points to the live length,
// an int32 in device memory (clamped to max_len, 1 <= max_len <= S). The
// grid is nsplit splits a batch row (at most one a 32-row tile of max_len
// rows), folded in groups of `group`; the kernel runs the live length's
// plan inside it, as K1. o_part is
// (B, nsplit + ngroups, H, D) f32, ml_part (B, nsplit + ngroups, H, 2)
// f32, counters at least B * (1 + ngroups) int32, all 0 between calls.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mt_decode_attention_quant(const void* q, const void* kv, const void* scales,
                                         void* out, void* o_part, void* ml_part, void* counters,
                                         const void* cur_len, int fmt, int qdtype, int64_t B,
                                         int64_t H, int64_t D, int64_t L, int64_t S,
                                         int64_t layer, int64_t max_len, int64_t nsplit,
                                         int64_t group, void* stream) {
  Args a;
  a.q = q;
  a.kv = static_cast<const unsigned char*>(kv);
  a.scales = static_cast<const float*>(scales);
  a.out = out;
  a.fold.o_part = static_cast<float*>(o_part);
  a.fold.ml_part = static_cast<float*>(ml_part);
  a.fold.counters = static_cast<int*>(counters);
  a.fold.nsplit = static_cast<int>(nsplit);
  a.fold.group = static_cast<int>(group);
  a.fold.ngroups = group > 0 ? static_cast<int>((nsplit + group - 1) / group) : 0;
  a.B = B;
  a.H = H;
  a.L = L;
  a.S = S;
  a.layer = layer;
  a.cur_len = static_cast<const int32_t*>(cur_len);
  a.max_len = max_len;
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (fmt == kI8 && qdtype == 0) err = dispatch_d<kI8, float>(a, D, st);
  if (fmt == kI8 && qdtype == 1) err = dispatch_d<kI8, __nv_bfloat16>(a, D, st);
  if (fmt == kI4 && qdtype == 0) err = dispatch_d<kI4, float>(a, D, st);
  if (fmt == kI4 && qdtype == 1) err = dispatch_d<kI4, __nv_bfloat16>(a, D, st);
  return static_cast<int>(err);
}

extern "C" const char* mt_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
