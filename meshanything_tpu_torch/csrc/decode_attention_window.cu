// K4 at head width 64 on Hopper: the lookahead window's attention on
// tensor cores, over a bf16 cache (window_split_kernel) and over the fast
// tier's int8 and int4 caches with bf16 queries (quant_window_kernel,
// after it; its own notes are there).
//
// Replaces the TPU kernel
//   meshanything_tpu/ops/decode_attention.py::_flash_decode_kernel
// with win_kv set (decode_attention_mq_impl, from the window forward of
// models/lookahead.py), for the exact tier's bf16 cache at the 350M
// model's head width: the W <= 16 window queries of batch row b see the
// confirmed cache rows [0, base[b]) of the (2, L, B, S, H*D) cache and
// then the W window rows as one causal tile (query w sees window rows
// 0..w). The f32 cache, the quantized caches with f32 queries and the
// small config's head width stay with decode_attention_fast.cu
// (ops/decode_attention.py::mq_kernel_for routes).
//
// The quantized instances keep the TPU kernel's quantized contract
// (decode_attention.py:280-347 there): logit = (q . codes) / sqrt(D) *
// k_scale[s] in f32; the running sum takes the unscaled p; then
// p *= v_scale[s], rounded to bf16 (`lowp`); P.V in f32; one cast. The
// codes are exact in bf16, so QK on bf16 tensor cores is the TPU
// kernel's arithmetic up to summation order, and P as one bf16 term is
// its lowp P exactly. Their bound is the bytes of the codes and scales
// (int8: 245 MB at B=16, base 7450; int4 half the codes); the codes are
// widened on CUDA cores (quant_codes.cuh, two instructions a code), the
// scales ride the row stream's ring (RingT<true>), and an int4 tile is
// unpacked once by the whole block into padded int8 rows, since each of
// its words holds columns of eight heads.
//
// Numerics, the exact tier's contract: logits accumulate in f32 and are
// scaled by 1/sqrt(D) after the dot; the online-softmax statistics are
// f32; P.V is taken with P to f32 accuracy; out = acc / max(l, 1e-30) is
// cast to bf16 once. q and K are bf16, so every product of the QK mma is
// exact in f32. V is bf16 and P is not: P is split into bf16 terms,
// p0 = bf16(p) and p1 = bf16(p - p0), one mma a term into the same f32
// accumulator. Each product is exact and what is left out is below
// 2^-17 of p, under the output's bf16 rounding. The running sum is built
// from the f32 p, not from the terms.
//
// What bounds it on this card: the bytes of the live cache rows, as K1
// (2 * B * base * H * D * 2 bytes: 489 MB at B=16, base 7450); the W-fold
// arithmetic is 8.4 GFLOP at W=8, B=16, 8 us of the tensor cores' time.
// What the design does about it:
//   * the rows come through the TMA ring of row_stream.cuh (whole flat
//     rows, K and V of a 16-row tile in flight together, two tiles ahead;
//     one copy a row, which lands padded, for ldmatrix), one block a
//     (batch row, split of the context);
//   * one warp a head. Per tile it takes S = Q K^T (16 x 16 over D = 64)
//     as eight mma.sync.m16n8k16 with K read by ldmatrix as it lies (a
//     row-major K tile is the `col` B operand), the softmax statistics in
//     the accumulator's own register layout (quad shuffles: no shared
//     memory, no block-wide barrier), and O += P V as sixteen mma with V
//     read by ldmatrix.trans. The Q fragments are loaded once a block and
//     stay in registers; W is padded to the mma's 16 rows with zero rows;
//   * why mma.sync and not wgmma: wgmma's M is 64 and a head has at most
//     16 query rows. Four heads stacked into one M=64 tile would need a
//     block-diagonal query (each head's rows against its own 64 columns),
//     which is the TPU kernel's lane-tiling workaround, three quarters of
//     its products zeros;
//   * the window tile is one more split, masked causally in the
//     accumulator layout; rows of a ragged tile that were not copied are
//     masked to -inf in S, and zeroed in the V slot before the product,
//     because under mma a P of 0 times a stale NaN is NaN;
//   * base[b] stays on the card. A block takes its share of the tiles
//     below base[b] (balanced to within a tile), so the host sizes the
//     grid from the cache's length, without reading base, and rows past
//     base[b] are never requested;
//   * the combine is folded in (split_fold.cuh): one launch a call.
// The kernel allocates nothing and does not synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "quant_codes.cuh"
#include "row_stream.cuh"
#include "split_fold.cuh"

namespace {

constexpr int kD = 64;         // head width
constexpr int kTile = 16;      // cache rows a tile: the k of the P.V mma
constexpr int kMaxHeads = 16;  // one warp a head
constexpr int kMaxWindow = 16; // the m of the mma

struct Args {
  const __nv_bfloat16* q;      // (B, W, H, D)
  const __nv_bfloat16* kv;     // (2, L, B, S, H*D)
  const int32_t* base;         // (B,) confirmed rows of each batch row
  const __nv_bfloat16* win_k;  // (B, W, H*D) window rows
  const __nv_bfloat16* win_v;
  __nv_bfloat16* out;          // (B, W, H, D)
  split_fold::Plan fold;       // the last of the nsplit splits also takes the window tile
  int64_t B, W, H, L, S, layer;
  float scale;
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// (lo, hi) as two bf16 in one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// p -> its bf16 head in `head`, and returns what the head leaves out
__device__ __forceinline__ float split_head(float p, float* head) {
  *head = __bfloat162float(__float2bfloat16_rn(p));
  return p - *head;
}

// One block = batch row b and one split: its share of the cache tiles
// below base[b], or (the last split) the window tile. One warp a head.
__global__ void __launch_bounds__(32 * kMaxHeads, 1) window_split_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[row_stream::kMaxDepth];

  const int64_t b = blockIdx.x;
  const int split = blockIdx.y;
  const int H = static_cast<int>(a.H);
  const int W = static_cast<int>(a.W);
  const int h = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;     // the fragment's row (and row g + 8)
  const int tig = lane & 3;    // the fragment's column pair
  const int nsplit_cache = a.fold.nsplit - 1;
  const bool windowed = split == nsplit_cache;
  const uint32_t row_bytes = static_cast<uint32_t>(H * kD * 2);

  const unsigned char* kp;
  const unsigned char* vp;
  int64_t row0, row1;
  if (windowed) {
    kp = reinterpret_cast<const unsigned char*>(a.win_k) + b * W * row_bytes;
    vp = reinterpret_cast<const unsigned char*>(a.win_v) + b * W * row_bytes;
    row0 = 0;
    row1 = W;
  } else {
    int64_t n = a.base[b];
    n = n < 0 ? 0 : n < a.S ? n : a.S;
    const int64_t tiles = (n + kTile - 1) / kTile;
    row0 = (split * tiles / nsplit_cache) * kTile;
    row1 = ((split + 1) * tiles / nsplit_cache) * kTile;
    row1 = row1 < n ? row1 : n;
    const int64_t first = (a.layer * a.B + b) * a.S;   // flat row 0 of (layer, b)
    kp = reinterpret_cast<const unsigned char*>(a.kv) + first * row_bytes;
    vp = kp + a.L * a.B * a.S * row_bytes;
  }

  const int slots = a.fold.nsplit + a.fold.ngroups;
  // partial rows of this (b, split): hw = w * H + h
  const int64_t part0 = (b * slots + split) * W * H;
  float m_run[2] = {-INFINITY, -INFINITY};   // rows g and g + 8
  float l_run[2] = {0.f, 0.f};
  float o[8][4];
#pragma unroll
  for (int nd = 0; nd < 8; ++nd)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[nd][j] = 0.f;

  if (row1 > row0) {   // the same for the whole block
    row_stream::Ring ring;
    ring.init(smem, bars, row_stream::kDepth, kTile, row_bytes, row_stream::kRowPad, kp, vp, row0, row1);

    // Q as the A operand: four k-steps of 16 columns; rows past W are zero
    uint32_t qa[4][4];
    {
      const uint32_t* q0 = reinterpret_cast<const uint32_t*>(a.q + ((b * W + g) * H + h) * kD);
      const uint32_t* q1 = reinterpret_cast<const uint32_t*>(a.q + ((b * W + g + 8) * H + h) * kD);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        qa[ks][0] = g < W ? q0[8 * ks + tig] : 0u;
        qa[ks][1] = g + 8 < W ? q1[8 * ks + tig] : 0u;
        qa[ks][2] = g < W ? q0[8 * ks + 4 + tig] : 0u;
        qa[ks][3] = g + 8 < W ? q1[8 * ks + 4 + tig] : 0u;
      }
    }
    // ldmatrix: lane l gives the address of row l % 8 of matrix l / 8
    const int mrow = lane & 7;
    const int mi = lane >> 3;

    for (int i = 0; i < ring.ntiles; ++i) {
      int rows;
      unsigned char* slot = ring.acquire(i, &rows);
      const uint32_t k_addr = row_stream::smem_addr(slot) + h * kD * 2;
      const uint32_t v_addr = k_addr + ring.plane_bytes;
      if (rows < kTile) {
        // rows that were not copied hold an earlier tile: zero this head's
        // slice of them in V (in K they only reach logits that are masked)
        unsigned char* vh = slot + ring.plane_bytes + h * kD * 2;
        for (int rr = rows; rr < kTile; ++rr)
          reinterpret_cast<uint32_t*>(vh + rr * ring.row_stride)[lane] = 0u;
        __syncwarp();
      }

      // S = Q K^T: two n-tiles of 8 cache rows
      float s[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          // matrices: columns 32 kk + 8 mi .. + 7 of rows 8 nt .. + 7:
          // b0, b1 of k-step 2 kk, then of k-step 2 kk + 1
          uint32_t kb[4];
          ldmatrix_x4(kb, k_addr + (8 * nt + mrow) * ring.row_stride + (32 * kk + 8 * mi) * 2);
          mma_bf16(s[nt], qa[2 * kk], kb[0], kb[1]);
          mma_bf16(s[nt], qa[2 * kk + 1], kb[2], kb[3]);
        }
      }

      // mask and scale; s[nt][j]: row g (j < 2) or g + 8, column 8 nt + 2 tig + (j & 1)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = 8 * nt + 2 * tig + (j & 1);
          const int w = g + 8 * (j >> 1);
          const bool valid = col < rows && (!windowed || col <= w);
          s[nt][j] = valid ? s[nt][j] * a.scale : -INFINITY;
          mx[j >> 1] = fmaxf(mx[j >> 1], s[nt][j]);
        }
      }
      // online softmax, a row's statistics in the quad that holds it
      float corr[2];
      uint32_t p0[4], p1[4];
      float ph[2][4], pl[2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
        const float m_new = fmaxf(m_run[hf], mx[hf]);   // finite: column 0 is always seen
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = expf(s[nt][2 * hf + e] - m_new);   // exp(-inf) = 0 where masked
            sum += p;
            pl[nt][2 * hf + e] = split_head(p, &ph[nt][2 * hf + e]);
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        corr[hf] = expf(m_run[hf] - m_new);   // 0 on the first tile
        l_run[hf] = l_run[hf] * corr[hf] + sum;
        m_run[hf] = m_new;
      }
      // P as the A operand of the k = 16 rows: a0 (row g, cols 2 tig ..),
      // a1 (row g + 8), a2 (row g, cols 8 + 2 tig ..), a3 (row g + 8)
      p0[0] = pack_bf16(ph[0][0], ph[0][1]);
      p0[1] = pack_bf16(ph[0][2], ph[0][3]);
      p0[2] = pack_bf16(ph[1][0], ph[1][1]);
      p0[3] = pack_bf16(ph[1][2], ph[1][3]);
      p1[0] = pack_bf16(pl[0][0], pl[0][1]);
      p1[1] = pack_bf16(pl[0][2], pl[0][3]);
      p1[2] = pack_bf16(pl[1][0], pl[1][1]);
      p1[3] = pack_bf16(pl[1][2], pl[1][3]);

      // O = O * corr + P V: eight n-tiles of 8 columns
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // matrices (transposed on load): rows 8 (mi & 1) .. + 7 of columns
        // 16 np + 8 (mi >> 1) .. + 7: b0, b1 of n-tile 2 np, then of 2 np + 1
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, v_addr + (8 * (mi & 1) + mrow) * ring.row_stride +
                                  (16 * np + 8 * (mi >> 1)) * 2);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          float(&acc)[4] = o[2 * np + t];
          acc[0] *= corr[0];
          acc[1] *= corr[0];
          acc[2] *= corr[1];
          acc[3] *= corr[1];
          mma_bf16(acc, p0, vb[2 * t], vb[2 * t + 1]);
          mma_bf16(acc, p1, vb[2 * t], vb[2 * t + 1]);
        }
      }
    }

    // the split's unnormalized accumulator: row g (and g + 8), columns 8 nd + 2 tig, + 1
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int w = g + 8 * hf;
      if (w < W) {
        float* dst = a.fold.o_part + (part0 + w * H + h) * kD + 2 * tig;
#pragma unroll
        for (int nd = 0; nd < 8; ++nd)
          *reinterpret_cast<float2*>(dst + 8 * nd) = make_float2(o[nd][2 * hf], o[nd][2 * hf + 1]);
      }
    }
  }
  if (tig == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int w = g + 8 * hf;
      if (w < W) {
        a.fold.ml_part[2 * (part0 + w * H + h)] = m_run[hf];   // -inf: a split with no rows
        a.fold.ml_part[2 * (part0 + w * H + h) + 1] = l_run[hf];
      }
    }
  }
  split_fold::finish<__nv_bfloat16, kD, true>(a.fold, b, split, W * H, a.out + b * W * H * kD);
}


// ---------------------------------------------------------------------------
// The int8 and int4 instances (K4 of the fast tier with bf16 queries).

enum QuantFmt : int { kI8 = 2, kI4 = 3 };

// Cuts for tools/quant_breakdown.py, which builds copies of this file
// with some of them on; only times mean anything then. All off here.
constexpr bool kCutMath = false;     // tiles streamed, nothing computed
constexpr bool kCutUnpack = false;   // int4 tiles not unpacked: the math reads stale codes
constexpr bool kCutConvert = false;  // codes not widened: raw words taken as bf16 pairs
constexpr bool kCutFold = false;     // the splits' partials left unfolded
constexpr int kQTile = 32;   // cache rows a tile: two k-chunks of the P.V mma

// The ring: rows as they lie, one bulk copy a plane's tile; two int8
// tiles in flight, three int4 ones. (Padded int8 rows, one copy a row,
// spared the fragment loads their bank conflicts but streamed 20% slower
// at B=16: PERF.md.) An int4 tile is unpacked into a staging tile beside
// the ring.
__host__ __device__ constexpr int quant_depth(int fmt) { return fmt == kI4 ? 4 : 3; }

// The codes in bytes 0 and 2 of x as one bf16x2: int8 codes, or the int4
// staging tile's codes biased by 8
template <int F>
__device__ __forceinline__ uint32_t codes02(uint32_t x) {
  if constexpr (F == kI4) {
    return quant_codes::biased4_02_to_bf16x2(x);
  } else {
    return quant_codes::codes02_to_bf16x2(x);
  }
}

__host__ __device__ constexpr int64_t quant_smem_bytes(int fmt, int64_t code_bytes) {
  const int64_t row_bytes = fmt == kI4 ? code_bytes / 2 : code_bytes;
  return quant_depth(fmt) * (row_stream::slot_bytes(kQTile, static_cast<uint32_t>(row_bytes), 0) +
                             row_stream::side_bytes(kQTile)) +
         (fmt == kI4 ? 2 * kQTile * code_bytes : 0);
}

struct QuantArgs {
  const __nv_bfloat16* q;      // (B, W, H, D)
  const unsigned char* kv;     // (2, L, B, S, packed) codes
  const float* scales;         // (2, L, B, 1, S)
  const int32_t* base;         // (B,)
  const unsigned char* win_k;  // (B, W, packed) window rows' codes
  const unsigned char* win_v;
  const float* win_ks;         // (B, 1, W)
  const float* win_vs;
  __nv_bfloat16* out;          // (B, W, H, D)
  split_fold::Plan fold;       // nsplit = nsplit_cache + 1: the window tile is the last split
  int64_t B, W, H, L, S, layer;
  float scale;
};

// One block = batch row b and one split of the tiles below base[b], as
// window_split_kernel, but with no block of its own for the window: the
// last split attends the W window rows after its cache tiles (copied with
// plain loads, one causal tile), so that at B=16 the grid is one wave of
// 128 blocks and no window block waits for a free SM. One warp a head.
// The codes go to the mma fragments from shared memory through
// registers, widened to bf16 there (exact: codes02_to_bf16x2, two LOP3
// and a bf16x2 subtraction a pair), with no ldmatrix: a lane loads the
// bytes that its fragments need. That is a fixed permutation of the
// operands, the same on both sides of each product:
//   * QK: in k-step ks a lane (g, tig) holds the logical columns
//     (2tig, 2tig + 1) and (2tig + 8, 2tig + 9), which are the head's
//     dimensions (d, d + 2) and (d + 1, d + 3), d = 16tig + 4ks: so one
//     16-byte load of a K row gives a lane its B fragments of all four
//     k-steps, a word a k-step, and Q's pairs are permuted to match once;
//   * P.V: the k of the product is the tile's rows in order (P comes from
//     the S accumulator as in window_split_kernel), and n-tile nd's
//     column g is the head's dimension 8g + nd: one 8-byte load from each
//     of a lane's four rows gives it its column of all eight n-tiles (a
//     byte permute pairs two rows' codes), and the output dimension
//     8(2tig + e) + nd of o[nd][e] is written back in place.
// The rows lie unpadded (a plane's tile is one bulk copy), so a K load
// meets a two-way bank conflict and a V load a four-way one: cheaper than
// the stream of one copy a row that padding would need.
// The K scale multiplies the logit after `* scale` (a whole tile of cache
// rows takes the scales as float2 from the ring and needs no mask; a
// ragged tile and the window's select them, and a column past the rows
// gets scale 0, so a NaN scale never meets a multiply), the running sum
// takes the unscaled p, and p * v_scale is packed once to bf16 as the A
// operand: one mma, which is JAX's lowp contract exactly. Logits are
// taken in the log2 domain (ex2), and m goes to the fold as m ln 2.
template <int F>
__global__ void __launch_bounds__(32 * kMaxHeads, 1) quant_window_kernel(const QuantArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[row_stream::kMaxDepth];

  const int64_t b = blockIdx.x;
  const int split = blockIdx.y;
  const int H = static_cast<int>(a.H);
  const int W = static_cast<int>(a.W);
  const int h = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int nsplit = a.fold.nsplit;
  const bool takes_window = split == nsplit - 1;   // the last split also attends the window
  const uint32_t code_bytes = static_cast<uint32_t>(H * kD);   // int8 codes of a row
  const uint32_t row_bytes = F == kI4 ? code_bytes / 2 : code_bytes;
  // the layout of a landed tile (the ring's slots) and of the int4 staging tile
  // the layout of a landed tile (the ring's slots, rows as they lie) and
  // of the int4 staging tile (a byte a code; for int8 the slot's planes)
  const uint32_t raw_plane = kQTile * row_bytes;
  const uint32_t stage_plane = kQTile * code_bytes;
  unsigned char* stage = smem + quant_depth(F) * (2 * raw_plane + row_stream::side_bytes(kQTile));

  // this split's share of the tiles below base[b], balanced to within a tile
  int64_t n = a.base[b];
  n = n < 0 ? 0 : n < a.S ? n : a.S;
  const int64_t tiles = (n + kQTile - 1) / kQTile;
  const int64_t row0 = (split * tiles / nsplit) * kQTile;
  int64_t row1 = ((split + 1) * tiles / nsplit) * kQTile;
  row1 = row1 < n ? row1 : n;

  const int slots = a.fold.nsplit + a.fold.ngroups;
  const int64_t part0 = (b * slots + split) * W * H;
  float m_run[2] = {-INFINITY, -INFINITY};   // rows g and g + 8, log2 domain
  float l_run[2] = {0.f, 0.f};
  float o[8][4];
#pragma unroll
  for (int nd = 0; nd < 8; ++nd)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[nd][j] = 0.f;

  if (row1 > row0 || takes_window) {   // the same for the whole block
    // Q as the A operand in the permuted column order; rows past W are zero.
    // A K word holds dimensions d .. d + 3 (d = 16tig + 4ks) and gives the
    // bf16 pairs (d, d + 2) and (d + 1, d + 3): so are Q's pairs laid out.
    uint32_t qa[4][4];
    {
      uint4 qr[2][2] = {};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (g + 8 * hf < W) {
          const uint4* src = reinterpret_cast<const uint4*>(
              a.q + ((b * W + g + 8 * hf) * H + h) * kD + 16 * tig);
          qr[hf][0] = src[0];
          qr[hf][1] = src[1];
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const uint32_t w[8] = {qr[hf][0].x, qr[hf][0].y, qr[hf][0].z, qr[hf][0].w,
                               qr[hf][1].x, qr[hf][1].y, qr[hf][1].z, qr[hf][1].w};
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          qa[ks][hf] = __byte_perm(w[2 * ks], w[2 * ks + 1], 0x5410u);       // d, d + 2
          qa[ks][2 + hf] = __byte_perm(w[2 * ks], w[2 * ks + 1], 0x7632u);   // d + 1, d + 3
        }
      }
    }
    // logits in the log2 domain: exp(x) = 2^(x log2 e); m is written back as m ln 2
    const float scale2 = a.scale * 1.4426950408889634f;

    // One tile of `rows` rows: codes of K at kc, V at vc (this head's
    // columns, rows at `stride`), scales ks / vs (the ring's side array,
    // or the window's own, which ends at W), causal if `windowed`.
    auto attend = [&](const unsigned char* kc, const unsigned char* vc, uint32_t stride, int rows,
                      bool windowed, const float* ks, const float* vs) {
      // S = Q K^T: four n-tiles of 8 cache rows; lane g loads row 8 nt + g
      float s[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kc + (8 * nt + g) * stride + 16 * tig);
        const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
#pragma unroll
        for (int ks4 = 0; ks4 < 4; ++ks4) {
          uint32_t b0 = words[ks4], b1 = words[ks4] >> 8;
          if constexpr (!kCutConvert) {
            b0 = codes02<F>(b0);
            b1 = codes02<F>(b1);
          }
          mma_bf16(s[nt], qa[ks4], b0, b1);
        }
      }

      // scale and mask; s[nt][j]: row g (j < 2) or g + 8, column 8 nt + 2 tig + (j & 1).
      // A whole tile of cache rows needs no mask; the ragged tile and the window do.
      float vscale[4][2];
      if (!windowed && rows == kQTile) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float2 k2 = *reinterpret_cast<const float2*>(ks + 8 * nt + 2 * tig);
          const float2 v2 = *reinterpret_cast<const float2*>(vs + 8 * nt + 2 * tig);
          const float f0 = scale2 * k2.x, f1 = scale2 * k2.y;
          s[nt][0] *= f0;
          s[nt][1] *= f1;
          s[nt][2] *= f0;
          s[nt][3] *= f1;
          vscale[nt][0] = v2.x;
          vscale[nt][1] = v2.y;
        }
      } else {
        // a column past `rows` gets scale 0: a stale or NaN scale never reaches p * vs
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * nt + 2 * tig + e;
            const float f = col < rows ? scale2 * ks[col] : 0.f;
            vscale[nt][e] = col < rows ? vs[col] : 0.f;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const bool valid = col < rows && (!windowed || col <= g + 8 * hf);
              s[nt][2 * hf + e] = valid ? s[nt][2 * hf + e] * f : -INFINITY;
            }
          }
        }
      }
      // online softmax, a row's statistics in the quad that holds it
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
      }
      float corr[2];
      float pv[4][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
        const float m_new = fmaxf(m_run[hf], mx[hf]);   // finite: column 0 is always seen
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = quant_codes::ex2(s[nt][2 * hf + e] - m_new);   // 0 where masked
            sum += p;                                   // the running sum takes the unscaled p
            pv[nt][2 * hf + e] = p * vscale[nt][e];
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        corr[hf] = quant_codes::ex2(m_run[hf] - m_new);   // 0 on the first tile
        l_run[hf] = l_run[hf] * corr[hf] + sum;
        m_run[hf] = m_new;
      }
#pragma unroll
      for (int nd = 0; nd < 8; ++nd) {
        o[nd][0] *= corr[0];
        o[nd][1] *= corr[0];
        o[nd][2] *= corr[1];
        o[nd][3] *= corr[1];
      }

      // O += P V over two k-chunks of 16 rows
#pragma unroll
      for (int kc16 = 0; kc16 < 2; ++kc16) {
        // P as the A operand: a0 (row g, cols 2 tig ..), a1 (row g + 8),
        // a2 (row g, cols 8 + 2 tig ..), a3 (row g + 8), rounded to bf16 once
        uint32_t pa[4];
        pa[0] = quant_codes::bf16x2(pv[2 * kc16][0], pv[2 * kc16][1]);
        pa[1] = quant_codes::bf16x2(pv[2 * kc16][2], pv[2 * kc16][3]);
        pa[2] = quant_codes::bf16x2(pv[2 * kc16 + 1][0], pv[2 * kc16 + 1][1]);
        pa[3] = quant_codes::bf16x2(pv[2 * kc16 + 1][2], pv[2 * kc16 + 1][3]);
        // the lane's rows 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9 of the chunk, dims 8g .. 8g + 7
        const unsigned char* vr = vc + (16 * kc16 + 2 * tig) * stride + 8 * g;
        const uint2 r0 = *reinterpret_cast<const uint2*>(vr);
        const uint2 r1 = *reinterpret_cast<const uint2*>(vr + stride);
        const uint2 r2 = *reinterpret_cast<const uint2*>(vr + 8 * stride);
        const uint2 r3 = *reinterpret_cast<const uint2*>(vr + 9 * stride);
        const uint32_t lo[2][2] = {{r0.x, r1.x}, {r2.x, r3.x}};   // dims 8g .. 8g + 3
        const uint32_t hi[2][2] = {{r0.y, r1.y}, {r2.y, r3.y}};   // dims 8g + 4 .. 8g + 7
#pragma unroll
        for (int nd = 0; nd < 8; ++nd) {
          // bytes nd % 4 of the two rows' words into bytes 0 and 2: the pair (row, row + 1)
          const uint32_t sel = (nd % 4) | ((4 + nd % 4) << 8);
          const uint32_t(&wd)[2][2] = nd < 4 ? lo : hi;
          uint32_t b0 = __byte_perm(wd[0][0], wd[0][1], sel);
          uint32_t b1 = __byte_perm(wd[1][0], wd[1][1], sel);
          if constexpr (!kCutConvert) {
            b0 = codes02<F>(b0);
            b1 = codes02<F>(b1);
          }
          mma_bf16(o[nd], pa, b0, b1);
        }
      }
    };

    const int nw = static_cast<int>(row_bytes / 4);   // int4: plane words of a row

    if (row1 > row0) {
      const int64_t plane_rows = a.L * a.B * a.S;
      const int64_t first = (a.layer * a.B + b) * a.S;   // flat row 0 of (layer, b)
      const unsigned char* kp = a.kv + first * row_bytes;
      const float* ksp = a.scales + first;
      row_stream::RingT<true> ring;
      ring.init(smem, bars, quant_depth(F), kQTile, row_bytes, 0, kp, kp + plane_rows * row_bytes,
                row0, row1, ksp, ksp + plane_rows);
      for (int i = 0; i < ring.ntiles; ++i) {
        int rows;
        const unsigned char* slot = ring.acquire(i, &rows);
        if constexpr (kCutMath) continue;
        const float* ks = ring.side(slot);
        const unsigned char* kc = slot;
        if constexpr (F == kI4) {
          if constexpr (!kCutUnpack) {
            quant_codes::unpack_int4_tile(slot, raw_plane, stage, stage_plane, code_bytes, rows,
                                          nw);
            __syncthreads();
          }
          kc = stage;
        }
        attend(kc + h * kD, kc + stage_plane + h * kD, code_bytes, rows, false, ks,
               ks + ring.side_stride() / 4);
      }
    }
    if (takes_window) {
      // the W window rows, copied by the block into the first slot with
      // plain loads (W <= 16 rows: no stream to hide), then one causal tile
      __syncthreads();   // every warp is done with the ring's last tile
      const unsigned char* wk = a.win_k + b * W * row_bytes;
      const unsigned char* wv = a.win_v + b * W * row_bytes;
      const int chunks = static_cast<int>(row_bytes / 16);
      for (int idx = threadIdx.x; idx < 2 * W * chunks; idx += blockDim.x) {
        const int plane = idx >= W * chunks;
        const int j = idx - plane * W * chunks;
        const uint4 v = *reinterpret_cast<const uint4*>((plane ? wv : wk) + 16 * j);
        *reinterpret_cast<uint4*>(smem + plane * raw_plane + 16 * j) = v;   // rows as they lie
      }
      __syncthreads();
      const unsigned char* kc = smem;
      if constexpr (F == kI4) {
        if constexpr (!kCutMath && !kCutUnpack)
          quant_codes::unpack_int4_tile(smem, raw_plane, stage, stage_plane, code_bytes, W, nw);
        __syncthreads();
        kc = stage;
      }
      if constexpr (!kCutMath) {
        attend(kc + h * kD, kc + kQTile * code_bytes + h * kD, code_bytes, W, true,
               a.win_ks + b * W, a.win_vs + b * W);
      }
    }

    // the split's unnormalized accumulator: o[nd][2 hf + e] is row g + 8 hf,
    // dimension 8 (2 tig + e) + nd: eight neighbouring floats a (hf, e)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int w = g + 8 * hf;
      if (w < W) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float4* dst = reinterpret_cast<float4*>(a.fold.o_part + (part0 + w * H + h) * kD +
                                                  8 * (2 * tig + e));
          dst[0] = make_float4(o[0][2 * hf + e], o[1][2 * hf + e], o[2][2 * hf + e],
                               o[3][2 * hf + e]);
          dst[1] = make_float4(o[4][2 * hf + e], o[5][2 * hf + e], o[6][2 * hf + e],
                               o[7][2 * hf + e]);
        }
      }
    }
  }
  if (tig == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int w = g + 8 * hf;
      if (w < W) {
        // m in the natural domain for the fold; -inf: a split with no rows
        a.fold.ml_part[2 * (part0 + w * H + h)] = m_run[hf] * 0.6931471805599453f;
        a.fold.ml_part[2 * (part0 + w * H + h) + 1] = l_run[hf];
      }
    }
  }
  if constexpr (!kCutFold) {
    split_fold::finish<__nv_bfloat16, kD, true>(a.fold, b, split, W * H, a.out + b * W * H * kD);
  }
}

template <int F>
cudaError_t launch_quant(const QuantArgs& a, cudaStream_t stream) {
  const int64_t bytes = quant_smem_bytes(F, a.H * kD);
  if (bytes > row_stream::kMaxSmem) return cudaErrorInvalidValue;
  static int64_t opted_in[row_stream::kMaxDevices] = {};
  const cudaError_t opt = row_stream::opt_in_smem(quant_window_kernel<F>, bytes, opted_in);
  if (opt != cudaSuccess) return opt;
  const dim3 grid(static_cast<unsigned>(a.B), static_cast<unsigned>(a.fold.nsplit));
  quant_window_kernel<F><<<grid, 32 * static_cast<unsigned>(a.H), static_cast<size_t>(bytes),
                           stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. bf16 throughout, D = 64, W <= 16,
// H <= 16. base (B,) int32 on the card; win_k / win_v (B, W, H*D).
// nsplit_cache splits of the rows below base[b] plus the window tile,
// folded in groups of `group`. o_part is
// (B, nsplit_cache + 1 + ngroups, W*H, D) f32, ml_part the same with 2
// for D, counters at least B * (1 + ngroups) int32, all 0 between calls.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mt_decode_attention_window(const void* q, const void* kv, const void* base,
                                          const void* win_k, const void* win_v, void* out,
                                          void* o_part, void* ml_part, void* counters, int64_t B,
                                          int64_t W, int64_t H, int64_t D, int64_t L, int64_t S,
                                          int64_t layer, int64_t nsplit_cache, int64_t group,
                                          void* stream) {
  if (D != kD || W < 1 || W > kMaxWindow || H < 1 || H > kMaxHeads || nsplit_cache < 1 ||
      nsplit_cache + 1 > 65535 || group < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kv = static_cast<const __nv_bfloat16*>(kv);
  a.base = static_cast<const int32_t*>(base);
  a.win_k = static_cast<const __nv_bfloat16*>(win_k);
  a.win_v = static_cast<const __nv_bfloat16*>(win_v);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.fold.o_part = static_cast<float*>(o_part);
  a.fold.ml_part = static_cast<float*>(ml_part);
  a.fold.counters = static_cast<int*>(counters);
  a.fold.nsplit = static_cast<int>(nsplit_cache + 1);
  a.fold.group = static_cast<int>(group);
  a.fold.ngroups = static_cast<int>((nsplit_cache + 1 + group - 1) / group);
  a.B = B;
  a.W = W;
  a.H = H;
  a.L = L;
  a.S = S;
  a.layer = layer;
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(kD)));
  const int64_t bytes =
      static_cast<int64_t>(row_stream::kDepth) *
      row_stream::slot_bytes(kTile, static_cast<uint32_t>(H * kD * 2), row_stream::kRowPad);
  if (bytes > row_stream::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static int64_t opted_in[row_stream::kMaxDevices] = {};
  const cudaError_t opt = row_stream::opt_in_smem(window_split_kernel, bytes, opted_in);
  if (opt != cudaSuccess) return static_cast<int>(opt);
  const dim3 grid(static_cast<unsigned>(B), static_cast<unsigned>(nsplit_cache + 1));
  window_split_kernel<<<grid, 32 * static_cast<unsigned>(H), static_cast<size_t>(bytes),
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mt_window_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The int8 and int4 instances: bf16 queries, D = 64, W <= 16, H <= 16.
// fmt: 2 = int8 codes, 3 = int4 plane words. scales (2, L, B, 1, S) f32
// with S % 4 == 0 (the ring copies a tile's scales in runs of 4);
// win_k / win_v (B, W, packed) codes, win_ks / win_vs (B, 1, W) f32.
// nsplit splits of the cache rows below base[b] in tiles of 32, the last
// of which also takes the window tile, folded in groups of `group`;
// o_part (B, nsplit + ngroups, W*H, D) f32, ml_part the same with 2 for
// D, counters at least B * (1 + ngroups) int32, all 0 between calls.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mt_decode_attention_window_quant(
    const void* q, const void* kv, const void* scales, const void* base, const void* win_k,
    const void* win_v, const void* win_ks, const void* win_vs, void* out, void* o_part,
    void* ml_part, void* counters, int fmt, int64_t B, int64_t W, int64_t H, int64_t D, int64_t L,
    int64_t S, int64_t layer, int64_t nsplit, int64_t group, void* stream) {
  if (D != kD || W < 1 || W > kMaxWindow || H < 1 || H > kMaxHeads || S % 4 || nsplit < 1 ||
      nsplit > 65535 || group < 1 || (fmt != kI8 && fmt != kI4))
    return static_cast<int>(cudaErrorInvalidValue);
  QuantArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kv = static_cast<const unsigned char*>(kv);
  a.scales = static_cast<const float*>(scales);
  a.base = static_cast<const int32_t*>(base);
  a.win_k = static_cast<const unsigned char*>(win_k);
  a.win_v = static_cast<const unsigned char*>(win_v);
  a.win_ks = static_cast<const float*>(win_ks);
  a.win_vs = static_cast<const float*>(win_vs);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.fold.o_part = static_cast<float*>(o_part);
  a.fold.ml_part = static_cast<float*>(ml_part);
  a.fold.counters = static_cast<int*>(counters);
  a.fold.nsplit = static_cast<int>(nsplit);
  a.fold.group = static_cast<int>(group);
  a.fold.ngroups = static_cast<int>((nsplit + group - 1) / group);
  a.B = B;
  a.W = W;
  a.H = H;
  a.L = L;
  a.S = S;
  a.layer = layer;
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(kD)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(fmt == kI8 ? launch_quant<kI8>(a, st) : launch_quant<kI4>(a, st));
}
