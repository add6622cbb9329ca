// K4 for bf16 caches at head width 64 on Hopper: the lookahead window's
// attention on tensor cores.
//
// Replaces the TPU kernel
//   meshanything_tpu/ops/decode_attention.py::_flash_decode_kernel
// with win_kv set (decode_attention_mq_impl, from the window forward of
// models/lookahead.py), for the exact tier's bf16 cache at the 350M
// model's head width: the W <= 16 window queries of batch row b see the
// confirmed cache rows [0, base[b]) of the (2, L, B, S, H*D) cache and
// then the W window rows as one causal tile (query w sees window rows
// 0..w). The other caches (f32, int8, int4) and the small config's head
// width stay with decode_attention_fast.cu.
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
  split_fold::Plan fold;       // nsplit = nsplit_cache + 1: the window tile is the last split
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
