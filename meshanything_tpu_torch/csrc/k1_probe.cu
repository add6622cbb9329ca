// T4 on Hopper: K1's cost, part by part.
//
// Replaces the TPU kernel tools/pipe_compute_probe.py::_kernel, which is
// the TPU decode kernel's body with parts cut by `mode`. This file is the
// CUDA K1's split kernel (decode_attention.cu, included below: its body
// takes the mode as a template parameter) compiled once per mode, with
// the same parts cut:
//
//   full     everything: bit for bit K1 (the wrapper asserts it on the card);
//   tap      the K and V rows are streamed and nothing is computed; row 0 of
//            each tile of K and of V is added up:
//              out[b, h, :] = sum over tiles of K[tile row 0] + V[tile row 0]
//   qk       the QK dot, the logits and each tile's max; V streamed, tapped:
//              out = sum over tiles of (max of the tile's logits + V[tile row 0])
//   softmax  no QK dot and no P.V: logits are the constants
//            -1 + K[tile row 0, column j of the flat row], j < tile, the
//            same for every head, so K is still read; the online-softmax
//            statistics run on them:
//              acc = acc * corr + p[tile row 0] + V[tile row 0]
//   pv       the same constant logits with the full P.V product.
//
// In every mode each block requests every byte of its K and V rows from
// device memory: the copies are the TMA's, started by one warp whatever
// the mode computes, and a slot is handed on only when its barrier has
// counted all its bytes; no compiler can drop them. So the difference of
// two modes' times is the cost of the part that one of them cuts, at the
// same byte traffic. Outputs other than `full` are not normalized by the
// softmax sum (the TPU tool's are not either); tap and qk splits report
// (m, l) = (0, 1), so the fold adds them up.
//
// The tile is K1's: 16 rows of bf16 or 8 of f32, whatever tile the TPU
// kernel had. The TPU tool's machinery cuts (its flattened one-program
// schedule, SMEM scalar loads, 4-D DMA descriptors) cut things this kernel
// does not have. The cuts of this kernel's own machinery are three more
// modes, compiled here and nowhere else, and one of the launcher's:
//
//   no_fold   full with the fold skipped: the partials are the output;
//   depth1    full through a ring of one slot: no copy is in flight while
//             the block computes;
//   tap_rows  tap on the stream's other shape: one bulk copy a row, landing
//             padded, as the window kernel needs them for ldmatrix, instead
//             of one a plane's tile;
//   no context split: any mode with nsplit 1.
#include "decode_attention.cu"

namespace {

template <typename T>
cudaError_t dispatch_mode(int mode, const Args& a, cudaStream_t stream) {
  constexpr int D = 64;  // the 350M model's head; the probe is built for no other
  switch (mode) {
    case kFull:
      return launch<T, D, kFull>(a, stream);
    case kTap:
      return launch<T, D, kTap>(a, stream);
    case kQk:
      return launch<T, D, kQk>(a, stream);
    case kSoftmax:
      return launch<T, D, kSoftmax>(a, stream);
    case kPv:
      return launch<T, D, kPv>(a, stream);
    case kNoFold:
      return launch<T, D, kNoFold>(a, stream);
    case kDepth1:
      return launch<T, D, kDepth1>(a, stream);
    case kTapRows:
      return launch<T, D, kTapRows>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// mode: 0 full, 1 tap, 2 qk, 3 softmax, 4 pv, 5 no_fold, 6 depth1,
// 7 tap_rows. no_fold leaves the partials (o_part
// (B, nsplit + ngroups, H, D), ml_part (B, nsplit + ngroups, H, 2), both
// f32; the first nsplit slots are the splits') as the result. chunk must
// be K1's tile for the dtype and D 64.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mt_k1_probe(const void* q, const void* kv, void* out, void* o_part, void* ml_part,
                           void* counters, int dtype, int mode, int64_t B, int64_t H, int64_t D,
                           int64_t L, int64_t S, int64_t layer, int64_t cur_len, int64_t chunk,
                           int64_t nsplit, int64_t group, void* stream) {
  const int64_t tile = dtype == 0 ? tile_rows<float>() : tile_rows<__nv_bfloat16>();
  if (chunk != tile || D != 64 || H * D < tile) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, kv, out, o_part, ml_part, counters, B, H, D, L, S, layer, cur_len,
                           nsplit, group);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = dispatch_mode<float>(mode, a, st);
  if (dtype == 1) err = dispatch_mode<__nv_bfloat16>(mode, a, st);
  return static_cast<int>(err);
}
