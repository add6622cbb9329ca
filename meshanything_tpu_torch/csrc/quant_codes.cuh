// The quantized caches' codes, widened on the card without int-to-float
// conversions (a quarter-rate instruction on Hopper), for the kernels of
// decode_attention_quant.cu (K2, K3) and decode_attention_window.cu (the
// int8/int4 K4).
//
//   int8 rows: (H*D) codes in [-127, 127], column c at byte c;
//   int4 rows: (H*D)/8 32-bit "plane" words (ops/kvcache.py): column c
//     is nibble c / nw of word c % nw, nw = H*D/8, as 4-bit two's
//     complement in [-7, 7] (JAX: _unpack4 of ops/decode_attention.py).
//
// An int4 word carries columns of 8 different heads (at the 350M width,
// head h is nibble h/2 of words 64*(h%2) .. +63), so a warp a head that
// read its own columns out of the landed words would read 8x the bytes
// that came from device memory. The kernels instead unpack each landed
// int4 tile once, with the whole block (`unpack_int4_tile`: each word is
// read by one thread), into a byte a code (biased by 8) in the int8 row
// layout, and run the int8 body on them, widening the biased codes. Every
// code is exact in f32 and in bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace quant_codes {

// Four int8 codes (code j in byte j of w) as f32: the byte is biased to
// unsigned, laid into the low mantissa of 2^23 by one byte permute, and
// 2^23 + 128 taken off: exact, two instructions a code.
__device__ __forceinline__ void codes4_to_f32(uint32_t w, float (&out)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out[j] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7650u + j)) - 8388736.f;
}

// Two f32 as one bf16x2 register, lo in the low half (one cvt; exact for codes).
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// bf16x2 a - b (exact wherever the difference is a bf16 pair)
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The int8 codes in bytes 0 and 2 of x as one bf16x2 (byte 0 in the low
// half; bytes 1 and 3 are ignored), for the tensor cores: a code's low 7
// bits laid into the mantissa of 128 (0x4300 | c & 0x7f = 128 + (c & 127))
// less 128 with the code's sign bit as the exponent's last bit
// (0x4300 | c & 0x80 = 128 or 256). Exact; two LOP3 and one subtraction
// a pair.
__device__ __forceinline__ uint32_t codes02_to_bf16x2(uint32_t x) {
  return bf16x2_sub((x & 0x007f007fu) | 0x43004300u, (x & 0x00800080u) | 0x43004300u);
}

// The int4 staging tile holds each code biased by 8 (0..15) in a byte:
// bytes 0 and 2 of x as one bf16x2, 0x4300 | u = 128 + u less 136. One
// LOP3 and one subtraction a pair.
__device__ __forceinline__ uint32_t biased4_02_to_bf16x2(uint32_t x) {
  return bf16x2_sub((x & 0x000f000fu) | 0x43004300u, 0x43084308u);
}

// Four staged int4 codes (code + 8 in byte j of w) as f32, as codes4_to_f32.
__device__ __forceinline__ void biased4x4_to_f32(uint32_t w, float (&out)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out[j] = __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7650u + j)) - 8388616.f;
}

// 2^x (ex2.approx, ftz: 2 ulp; -inf gives 0). The kernels take logits in
// the log2 domain, exp(x) = 2^(x log2 e), and hand m to the fold as m ln 2.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Four neighbouring plane words w0..w3 (words j .. j + 3 of a row, j a
// multiple of 4) -> out[p] = the codes of columns p*nw + j .. + 3 biased
// by 8 (a 4-bit two's complement v is the code c; v ^ 8 = c + 8), a byte
// each, for the 8 planes p. A byte transpose (eight byte permutes) puts
// byte k of the four words into one register, whose low nibbles are plane
// 2k and high nibbles plane 2k + 1; then one LOP3 a plane (and a shift
// for the high nibbles).
__device__ __forceinline__ void words4_to_codes(uint4 w, uint32_t (&out)[8]) {
  const uint32_t ab01 = __byte_perm(w.x, w.y, 0x5140u);
  const uint32_t cd01 = __byte_perm(w.z, w.w, 0x5140u);
  const uint32_t ab23 = __byte_perm(w.x, w.y, 0x7362u);
  const uint32_t cd23 = __byte_perm(w.z, w.w, 0x7362u);
  const uint32_t y[4] = {__byte_perm(ab01, cd01, 0x5410u), __byte_perm(ab01, cd01, 0x7632u),
                         __byte_perm(ab23, cd23, 0x5410u), __byte_perm(ab23, cd23, 0x7632u)};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out[2 * k] = (y[k] & 0x0f0f0f0fu) ^ 0x08080808u;
    out[2 * k + 1] = ((y[k] >> 4) & 0x0f0f0f0fu) ^ 0x08080808u;
  }
}

// Rows [0, rows) of a landed int4 tile of both planes (K at src, V at
// src + src_plane; rows of nw words at a stride of 4*nw bytes) -> a byte
// a code, biased by 8, in the int8 row layout (K at dst, V at dst +
// dst_plane; rows of 8*nw bytes at dst_stride). Called by every thread of
// the block: a warp a (plane, row) at a time, a lane a 16-byte group of
// four words (one load, eight 4-byte stores: neighbouring lanes on
// neighbouring words), with no division. The caller puts a block barrier
// between this and the reads of dst.
__device__ __forceinline__ void unpack_int4_tile(const unsigned char* src, uint32_t src_plane,
                                                 unsigned char* dst, uint32_t dst_plane,
                                                 uint32_t dst_stride, int rows, int nw) {
  // warps over the (plane, row) pairs, lanes over a row's 16-byte groups
  const int groups = nw / 4;
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int pr = threadIdx.x >> 5; pr < 2 * rows; pr += warps) {
    const int plane = pr >= rows;
    const int r = pr - plane * rows;
    const unsigned char* from = src + plane * src_plane + r * 4 * nw;
    unsigned char* row = dst + plane * dst_plane + r * dst_stride;
    for (int g4 = lane; g4 < groups; g4 += 32) {
      uint32_t codes[8];
      words4_to_codes(*reinterpret_cast<const uint4*>(from + 16 * g4), codes);
#pragma unroll
      for (int p = 0; p < 8; ++p) *reinterpret_cast<uint32_t*>(row + p * nw + 4 * g4) = codes[p];
    }
  }
}

}  // namespace quant_codes
