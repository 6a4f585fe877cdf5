// The word-level conversions between the three layouts of a binary row,
// shared by K1 (bitpack.cu), K2's packed-row load and store (morph_bits.cu)
// and K6's stores (bitboard_fixpoints.cu).
//
// Packed rows: 8 px a byte, MSB first (np.packbits); a row of w px is
// ceil(w/8) bytes, so rows are not 4-byte aligned.  Bitboards: 32 px a
// 32-bit word, LSB first; bit j of word n is column 32 n + j.  Dense: one
// byte a pixel.  A board word made here has its bits at and beyond w zero,
// which K2, K5 and K6 rely on; a row or pixel written here holds only the
// bits below w.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// bits [0, w - 32 * word) of word `word` of a row of w px
__device__ __forceinline__ uint32_t valid_mask(int word, int w) {
  const int n = w - 32 * word;
  return n >= 32 ? 0xffffffffu : (n <= 0 ? 0u : ((1u << n) - 1u));
}

// the bits of each byte reversed, the bytes in place
__device__ __forceinline__ uint32_t brev_bytes(uint32_t u) { return __byte_perm(__brev(u), 0u, 0x0123); }

// Word `word` of a packed row of w px (wb = ceil(w/8) bytes) as a board
// word: the 1-4 bytes of the row that it covers, and no byte beyond them.
__device__ __forceinline__ uint32_t row_word(const uint8_t* __restrict__ row, int word, int wb, int w) {
  const uint8_t* p = row + 4 * word;
  const int nb = min(4, wb - 4 * word);
  uint32_t u = 0u;
  for (int b = 0; b < nb; ++b) u |= (uint32_t)p[b] << (8 * b);
  return brev_bytes(u) & valid_mask(word, w);
}

// Board word `word` into a packed row of w px: only its 1-4 bytes inside
// the row are written, the bits at and beyond w as zero.
__device__ __forceinline__ void store_row_word(uint8_t* __restrict__ row, int word, int wb, int w, uint32_t v) {
  const uint32_t u = brev_bytes(v & valid_mask(word, w));
  uint8_t* p = row + 4 * word;
  const int nb = min(4, wb - 4 * word);
  for (int b = 0; b < nb; ++b) p[b] = (uint8_t)(u >> (8 * b));
}

// 4 bits -> 4 bytes of 0/1: bit j lands on bit 8 j (the four shifted copies
// do not overlap, so the multiply carries nothing)
__device__ __forceinline__ uint32_t spread4(uint32_t nibble) { return (nibble * 0x00204081u) & 0x01010101u; }

// the inverse: bit 8 j of u -> bit j (bytes of 0xff or 0, as __vcmpne4
// gives them, too); the multiply puts bit 8 j on bit 24 + j and nothing
// else on bits 24-31
__device__ __forceinline__ uint32_t gather4(uint32_t u) { return ((u & 0x01010101u) * 0x01020408u) >> 24; }

// The n <= 16 px of a dense uint8 row at p from bits [0, n) of `bits`:
// `value` where a bit is set, else 0.  One 16-byte store where `vec` (p is
// 16-byte aligned) and n is 16, else n byte stores.
__device__ __forceinline__ void store_dense16(uint8_t* __restrict__ p, uint32_t bits, int n, uint32_t value,
                                              bool vec) {
  if (vec && n == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(spread4(bits & 15u) * value, spread4((bits >> 4) & 15u) * value,
                                              spread4((bits >> 8) & 15u) * value, spread4((bits >> 12) & 15u) * value);
    return;
  }
  for (int j = 0; j < n; ++j) p[j] = (uint8_t)(((bits >> j) & 1u) ? value : 0u);
}

// Board word `word` into a dense uint8 row of w px: its 1-32 pixels inside
// the row, `value` where set.
__device__ __forceinline__ void store_dense_word(uint8_t* __restrict__ row, int word, int w, uint32_t v,
                                                 uint32_t value, bool vec) {
  const int x0 = 32 * word;
  store_dense16(row + x0, v, min(16, w - x0), value, vec);
  if (w - x0 > 16) store_dense16(row + x0 + 16, v >> 16, min(16, w - x0 - 16), value, vec);
}

}  // namespace
