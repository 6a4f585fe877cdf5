// One bit-sliced Zhang-Suen subpass on a 32-pixel word, shared by K6
// (bitboard_fixpoints.cu) and K12 (zs_dense.cu).
//
// Boards hold 32 pixels per word, LSB-first: bit j of word w is column
// 32*w + j.  The counts of chip_smoke.py (ZS_OPS_PER_WORD) are taken from
// zs_word below.

#pragma once

#include <stdint.h>

namespace {

// The three words of one row around word w: left, mid, right.
struct Row3 {
  uint32_t left, mid, right;
};

// Bit j of the result = bit j+dx of the row; east (dx=+1) is a right shift
// with the carry from the next word.
__device__ __forceinline__ uint32_t shifted(const Row3& q, int dx) {
  if (dx > 0) return (q.mid >> 1) | (q.right << 31);
  if (dx < 0) return (q.mid << 1) | (q.left >> 31);
  return q.mid;
}

__device__ __forceinline__ void full_add(uint32_t a, uint32_t b, uint32_t c, uint32_t& s,
                                         uint32_t& carry) {
  uint32_t ab = a ^ b;
  s = ab ^ c;
  carry = (a & b) | (c & ab);
}

// One Zhang-Suen subpass on the word rows[1].mid, from the rows above (0),
// at (1) and below (2): the word with its deletable pixels cleared.  FIRST
// selects the direction test; ROTATED negates the ring offsets (stage 04's
// 180-degree ring).
template <bool FIRST, bool ROTATED>
__device__ __forceinline__ uint32_t zs_word(const Row3 (&rows)[3]) {
  // P2..P9: N, NE, E, SE, S, SW, W, NW as (dy, dx); negated when ROTATED
  const int ring_dy[8] = {-1, -1, 0, 1, 1, 1, 0, -1};
  const int ring_dx[8] = {0, 1, 1, 1, 0, -1, -1, -1};
  const int s = ROTATED ? -1 : 1;
  uint32_t n[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) n[k] = shifted(rows[s * ring_dy[k] + 1], s * ring_dx[k]);

  // B = neighbour count, bit-sliced through carry-save adders; 2 <= B <= 6
  uint32_t s1, c1, s2, c2, b0, c4, s5, c5;
  full_add(n[0], n[1], n[2], s1, c1);
  full_add(n[3], n[4], n[5], s2, c2);
  uint32_t s3 = n[6] ^ n[7], c3 = n[6] & n[7];
  full_add(s1, s2, s3, b0, c4);
  full_add(c1, c2, c3, s5, c5);
  uint32_t b1 = s5 ^ c4, c6 = s5 & c4;
  uint32_t b2 = c5 ^ c6, b3 = c5 & c6;
  uint32_t b_ok = (b1 | b2 | b3) & ~(b3 | (b2 & b1 & b0));

  // A == 1: exactly one 0->1 transition around the ring
  uint32_t any = ~n[0] & n[1], two = 0u;
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    uint32_t t = ~n[k] & n[(k + 1) % 8];
    two |= any & t;
    any |= t;
  }
  uint32_t a1 = any & ~two;

  uint32_t p2 = n[0], p4 = n[2], p6 = n[4], p8 = n[6];
  uint32_t dir_ok = FIRST ? (~(p2 & p4 & p6) & ~(p4 & p6 & p8))
                          : (~(p2 & p4 & p8) & ~(p2 & p6 & p8));
  return rows[1].mid & ~(a1 & b_ok & dir_ok);
}

}  // namespace
