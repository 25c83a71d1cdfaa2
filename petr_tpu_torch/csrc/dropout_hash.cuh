// The attention-dropout keep mask of the flash kernels, shared by the
// forward (flash_cross_attention.cu) and the backward
// (flash_cross_attention_bwd.cu).
//
// Bit for bit petr_tpu/ops/pallas/cross_attention.py::_dropout_keep: a
// murmur3-style finalizer over uint32 arithmetic of the GLOBAL query index
// (row), key index (col), the seed and b*H + h. Because the bits depend on
// nothing but those coordinates, the backward regenerates the forward's mask
// whatever its blocking, and no mask is ever stored.
#pragma once

#include <stdint.h>

// seed * 0x85EBCA6B + bh * 0xC2B2AE35 + key_offset, the part of the hash
// that is fixed for one (batch, head): uint32 addition is associative, so it
// is added once. A shard of a larger problem hashes its global coordinates:
// bh is the global b*H + h (the kernels pass their own plus bh_offset, the
// shard's first batch row times H), and key_offset, the shard's first
// global key, is the amount its local key index falls short of the global
// one, which the hash adds to the column. Both are 0 for a whole problem.
__device__ __forceinline__ uint32_t dropout_mix(uint32_t seed, uint32_t bh, uint32_t key_offset) {
  return seed * 0x85EBCA6Bu + bh * 0xC2B2AE35u + key_offset;
}

// keep = hash >= thresh, thresh = min(int(rate * 2^32), 2^32 - 1)
__device__ __forceinline__ bool dropout_keep(uint32_t mix, uint32_t row, uint32_t col,
                                             uint32_t thresh) {
  uint32_t h = row * 0x9E3779B9u + col + mix;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h >= thresh;
}
