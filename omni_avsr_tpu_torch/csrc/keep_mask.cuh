// The attention-dropout keep mask shared by the flash forward (B3) and the
// flash backward (B4), so the two cannot drift apart: the TPU kernels'
// `_keep_mask` (`omni_avsr_tpu/ops/flash_attention.py:30-55`), a murmur3
// finalizer over (q * seq_k + k) + h * 0x9E3779B9, xor the seed, where h is
// the flattened batch * Hq + head index, compared as a signed 32-bit value
// with thresh = round(rate * 2^32 - 2^31). It is computed in uint32_t,
// whose overflow wraps as XLA's int32 arithmetic does. `h_mix` is
// h * 0x9E3779B9, computed once per block.

#pragma once

#include <stdint.h>

namespace port {

__device__ __forceinline__ bool keep_elem(uint32_t q, uint32_t k, uint32_t seq_k,
                                          uint32_t h_mix, uint32_t seed, int32_t thresh) {
  uint32_t x = q * seq_k + k + h_mix;
  x ^= seed;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return (int32_t)x >= thresh;
}

}  // namespace port
