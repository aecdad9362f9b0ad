// The helpers the nibble chain K14 borrows (mm2.cuh, mont2.cu: Strided,
// OneHot16, kSqrMaxLimbs).  K8-K13 and K15 run on the cooperative
// 32-bit-word routine of csrc/coop.cuh (a group of lanes a column, words
// in registers); K3, K4 and K7 on the tile of csrc/mm3_tile.cuh.
//
// Layout: limbs-major (L, B) uint32 tensors holding 16-bit limbs; one
// thread owns one column (one big number) and walks its limbs at a row
// stride, so a warp's loads of one limb row are coalesced.

#pragma once

#include <cstddef>
#include <cstdint>

namespace cios {

// Limb i of a column stored at row stride s.
struct Strided {
  const uint32_t* p;
  int s;
  __device__ __forceinline__ uint32_t operator()(int i) const {
    return p[i * s];
  }
};

// Limb i of table entry d, selected without indexing by d: all 16
// entries (planes `plane` apart, row stride s) are read and the one
// whose index equals d is kept by mask.  The addresses a thread touches
// do not depend on d (the TPU kernels' one-hot select).
struct OneHot16 {
  const uint32_t* tab;
  size_t plane;
  int s;
  int d;
  __device__ __forceinline__ uint32_t operator()(int i) const {
    uint32_t v = 0u;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const uint32_t mask = 0u - static_cast<uint32_t>(e == d);
      v |= tab[e * plane + static_cast<size_t>(i) * s] & mask;
    }
    return v;
  }
};

// Largest L at which the nibble chain K14 (mm2.cuh) squares through its
// squaring routine (the TPU kernels' PRESHIFT_MAX_L, pallas_mont2.py:63):
// 2L words then fit the product's scratch.
constexpr int kSqrMaxLimbs = 192;

}  // namespace cios
