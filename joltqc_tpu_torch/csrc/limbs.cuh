// Fixed-point limb arithmetic shared by the accumulation kernels
// (accum_tile.cu, accum_block.cu).
//
// A value v with |v| < 2^e (e a static host bound, never a data-dependent
// max) is scaled by 2^shift, shift = 120 - e, and split into three 40-bit
// limbs of v's sign, |x| = l0 2^80 + l1 2^40 + l2; every step is exact in
// double.  Each limb is added with a 64-bit integer atomicAdd.  Integer
// addition is associative, so the limb sums are bit-identical in any
// order; an element takes 2^23 contributions of full size before a limb
// could overflow.  Zero limbs are skipped (no atomic).
// Host counterpart: joltqc_tpu_torch/ops/accum.py::split_limbs.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace jqc {

// a: the three consecutive int64 limb sums of one accumulator element
__device__ __forceinline__ void add_limbs(unsigned long long* a, double v,
                                          int shift) {
  const double x = ldexp(v, shift);
  const double ax = fabs(x);
  const double l0 = trunc(ax * 0x1p-80);
  const double r1 = ax - l0 * 0x1p80;
  const double l1 = trunc(r1 * 0x1p-40);
  const double l2 = rint(r1 - l1 * 0x1p40);
  const long long sg = x < 0 ? -1 : 1;
  if (l0 != 0.0) atomicAdd(a + 0, (unsigned long long)(sg * (long long)l0));
  if (l1 != 0.0) atomicAdd(a + 1, (unsigned long long)(sg * (long long)l1));
  if (l2 != 0.0) atomicAdd(a + 2, (unsigned long long)(sg * (long long)l2));
}

}  // namespace jqc
