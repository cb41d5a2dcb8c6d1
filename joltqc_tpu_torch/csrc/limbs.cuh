// Fixed-point limb arithmetic shared by the accumulation kernels
// (accum_tile.cu, accum_block.cu).
//
// A value v with |v| < 2^e (e a static host bound, never a data-dependent
// max) is scaled by 2^shift, shift = 120 - e, and split into three 40-bit
// limbs of v's sign, |x| = l0 2^80 + l1 2^40 + l2; every step is exact in
// double.  Limbs are summed as 64-bit integers.  Integer addition is
// associative, so the limb sums are bit-identical in any order and any
// split into partial sums; an element takes 2^23 contributions of full
// size before a limb could overflow.  Zero limbs are skipped (no atomic).
// Host counterpart: joltqc_tpu_torch/ops/accum.py::split_limbs.
//
// Shared-memory windows (kernels B and D): a block adds its limbs into a
// window of int64 partial sums in shared memory (24 bytes a cell,
// kWindowBytes = 98,304 bytes in all: two blocks per SM), and flushes
// each nonzero cell with one global atomicAdd per nonzero limb.  A partial sum is a
// sum over a subset of one element's contributions, so its magnitude is
// at most the sum of all their magnitudes: it cannot overflow sooner
// than the global sum did when every limb went to global memory, and
// the two's-complement wrap of int64 addition makes the final sums the
// same bits in any case.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace jqc {

// shared-memory window of kernels B and D, bytes per block
constexpr int kWindowBytes = 98304;

// rows of kernel D's window at nf components a row (24 bytes of limb sums
// a component, a 4-byte flag a row): as many as fit, at least one
__host__ __device__ constexpr int window_rows(int nf) {
  return kWindowBytes / (24 * nf + 4) > 0 ? kWindowBytes / (24 * nf + 4)
                                          : 1;
}

// the three limbs of v * 2^shift, each of v's sign
__device__ __forceinline__ void split_limbs(double v, int shift,
                                            long long l[3]) {
  const double x = ldexp(v, shift);
  const double ax = fabs(x);
  const double l0 = trunc(ax * 0x1p-80);
  const double r1 = ax - l0 * 0x1p80;
  const double l1 = trunc(r1 * 0x1p-40);
  const double l2 = rint(r1 - l1 * 0x1p40);
  const long long sg = x < 0 ? -1 : 1;
  l[0] = sg * (long long)l0;
  l[1] = sg * (long long)l1;
  l[2] = sg * (long long)l2;
}

// a[k] += l[k] for the nonzero limbs: the three consecutive int64 limb
// sums of one accumulator element in global memory
__device__ __forceinline__ void atomic_add_limbs(unsigned long long* a,
                                                 const long long l[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (l[k] != 0) atomicAdd(a + k, (unsigned long long)l[k]);
}

// a: the three consecutive int64 limb sums of one accumulator element
__device__ __forceinline__ void add_limbs(unsigned long long* a, double v,
                                          int shift) {
  long long l[3];
  split_limbs(v, shift, l);
  atomic_add_limbs(a, l);
}

// The shared window holds each int64 limb sum of a cell as two 32-bit
// words, lo and hi, in six planes (word 2k: lo of limb k, 2k + 1: hi;
// cell c of plane p at win[p * ncell + c]).  A limb v is added to lo
// with a native 32-bit shared atomicAdd; a wrap of lo (old + (u32)v <
// old) carries one into hi, which takes (v >> 32) + carry.  lo is then
// the sum of the low words modulo 2^32 and hi counts every wrap, so hi *
// 2^32 + lo is the int64 sum modulo 2^64, as a 64-bit atomic would have
// it, in any order.  (A 64-bit shared atomicAdd compiles to a
// compare-and-swap loop on sm_90, ATOMS.CAST.SPIN.64, which retries
// under contention.)
__device__ __forceinline__ void window_atomic_add(unsigned* win, int ncell,
                                                  int cell,
                                                  const long long l[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (l[k] == 0) continue;
    const unsigned lo = (unsigned)l[k];
    const unsigned old = atomicAdd(win + 2 * k * ncell + cell, lo);
    const unsigned hi = (unsigned)(l[k] >> 32) + (old + lo < old ? 1u : 0u);
    if (hi != 0) atomicAdd(win + (2 * k + 1) * ncell + cell, hi);
  }
}

// the three int64 limb sums of window cell c
__device__ __forceinline__ void window_read(const unsigned* win, int ncell,
                                            int c, long long l[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    l[k] = (long long)(((unsigned long long)win[(2 * k + 1) * ncell + c]
                        << 32) | win[2 * k * ncell + c]);
}

__device__ __forceinline__ void window_clear(unsigned* win, int ncell,
                                             int c) {
#pragma unroll
  for (int p = 0; p < 6; ++p) win[p * ncell + c] = 0;
}

// floor of i to a multiple of w (w > 0)
__device__ __forceinline__ int floor_to(int i, int w) {
  const int r = i % w;
  return i - (r < 0 ? r + w : r);
}

// Host: let `kernel` take `smem` bytes of dynamic shared memory, and cut
// n tasks into *nblocks runs of *per_block (at least `threads`), so that
// a grid of grid_y rows holds at most one block for each block of
// `threads` the card runs at once (one wave: each block zeroes and
// flushes its window once).  An error (a window the card cannot hold) is
// returned, never worked around.
inline cudaError_t plan_blocks(const void* kernel, int threads, size_t smem,
                               long long n, int grid_y, long long* per_block,
                               long long* nblocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev, sms, fit;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (fit < 1) return cudaErrorInvalidConfiguration;
  // rounded down: a second, part-filled wave of long blocks would double
  // the kernel's time
  long long want = (long long)sms * fit / grid_y;
  if (want < 1) want = 1;
  long long per = (n + want - 1) / want;
  if (per < threads) per = threads;
  *per_block = per;
  *nblocks = (n + per - 1) / per;
  return cudaSuccess;
}

}  // namespace jqc
