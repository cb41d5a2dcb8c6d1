// Block accumulation: hand-written CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel joltqc_tpu/ops/accum_pallas.py
// (block_accumulate_pallas / _accum_kernel, pl.pallas_call at :124), the
// exact segment sum of the J/K engine's accum='block' mode:
//     out[r, f] = sum over tasks t with key[t] == r of values[t, f],
// tasks with key[t] < 0 or key[t] >= nrows dropped (pad tasks and empty
// group slots carry such keys).  The result is the (nrows, nf, 3) int64
// limb sums at a static exponent, which the engine adds into its Fock
// accumulator as integers, without decoding in between.
// Plain version: joltqc_tpu_torch/ops/accum.py::block_accumulate_plain.
//
// What bounds it on the card: bytes first (each value read once, 4 or 8
// bytes, 4 bytes of key per task, 24 bytes per distinct output element),
// then the throughput of 64-bit atomics on few addresses: the plan sorts
// tasks by shell tile, so neighbouring tasks carry the same key and their
// adds meet on the same element, as in accum_tile.cu.  A per-block
// partial sum in shared memory would take most of those adds off global
// memory; this first version does not do it.
//
// Design:
//  - values arrives as the (T, nf) task-major result of a batched
//    product, contiguous, so f is the fast axis in memory.  One thread per
//    element in flat order i = t * nf + f puts f along threadIdx.x: the
//    loads of a warp are one contiguous run (fully coalesced), and the nf
//    threads of one task add to 24-byte neighbours of one output row.
//    Threads along t would read with stride nf and put a warp's 32 adds
//    on the few rows the sorted keys share;
//  - exactness and determinism: the TPU kernel peels values into 7-bit
//    limbs and sums them with a bf16 one-hot matmul in a fixed order.
//    Here the value, scaled by 2^(120 - e) against the static bound 2^e,
//    is split into three 40-bit limbs of one sign and added with 64-bit
//    integer atomics (limbs.cuh); integer addition is associative, so the
//    sums are bit-identical in any order.  The T * 127 < 2^24 and
//    T % 128 limits of the TPU kernel are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "limbs.cuh"

namespace {

template <typename R>
__global__ void __launch_bounds__(256) accum_block_kernel(
    const R* __restrict__ values, const int* __restrict__ key,
    unsigned long long* acc, long long n, int nf, int nrows, int shift) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long t = i / nf;
  const int f = (int)(i - t * nf);
  const int r = key[t];
  if (r < 0 || r >= nrows) return;
  jqc::add_limbs(acc + ((long long)r * nf + f) * 3, (double)values[i], shift);
}

}  // namespace

// values (T, nf) contiguous in dtype (0 = float32, 1 = float64); key (T,)
// int32; acc (nrows, nf, 3) int64 limb sums, updated in place.
extern "C" int jqc_accum_block_launch(int dtype, const void* values,
                                      const int* key, void* acc, long long T,
                                      int nf, int nrows, int shift,
                                      void* stream) {
  if (T <= 0 || nf <= 0 || nrows <= 0) return 0;
  const long long n = T * nf;
  const long long nblk = (n + 255) / 256;
  if (nblk > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* a = static_cast<unsigned long long*>(acc);
  if (dtype == 0)
    accum_block_kernel<float><<<(unsigned)nblk, 256, 0, st>>>(
        static_cast<const float*>(values), key, a, n, nf, nrows, shift);
  else
    accum_block_kernel<double><<<(unsigned)nblk, 256, 0, st>>>(
        static_cast<const double*>(values), key, a, n, nf, nrows, shift);
  return (int)cudaGetLastError();
}
