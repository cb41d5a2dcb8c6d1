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
// What bounds it on the card: bytes (each value read once, 4 or 8 bytes,
// 4 bytes of key per task, 24 bytes per distinct output element).  The
// first version (one thread per element, straight to 64-bit global
// atomics) ran at 11.5x that bound: the plan sorts tasks by shell tile,
// so neighbouring tasks carry the same key and their adds met on the
// same element.  The TPU kernel summed a chunk in VMEM (a one-hot matmul)
// first; this kernel sums it in shared memory first.
//
// Design:
//  - the window: a block takes a long run of tasks and adds their limbs
//    into a window of wrows rows in shared memory, wrows =
//    limbs.cuh::window_rows(nf): the most that fit in kWindowBytes =
//    98,304 B (1293 rows at nf = 3, 113 at nf = 36).
//    The window always ends at the largest row seen: a ring of slots
//    (row base + i in slot (bslot + i) % wrows) that slides up when a
//    larger row comes, flushing only the rows that leave it (one global
//    atomicAdd per nonzero limb of each nonzero cell of a flagged row).
//    So each row is flushed once, and the cost of a slide follows the
//    rows it passes, not the window's size.  The engine's keys are
//    gslot * S^2 + (x % S) * S + y % S with gslot non-decreasing in a
//    chunk: a key falls at most S^2 - 1 rows below the largest before it,
//    inside the window wherever wrows >= S^2 (nf <= 63 at S = 8).  A
//    key below the window (another order) takes a global atomic;
//  - the walk: one thread per element in flat order i = t * nf + f, f
//    along threadIdx.x, so the loads of a warp are one contiguous run
//    (fully coalesced); 512 threads, eight elements each a step, all
//    loads first (one load in flight per thread left the first version
//    waiting on memory).  Elements whose rows lie above the window are
//    held over the step; then the window slides up to the largest of
//    them and takes them, or, where the held rows span more than the
//    window, the lower ones go to global atomics.  Exact zeros are
//    skipped;
//  - why it slides: a window placed on a group boundary and moved whole,
//    with a full flush, when a row came above it, moved every group or
//    two at nf = 36 (less than two groups in the window);
//  - the shared sums are 32-bit word pairs with native atomics and an
//    explicit carry (limbs.cuh::window_atomic_add), not the
//    compare-and-swap loop that a 64-bit shared atomicAdd compiles to;
//  - exactness and determinism: the TPU kernel peels values into 7-bit
//    limbs and sums them with a bf16 one-hot matmul in a fixed order.
//    Here the value, scaled by 2^(120 - e) against the static bound 2^e,
//    is split into three 40-bit limbs of one sign and summed as int64, in
//    the window and then in global memory (limbs.cuh).  Integer addition
//    is associative, so the sums are bit-identical in any order and to
//    the plain version's; a window's partial sum is bounded by the whole
//    sum's headroom (2^23 contributions of full size per element).  The
//    T * 127 < 2^24 and T % 128 limits of the TPU kernel are not carried
//    over.
// Build (nvcc -Xptxas -v, sm_90a): 64 registers under
// __launch_bounds__(512, 2), 36 (float) and 48 (double) bytes of spill
// stores, 16 bytes of static shared memory; the window's dynamic shared
// memory is (6 nf + 1) * wrows * 4 <= 98,304 bytes.
// Measured (PERF.md kernel table; H100 80GB HBM3 at 700 W): 0.042-0.043
// ms on the largest chunk of the 0029 block path, 4.6x the byte bound
// (the first version 10.8x), 1.2-1.26x one index_add_ of the float64
// values.  Summed over the 738 launches of a block-path get_jk it saves
// only 2-3% (16.2-16.4 ms against 16.7 ms, 22 us a launch on average).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "limbs.cuh"

namespace {

constexpr int kBlockThreads = 512;
constexpr int kBlockUnroll = 8;  // elements per thread and step
constexpr int kBlockStep = kBlockThreads * kBlockUnroll;

// The shared window holds rows [base, base + wrows): row base + i in slot
// (bslot + i) % wrows, its limb sums at cells slot * nf + f (6 words a
// cell, see limbs.cuh), and a flag per slot once the row holds a sum.
struct Ring {
  unsigned* win;   // (6, wrows * nf) words
  unsigned* flag;  // (wrows,)
  int wrows, nf;
};

__device__ __forceinline__ int ring_slot(const Ring& w, int bslot, int i) {
  const int s = bslot + i;
  return s >= w.wrows ? s - w.wrows : s;
}

// add every nonzero cell of the k rows from `base` (slots from bslot) to
// global memory and clear them; k <= wrows
__device__ void flush_rows(const Ring& w, unsigned long long* acc, int base,
                           int bslot, int k) {
  const int ncell = w.wrows * w.nf;
  for (int i = threadIdx.x; i < k * w.nf; i += blockDim.x) {
    const int ro = i / w.nf, f = i - ro * w.nf;
    const int c = ring_slot(w, bslot, ro) * w.nf + f;
    if (!w.flag[c / w.nf]) continue;
    long long l[3];
    jqc::window_read(w.win, ncell, c, l);
    if (l[0] | l[1] | l[2]) {
      jqc::atomic_add_limbs(acc + ((long long)(base + ro) * w.nf + f) * 3, l);
      jqc::window_clear(w.win, ncell, c);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += blockDim.x)
    w.flag[ring_slot(w, bslot, i)] = 0;
}

template <typename R>
__global__ void __launch_bounds__(kBlockThreads, 2) accum_block_kernel(
    const R* __restrict__ values, const int* __restrict__ key,
    unsigned long long* acc, long long T, int nf, int nrows, int shift,
    long long per_block, int wrows) {
  extern __shared__ unsigned smem[];  // window, then the slot flags
  __shared__ int top;
  const Ring w{smem, smem + 6 * wrows * nf, wrows, nf};
  const long long t0 = (long long)blockIdx.x * per_block;
  const long long t1 = min(T, t0 + per_block);
  for (int i = threadIdx.x; i < (6 * nf + 1) * wrows; i += blockDim.x)
    smem[i] = 0;
  if (threadIdx.x == 0) top = -1;
  // the window ends at the largest row seen so far
  int base = max(0, min(key[t0], nrows - 1) - wrows + 1);
  int bslot = base % wrows;
  // this thread's first element (t, f); kBlockThreads elements further
  // on is (t + step_t, f + step_f), carried
  long long t = t0 + threadIdx.x / nf;
  int f = threadIdx.x % nf;
  const int step_t = kBlockThreads / nf, step_f = kBlockThreads % nf;
  __syncthreads();
  for (long long j0 = t0 * nf; j0 < t1 * nf; j0 += kBlockStep) {
    // all loads of the step first
    int r[kBlockUnroll], fu[kBlockUnroll];
    R v[kBlockUnroll];
#pragma unroll
    for (int u = 0; u < kBlockUnroll; ++u) {
      r[u] = -1;
      fu[u] = f;
      if (t < t1) {
        r[u] = key[t];
        v[u] = values[j0 + u * kBlockThreads + threadIdx.x];
      }
      t += step_t;
      f += step_f;
      if (f >= nf) {
        f -= nf;
        ++t;
      }
    }
    unsigned held = 0;  // bit u: element u's row lies above the window
#pragma unroll
    for (int u = 0; u < kBlockUnroll; ++u) {
      if (r[u] < 0 || r[u] >= nrows || v[u] == R(0)) continue;  // nothing
      if (r[u] - base >= wrows) {
        held |= 1u << u;
        continue;
      }
      long long l[3];
      jqc::split_limbs((double)v[u], shift, l);
      if (r[u] < base) {  // below the window: out of order
        jqc::atomic_add_limbs(acc + ((long long)r[u] * nf + fu[u]) * 3, l);
        continue;
      }
      const int slot = ring_slot(w, bslot, r[u] - base);
      jqc::window_atomic_add(w.win, wrows * nf, slot * nf + fu[u], l);
      w.flag[slot] = 1;
    }
    if (__syncthreads_or(held != 0)) {
      // slide the window up to the largest held row: flush the rows that
      // leave it
      int m = -1;
#pragma unroll
      for (int u = 0; u < kBlockUnroll; ++u)
        if (held >> u & 1u) m = max(m, r[u]);
      m = __reduce_max_sync(0xffffffffu, m);
      if ((threadIdx.x & 31) == 0) atomicMax(&top, m);
      __syncthreads();
      const int nb = top - wrows + 1;
      flush_rows(w, acc, base, bslot, min(nb - base, wrows));
      bslot = (int)((bslot + (long long)(nb - base)) % wrows);
      base = nb;
      __syncthreads();
      if (threadIdx.x == 0) top = -1;
#pragma unroll
      for (int u = 0; u < kBlockUnroll; ++u) {
        if (!(held >> u & 1u)) continue;
        long long l[3];
        jqc::split_limbs((double)v[u], shift, l);
        if (r[u] < base) {  // more than wrows below the top
          jqc::atomic_add_limbs(acc + ((long long)r[u] * nf + fu[u]) * 3, l);
          continue;
        }
        const int slot = ring_slot(w, bslot, r[u] - base);
        jqc::window_atomic_add(w.win, wrows * nf, slot * nf + fu[u], l);
        w.flag[slot] = 1;
      }
    }
  }
  __syncthreads();
  flush_rows(w, acc, base, bslot, wrows);
}

}  // namespace

// values (T, nf) contiguous in dtype (0 = float32, 1 = float64); key (T,)
// int32; acc (nrows, nf, 3) int64 limb sums, updated in place.
extern "C" int jqc_accum_block_launch(int dtype, const void* values,
                                      const int* key, void* acc, long long T,
                                      int nf, int nrows, int shift,
                                      void* stream) {
  if (T <= 0 || nf <= 0 || nrows <= 0) return 0;
  const int wrows = jqc::window_rows(nf);
  const void* kern = dtype == 0 ? (const void*)accum_block_kernel<float>
                                : (const void*)accum_block_kernel<double>;
  const size_t smem = (size_t)(6 * nf + 1) * wrows * sizeof(unsigned);
  long long per_block, nblk;
  cudaError_t err = jqc::plan_blocks(kern, kBlockThreads, smem, T, 1,
                                     &per_block, &nblk);
  if (err != cudaSuccess) return (int)err;
  if (nblk > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* a = static_cast<unsigned long long*>(acc);
  if (dtype == 0)
    accum_block_kernel<float><<<(unsigned)nblk, kBlockThreads, smem, st>>>(
        static_cast<const float*>(values), key, a, T, nf, nrows, shift,
        per_block, wrows);
  else
    accum_block_kernel<double><<<(unsigned)nblk, kBlockThreads, smem, st>>>(
        static_cast<const double*>(values), key, a, T, nf, nrows, shift,
        per_block, wrows);
  return (int)cudaGetLastError();
}
