// Tile accumulation: two hand-written CUDA kernels for Hopper (sm_90a).
//
// (1) accum_tile_kernel, fused contract + tile accumulation.
// Replaces the Pallas TPU kernel joltqc_tpu/ops/accum_tile.py
// (fused_contract_tile / _fused_kernel, pl.pallas_call at :367).  For one
// output stream xy of a chunk of tasks it contracts the symmetry-weighted
// ERI blocks with the per-task density rows of the complement centers,
//     V[t, f] = sum_o G[t, gidx[f, o]] * d[t, o],
// converts V to fixed point with a static host bound and adds it into a
// dense integer accumulator at (row(t) + roff[f], col(t) + coff[f]).
// Plain version: joltqc_tpu_torch/ops/accum_tile.py::accum_tile_plain.
//
// What bounds it on the card: memory traffic and atomic throughput.  It
// reads each G element once (8 or 4 bytes) and does nfo multiply-adds per
// output, so it is far below the FP rate; each output element then costs
// up to three 64-bit atomic adds into a few thousand addresses per
// supertile, which contend (the measured time is about 13x the byte
// bound on an H100 at 700 W, see PERF.md).
//
// Design:
//  - one thread per (task, output component): blockIdx.y = f, threads
//    run along t, so G loads of a component-major G coalesce;
//  - the contraction runs in the tier's type (float for f32, double for
//    fp64), as the Pallas kernel does;
//  - exactness and determinism: the TPU kernel peels values into 7-bit
//    limbs so that a bf16 one-hot matmul sums them exactly.  Here the
//    value, scaled by 2^(120 - e) where 2^e bounds the stream's values,
//    is split into three 40-bit limbs of one sign (exact in double) and
//    each limb is added with a 64-bit integer atomicAdd (limbs.cuh, shared
//    with accum_block.cu).  Integer addition
//    is associative, so the sums are bit-identical in any order, and the
//    decoded value keeps 120 bits below the bound (the TPU's fp64 tile
//    kept 70).  With 40-bit limbs an element takes 2^23 contributions
//    of full size before a limb could overflow;
//  - zero limbs are skipped (no atomic); the symmetry weight w[t] and the
//    J factor 2 are powers of two, applied exactly to V.
// The bilinear one-hot MXU matmul of the TPU kernel, and its chunk-size
// limits, are not carried over.
//
// (2) tile_accumulate_kernel, the accumulation alone.
// Replaces joltqc_tpu/ops/accum_tile.py (tile_accumulate / _tile_kernel,
// pl.pallas_call at :176): values (T, nf) that are already contracted go
// to out[ix[t], iy[t], f] of a dense (Wx, Wy, nf, 3) limb tile; tasks
// whose ix or iy lies outside the tile are dropped (the one-hot of the
// TPU kernel matches nothing there).  It is kernel (1) with the
// contraction and the density read removed, as a kernel of its own entry.
// Plain version: ops/accum_tile.py::tile_accumulate_plain.
// What bounds it: bytes, then atomic throughput.  It reads 4 or 8 bytes
// per value and 8 bytes of indices per task and does no arithmetic beyond
// the limb split; every nonzero limb is one 64-bit atomic.  values is
// task-major (T, nf) contiguous, so one thread per element in flat order
// (f fastest along threadIdx.x) reads it fully coalesced, and the nf
// threads of one task add to 24-byte neighbours of one tile cell.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "limbs.cuh"

namespace {

struct Stream {
  const void* G;            // tier type; element (t, c) at t*g_st + c*g_sf
  long long g_st, g_sf;
  const int* gidx;          // (nfxy, nfo) flat ERI component per (f, o)
  int nfxy, nfo;
  const void* dsrc;         // tier type density source
  const int* iu;            // (T,) row of the u-center map per task
  const int* dmapu;         // u-center row -> density row
  const int* iv;
  const int* dmapv;
  long long dstride;        // density row stride
  const int* doff;          // (nfo,) offsets of the contracted elements
  const float* w;           // (T,) symmetry weights or null
  double fac;               // stream factor (2 for J, 1 for K)
  const int* ix;            // (T,) output row map index
  const int* rmap;
  const int* roff;          // (nfxy,)
  const int* iy;
  const int* cmap;
  const int* coff;          // (nfxy,)
  long long ncols;          // accumulator row length (elements)
  unsigned long long* acc;  // (rows, ncols, 3) int64 limbs
  int shift;                // 120 - e
  int T;
};

template <typename R>
__global__ void __launch_bounds__(128) accum_tile_kernel(Stream s) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int f = blockIdx.y;
  if (t >= s.T) return;
  const R* G = static_cast<const R*>(s.G) + (long long)t * s.g_st;
  const R* D = static_cast<const R*>(s.dsrc) +
               (long long)s.dmapu[s.iu[t]] * s.dstride + s.dmapv[s.iv[t]];
  const int* gi = s.gidx + (long long)f * s.nfo;
  R v = 0;
  for (int o = 0; o < s.nfo; ++o) v += G[gi[o] * s.g_sf] * D[s.doff[o]];

  const double x = (double)v * (s.w ? s.fac * (double)s.w[t] : s.fac);
  const long long row = (long long)s.rmap[s.ix[t]] + s.roff[f];
  const long long col = (long long)s.cmap[s.iy[t]] + s.coff[f];
  jqc::add_limbs(s.acc + (row * s.ncols + col) * 3, x, s.shift);
}

template <typename R>
__global__ void __launch_bounds__(256) tile_accumulate_kernel(
    const R* __restrict__ values, const int* __restrict__ ix,
    const int* __restrict__ iy, unsigned long long* acc, long long n, int nf,
    int Wx, int Wy, int shift) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long t = i / nf;
  const int f = (int)(i - t * nf);
  const int x = ix[t], y = iy[t];
  if (x < 0 || x >= Wx || y < 0 || y >= Wy) return;
  jqc::add_limbs(acc + (((long long)x * Wy + y) * nf + f) * 3,
                 (double)values[i], shift);
}

}  // namespace

// ptrs: G, gidx, dsrc, iu, dmapu, iv, dmapv, doff, w (or null), ix, rmap,
// roff, iy, cmap, coff, acc.  ints: nfxy, nfo, shift, T.
// longs: g_st, g_sf, dstride, ncols.  dtype 0 = float32, 1 = float64.
extern "C" int jqc_accum_tile_launch(int dtype, void* const* p,
                                     const int* ints, const long long* longs,
                                     double fac, void* stream) {
  Stream s;
  s.G = p[0];
  s.gidx = static_cast<const int*>(p[1]);
  s.dsrc = p[2];
  s.iu = static_cast<const int*>(p[3]);
  s.dmapu = static_cast<const int*>(p[4]);
  s.iv = static_cast<const int*>(p[5]);
  s.dmapv = static_cast<const int*>(p[6]);
  s.doff = static_cast<const int*>(p[7]);
  s.w = static_cast<const float*>(p[8]);
  s.ix = static_cast<const int*>(p[9]);
  s.rmap = static_cast<const int*>(p[10]);
  s.roff = static_cast<const int*>(p[11]);
  s.iy = static_cast<const int*>(p[12]);
  s.cmap = static_cast<const int*>(p[13]);
  s.coff = static_cast<const int*>(p[14]);
  s.acc = static_cast<unsigned long long*>(p[15]);
  s.nfxy = ints[0];
  s.nfo = ints[1];
  s.shift = ints[2];
  s.T = ints[3];
  s.g_st = longs[0];
  s.g_sf = longs[1];
  s.dstride = longs[2];
  s.ncols = longs[3];
  s.fac = fac;
  if (s.T <= 0 || s.nfxy <= 0) return 0;
  if (s.nfxy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 block(128), grid((s.T + 127) / 128, s.nfxy);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    accum_tile_kernel<float><<<grid, block, 0, st>>>(s);
  else
    accum_tile_kernel<double><<<grid, block, 0, st>>>(s);
  return (int)cudaGetLastError();
}

// values (T, nf) contiguous in dtype (0 = float32, 1 = float64); ix, iy
// (T,) int32; acc (Wx, Wy, nf, 3) int64 limb sums, updated in place.
extern "C" int jqc_tile_accumulate_launch(int dtype, const void* values,
                                          const int* ix, const int* iy,
                                          void* acc, long long T, int nf,
                                          int Wx, int Wy, int shift,
                                          void* stream) {
  if (T <= 0 || nf <= 0) return 0;
  const long long n = T * nf;
  const long long nblk = (n + 255) / 256;
  if (nblk > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* a = static_cast<unsigned long long*>(acc);
  if (dtype == 0)
    tile_accumulate_kernel<float><<<(unsigned)nblk, 256, 0, st>>>(
        static_cast<const float*>(values), ix, iy, a, n, nf, Wx, Wy, shift);
  else
    tile_accumulate_kernel<double><<<(unsigned)nblk, 256, 0, st>>>(
        static_cast<const double*>(values), ix, iy, a, n, nf, Wx, Wy, shift);
  return (int)cudaGetLastError();
}
