// Fused contract + tile accumulation: hand-written CUDA kernel for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel joltqc_tpu/ops/accum_tile.py
// (fused_contract_tile / _fused_kernel, pl.pallas_call at :367).  For one
// output stream xy of a chunk of tasks it contracts the symmetry-weighted
// ERI blocks with the per-task density rows of the complement centers,
//     V[t, f] = sum_o G[t, gidx[f, o]] * d[t, o],
// converts V to fixed point with a static host bound and adds it into a
// dense integer accumulator at (row(t) + roff[f], col(t) + coff[f]).
// Plain version: joltqc_tpu_torch/ops/accum_tile.py::accum_plain.
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
//    each limb is added with a 64-bit integer atomicAdd.  Integer addition
//    is associative, so the sums are bit-identical in any order, and the
//    decoded value keeps 120 bits below the bound (the TPU's fp64 tile
//    kept 70).  With 40-bit limbs an element takes 2^23 contributions
//    of full size before a limb could overflow;
//  - zero limbs are skipped (no atomic); the symmetry weight w[t] and the
//    J factor 2 are powers of two, applied exactly to V.
// The bilinear one-hot MXU matmul of the TPU kernel, and its chunk-size
// limits, are not carried over.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

  double x = (double)v * (s.w ? s.fac * (double)s.w[t] : s.fac);
  x = ldexp(x, s.shift);
  const double ax = fabs(x);
  // three limbs of one sign: |x| = l0 2^80 + l1 2^40 + l2, each step exact
  const double l0 = trunc(ax * 0x1p-80);
  const double r1 = ax - l0 * 0x1p80;
  const double l1 = trunc(r1 * 0x1p-40);
  const double l2 = rint(r1 - l1 * 0x1p40);
  const long long sg = x < 0 ? -1 : 1;
  const long long row = (long long)s.rmap[s.ix[t]] + s.roff[f];
  const long long col = (long long)s.cmap[s.iy[t]] + s.coff[f];
  unsigned long long* a = s.acc + (row * s.ncols + col) * 3;
  if (l0 != 0.0) atomicAdd(a + 0, (unsigned long long)(sg * (long long)l0));
  if (l1 != 0.0) atomicAdd(a + 1, (unsigned long long)(sg * (long long)l1));
  if (l2 != 0.0) atomicAdd(a + 2, (unsigned long long)(sg * (long long)l2));
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
