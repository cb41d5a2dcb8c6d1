// Tile accumulation: two hand-written CUDA kernels for Hopper (sm_90a).
//
// (1) kernel B, contract + tile accumulation: contract_kernel, then
// accum_tile_kernel, launched together by jqc_accum_tile_launch.
// Replaces the Pallas TPU kernel joltqc_tpu/ops/accum_tile.py
// (fused_contract_tile / _fused_kernel, pl.pallas_call at :367).  For one
// output stream xy of a chunk of tasks it contracts the symmetry-weighted
// ERI blocks with the per-task density rows of the complement centers,
//     V[t, f] = sum_o G[t, gidx[f, o]] * d[t, o],
// converts V to fixed point with a static host bound and adds it into a
// dense integer accumulator at (rmap[ix[t]] + roff[f], cmap[iy[t]] +
// coff[f]).  Plain version: ops/accum_tile.py::accum_tile_plain.
//
// What bounds it on the card: bytes.  It must read each G element once
// (8 or 4 bytes) and does nfo multiply-adds per output, far below the FP
// rate.  The first version (one thread per (task, f), straight to global
// atomics) ran at 13.8x that bound: a chunk sends some 370 contributions
// to each accumulator element and neighbouring tasks met on one address.
// The TPU kernel summed a chunk in VMEM (a one-hot matmul into a dense
// tile) first; this kernel sums it in shared memory first.
//
// Design:
//  - two passes, because the sums want one f per block and the loads one
//    task for all f.  contract_kernel: one thread per task and group of
//    four f, G read once (component-major G: coalesced), the density row
//    gathered once per group, V written f-major in the tier's type to a
//    scratch buffer.  A single pass with a block per f made each of the
//    nfxy blocks gather the task's indices and density row again, and
//    was slower than the two passes together;
//  - the window: a fixed 64 x 64 cut of the shell plane, on 64-aligned
//    shells: cell (ix - x0, iy - y0) with x0 = ix - ix mod 64, y0 alike.
//    Within one supertile quadruple of the plan's task order (tile_w = 64
//    shells per center by default) the targets of stream xy for one f
//    are exactly such a window; a smaller power-of-two tile_w nests in
//    it, a larger one is cut to it (the tasks outside take the global
//    route below), and fused_contract_tile's (Wx, Wy) <= 64 tile is one
//    window at 0.  accum_tile_kernel takes one f (blockIdx.y) and a long
//    run of tasks, and adds their limbs into the 4096 cells in shared
//    memory: 98,304 B (limbs.cuh kWindowBytes; dynamic shared memory, two
//    blocks per SM);
//  - the walk: 512 threads, four consecutive tasks each a step, loads
//    first; neighbouring tasks of one cell (every task of a bra run on J
//    stream ab) are summed in registers before one shared atomic.  A task
//    outside the window is held over the step; if any is, the block
//    flushes the window (one global atomicAdd per nonzero limb of each
//    nonzero cell), moves it to the supertile of the step's last task,
//    and adds the held tasks there or, if they lie outside that one too,
//    straight to global memory.  Every task order is right; the sorted
//    order flushes once per supertile.  Exact zeros (the pad shell's
//    tasks) are dropped without moving the window;
//  - the shared sums are 32-bit word pairs with native atomics and an
//    explicit carry (limbs.cuh::window_atomic_add): a 64-bit shared
//    atomicAdd compiles to a compare-and-swap loop on sm_90, which
//    serialised the bra runs of J stream ab;
//  - exactness and determinism: the TPU kernel peels values into 7-bit
//    limbs so that a bf16 one-hot matmul sums them exactly.  Here V is
//    the first version's value (same loop over o, in the tier's type,
//    the same power-of-two scaling by fac * w[t]), scaled by 2^(120 - e)
//    where 2^e bounds the stream's values and split into three 40-bit
//    limbs of one sign (exact in double), then summed as int64 in
//    registers, the window and global memory (limbs.cuh).  Integer
//    addition is associative, so the sums are bit-identical to the first
//    version's, in any order and any split; the decoded value keeps 120
//    bits below the bound (the TPU's fp64 tile kept 70).  A partial sum
//    is a sum over a subset of an element's contributions, so it is
//    bounded as the whole is: 2^23 contributions of full size per
//    element before a limb could overflow, as before.
// Build (nvcc -Xptxas -v, sm_90a): contract_kernel 32 (float) and 36
// (double) registers; accum_tile_kernel<R, false> 56 and 62 registers
// (<R, true>, kernel C: 48 and 56) under __launch_bounds__(512, 2) and
// 98,304 bytes of dynamic shared memory; no spills.
// Measured (PERF.md kernel table; H100 80GB HBM3 at 700 W): 0.086-0.088
// ms per launch on the largest chunk of the 0029 path (K stream ac and J
// stream ab), 3.7-3.8x the byte bound (the first version 12.6-13.8x),
// 0.92-1.08x one index_add_ of the contracted values; 45-47% of it is
// the contraction pass.
// The bilinear one-hot MXU matmul of the TPU kernel, and its chunk-size
// limits, are not carried over.
//
// (2) kernel C, the accumulation alone: accum_tile_kernel<R, true>,
// launched by jqc_tile_accumulate_launch.
// Replaces joltqc_tpu/ops/accum_tile.py (tile_accumulate / _tile_kernel,
// pl.pallas_call at :176): values (T, nf) that are already contracted go
// to out[ix[t], iy[t], f] of a dense (Wx, Wy, nf, 3) limb tile; tasks
// whose ix or iy lies outside the tile are dropped (the one-hot of the
// TPU kernel matches nothing there).
// Plain version: ops/accum_tile.py::tile_accumulate_plain.
// What bounds it: bytes.  It reads 4 or 8 bytes per value and 8 bytes of
// indices per task and does no arithmetic beyond the limb split.  The
// first kernel (one thread per element, a global 64-bit atomic per nonzero
// limb) ran 12x that bound and lost to one index_add_ by 1.8x.
// Design: kernel B's accumulation pass, the same template with TILE set:
// a block per f reads values[t * nf + f] in place (strided; the T x nf
// values fit in L2, which all nf blocks read at once), drops the tasks
// outside the tile as exact zeros, and adds into the dense tile.  A copy
// of the values into B's f-major layout in front of the unchanged pass
// measured slower on the timed stream (PERF.md).  The limb sums are
// those of the plain version, bit for bit: the same split of the same
// values, summed as integers.
// Measured (PERF.md kernel table): 0.075-0.076 ms on the largest chunk's
// K stream ac (the first kernel 0.083), 10x the byte bound and 1.55x one
// index_add_: each of the nf blocks pulls every task's 32-byte sector
// from L2 for one value (nf x T sectors), where B's pass reads V once.

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
  int per_block;            // tasks per block of the accumulation
  int wx, wy;               // kernel C's tile: (wx, wy, nfxy) limb sums
};

constexpr int kContractThreads = 256;
constexpr int kTileThreads = 512;
constexpr int kTileUnroll = 4;  // consecutive tasks per thread and step
constexpr int kTileStep = kTileThreads * kTileUnroll;
constexpr int kWin = 64;  // window edge in shells
constexpr int kWinCells = kWin * kWin;
static_assert(6 * kWinCells * sizeof(unsigned) == jqc::kWindowBytes,
              "the window fills the shared-memory budget");

// V[f, t] = sum_o G[t, gidx[f, o]] * d[t, o] in the tier's type: one
// thread per task and group of kContractF components (blockIdx.y), o
// outer, so each density element is read once per group; each V[f, t]
// still sums over o in order, as the first version did.
constexpr int kContractF = 4;

template <typename R>
__global__ void __launch_bounds__(kContractThreads)
    contract_kernel(Stream s, R* __restrict__ V) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= s.T) return;
  const int fb = blockIdx.y * kContractF;
  const int nf = min(kContractF, s.nfxy - fb);
  const R* G = static_cast<const R*>(s.G) + (long long)t * s.g_st;
  const R* D = static_cast<const R*>(s.dsrc) +
               (long long)s.dmapu[s.iu[t]] * s.dstride + s.dmapv[s.iv[t]];
  R v[kContractF];
#pragma unroll
  for (int k = 0; k < kContractF; ++k) v[k] = 0;
  for (int o = 0; o < s.nfo; ++o) {
    const R d = D[s.doff[o]];
    const int* gi = s.gidx + (long long)fb * s.nfo + o;
#pragma unroll
    for (int k = 0; k < kContractF; ++k)
      if (k < nf) v[k] += G[gi[k * s.nfo] * s.g_sf] * d;
  }
#pragma unroll
  for (int k = 0; k < kContractF; ++k)
    if (k < nf) V[(long long)(fb + k) * s.T + t] = v[k];
}

// the int64 limb sums of output component f of shells (x, y): E-space
// through the maps (kernel B), or the dense (wx, wy, nfxy) tile
// (kernel C, TILE)
template <bool TILE>
__device__ __forceinline__ unsigned long long* tile_target(const Stream& s,
                                                           int f, int x,
                                                           int y) {
  if constexpr (TILE)
    return s.acc + (((long long)x * s.wy + y) * s.nfxy + f) * 3;
  const long long row = (long long)s.rmap[x] + s.roff[f];
  const long long col = (long long)s.cmap[y] + s.coff[f];
  return s.acc + (row * s.ncols + col) * 3;
}

// window cell of shells (x, y), or -1 outside the window at (x0, y0)
__device__ __forceinline__ int tile_cell(int x, int y, int x0, int y0) {
  const unsigned cx = (unsigned)(x - x0), cy = (unsigned)(y - y0);
  return cx < (unsigned)kWin && cy < (unsigned)kWin ? (int)(cx * kWin + cy)
                                                    : -1;
}

// add every nonzero cell of the window at (x0, y0) to global memory, zero
// it, and wait for the whole block
template <bool TILE>
__device__ void flush_tile(unsigned* win, const Stream& s, int f, int x0,
                           int y0) {
  for (int c = threadIdx.x; c < kWinCells; c += blockDim.x) {
    long long l[3];
    jqc::window_read(win, kWinCells, c, l);
    if (l[0] | l[1] | l[2]) {
      jqc::atomic_add_limbs(
          tile_target<TILE>(s, f, x0 + c / kWin, y0 + c % kWin), l);
      jqc::window_clear(win, kWinCells, c);
    }
  }
  __syncthreads();
}

// the limbs of V[f, t] scaled by fac * w[t] (powers of two: exact)
template <typename R>
__device__ __forceinline__ void task_limbs(const Stream& s, R v, float w,
                                           long long l[3]) {
  jqc::split_limbs((double)v * (s.w ? s.fac * (double)w : s.fac), s.shift,
                   l);
}

// The accumulation of V[f, :] for one f (blockIdx.y) and a run of tasks
// through the shared window: kernel B's second pass (V f-major, (nfxy,
// T), E-space targets) or, TILE, kernel C (V task-major, (T, nfxy), the
// dense tile; tasks outside it are dropped).
template <typename R, bool TILE>
__global__ void __launch_bounds__(kTileThreads, 2)
    accum_tile_kernel(Stream s, const R* __restrict__ V) {
  extern __shared__ unsigned win[];  // (6, kWinCells) words
  const int f = blockIdx.y;
  const int t0 = blockIdx.x * s.per_block;
  const int t1 = min(s.T, t0 + s.per_block);
  const R* Vf = V + (TILE ? f : (long long)f * s.T);
  for (int i = threadIdx.x; i < 6 * kWinCells; i += blockDim.x) win[i] = 0;
  int x0 = jqc::floor_to(s.ix[t0], kWin), y0 = jqc::floor_to(s.iy[t0], kWin);
  __syncthreads();
  for (int base = t0; base < t1; base += kTileStep) {
    // all loads of the step first: kTileUnroll consecutive tasks
    const int tb = base + threadIdx.x * kTileUnroll;
    R v[kTileUnroll];
    float w[kTileUnroll];
    int x[kTileUnroll], y[kTileUnroll];
#pragma unroll
    for (int u = 0; u < kTileUnroll; ++u) {
      if (tb + u < t1) {
        if constexpr (TILE)
          v[u] = Vf[(long long)(tb + u) * s.nfxy];
        else
          v[u] = Vf[tb + u];
        w[u] = s.w ? s.w[tb + u] : 1.0f;
        x[u] = s.ix[tb + u];
        y[u] = s.iy[tb + u];
        // outside kernel C's tile: dropped, as an exact zero
        if (TILE && ((unsigned)x[u] >= (unsigned)s.wx ||
                     (unsigned)y[u] >= (unsigned)s.wy))
          v[u] = R(0);
      }
    }
    // neighbouring tasks of one cell (a bra run on J stream ab) are
    // summed in registers first: one shared atomic per run
    unsigned held = 0;  // bit u: task u adds outside the window
    long long run[3] = {0, 0, 0};
    int run_cell = -1;
#pragma unroll
    for (int u = 0; u < kTileUnroll; ++u) {
      if (tb + u >= t1) break;
      const int c = tile_cell(x[u], y[u], x0, y0);
      if (c < 0) {
        // exact zeros (the pad shell's tasks) do not move the window
        if (v[u] != R(0)) held |= 1u << u;
        continue;
      }
      if (c != run_cell && run_cell >= 0) {
        jqc::window_atomic_add(win, kWinCells, run_cell, run);
        run[0] = run[1] = run[2] = 0;
      }
      run_cell = c;
      long long l[3];
      task_limbs(s, v[u], w[u], l);
#pragma unroll
      for (int k = 0; k < 3; ++k) run[k] += l[k];
    }
    if (run_cell >= 0)
      jqc::window_atomic_add(win, kWinCells, run_cell, run);
    if (__syncthreads_or(held != 0)) {
      // move the window to the supertile of this step's last task
      flush_tile<TILE>(win, s, f, x0, y0);
      const int tl = min(base + kTileStep, t1) - 1;
      x0 = jqc::floor_to(s.ix[tl], kWin);
      y0 = jqc::floor_to(s.iy[tl], kWin);
#pragma unroll
      for (int u = 0; u < kTileUnroll; ++u) {
        if (!(held >> u & 1u)) continue;
        long long l[3];
        task_limbs(s, v[u], w[u], l);
        const int c = tile_cell(x[u], y[u], x0, y0);
        if (c >= 0)
          jqc::window_atomic_add(win, kWinCells, c, l);
        else
          jqc::atomic_add_limbs(tile_target<TILE>(s, f, x[u], y[u]), l);
      }
    }
  }
  __syncthreads();
  flush_tile<TILE>(win, s, f, x0, y0);
}

// one wave of accum_tile_kernel<R, TILE> over the nfxy components
template <typename R, bool TILE>
int launch_accum(Stream& s, const R* V, cudaStream_t st) {
  const void* kern = (const void*)accum_tile_kernel<R, TILE>;
  const size_t smem = jqc::kWindowBytes;
  long long per_block, nx;
  cudaError_t err = jqc::plan_blocks(kern, kTileThreads, smem, s.T, s.nfxy,
                                     &per_block, &nx);
  if (err != cudaSuccess) return (int)err;
  s.per_block = (int)per_block;
  const dim3 grid((unsigned)nx, s.nfxy);
  accum_tile_kernel<R, TILE><<<grid, kTileThreads, smem, st>>>(s, V);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: G, gidx, dsrc, iu, dmapu, iv, dmapv, doff, w (or null), ix, rmap,
// roff, iy, cmap, coff, acc, V (nfxy * T scratch of G's type).  ints:
// nfxy, nfo, shift, T.  longs: g_st, g_sf, dstride, ncols.
// dtype 0 = float32, 1 = float64.
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
  void* V = p[16];
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
  const dim3 gc((s.T + kContractThreads - 1) / kContractThreads,
                (s.nfxy + kContractF - 1) / kContractF);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    contract_kernel<float><<<gc, kContractThreads, 0, st>>>(
        s, static_cast<float*>(V));
    return launch_accum<float, false>(s, static_cast<const float*>(V), st);
  }
  contract_kernel<double><<<gc, kContractThreads, 0, st>>>(
      s, static_cast<double*>(V));
  return launch_accum<double, false>(s, static_cast<const double*>(V), st);
}

// values (T, nf) contiguous in dtype (0 = float32, 1 = float64); ix, iy
// (T,) int32; acc (Wx, Wy, nf, 3) int64 limb sums, updated in place.
extern "C" int jqc_tile_accumulate_launch(int dtype, const void* values,
                                          const int* ix, const int* iy,
                                          void* acc, long long T, int nf,
                                          int Wx, int Wy, int shift,
                                          void* stream) {
  if (T <= 0 || nf <= 0) return 0;
  if (T > 0x7fffffffLL || nf > 65535) return (int)cudaErrorInvalidValue;
  Stream s = {};
  s.nfxy = nf;
  s.ix = ix;
  s.iy = iy;
  s.acc = static_cast<unsigned long long*>(acc);
  s.shift = shift;
  s.T = (int)T;
  s.fac = 1.0;
  s.wx = Wx;
  s.wy = Wy;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_accum<float, true>(s, static_cast<const float*>(values),
                                         st)
             : launch_accum<double, true>(
                   s, static_cast<const double*>(values), st);
}
