// Kernel A, the contracted-ERI class chunk: the arithmetic of its two
// routes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel joltqc_tpu/ops/eri_pallas.py
// (eri_chunk_pallas / _kernel_fn, pl.pallas_call at :291), which runs the
// scalar McMurchie-Davidson chain of ops/md.py (make_pair_data_c,
// e_scalar, r_scalar, eri_scalar_g_rows) with a grid over primitive
// quartets.  Plain version: joltqc_tpu_torch/ops/md.py::eri_plain.
// A task is one shell quartet of a class (la, lb, lc, ld, npa..npd); a
// chunk of T tasks gives the component-major (nfab * nfcd, T) blocks.
//
// What bounds it on the card: arithmetic.  Per task and primitive quartet
// the chain does the Boys function, the E and R recursions and the
// assembly, O(10^2..10^4) FLOPs against ~100 bytes of task geometry in.
// The first design (now the generic route) ran about 175x above the
// operation bound on the (2,1,1,0) f32 class of the 0029/6-31g* Fock
// build: it took the angular momenta at run time, so its E, R and Boys
// scratch lived in local memory, integer index work (cart_comp,
// tri_index) ran in the innermost loops, and it added each primitive
// quartet's block into global memory (a read-modify-write of every output
// per quartet).
//
// Two routes, decided per class before launch (ops/eri.py::eri_chunk):
//  - eri_class_kernel<R, LA, LB, LC, LD>: the classes the J/K engine
//    forms with l <= 2 (la >= lb, lc >= ld, la >= lc: 25 l-tuples, both
//    tiers; the list is ops/eri.py::ERI_CLASSES, instantiated by
//    csrc/eri_class.cu, one library per class group).  A thread takes
//    one task and one slice of its ket components (blockIdx.y) and sums
//    its part of the block over the primitive quartets in registers,
//    then stores each element once, coalesced across the warp.  Two forms, by L = la + lb + lc + ld:
//    * L <= kUnrolledL (22 of the 25 tuples): every loop over components,
//      Hermite indices, E entries and R entries is unrolled at compile
//      time (Unroll below and #pragma unroll over compile-time bounds), so
//      every index is a constant: the E tables, the Boys values, the R
//      table and the ket contraction s[] are registers and the assembly
//      touches only the nonzero E terms.  A slice holds as many ket
//      components as keep NFAB * SLICE sums within AccCap; each slice runs
//      the whole quartet chain (Boys, R, E) again (a trial with half the
//      cap, fewer registers but more recomputation, ran slower).
//    * L > kUnrolledL ((2,1,2,2), (2,2,2,1), (2,2,2,2)): the first
//      design's loop with l <= 2 scratch, one ket component a thread (a
//      (2,2,2,2) chunk of 0029 has some 3,500 tasks: one thread a task
//      left the card idle).  Fully unrolled, each took longer to build
//      than a whole d-class source does now, and spilled kilobytes.
//  - eri_generic_kernel<R, 4> (csrc/eri.cu): every other tuple (l = 3, 4;
//    non-canonical tuples from direct callers), the first design.
// The primitive counts stay run-time values; quartets whose coefficient
// product is zero (padded primitives, the pad shell) are skipped.  The
// ket pair's data and E tables are recomputed per bra primitive pair:
// with run-time primitive counts a table per (pc, pd) would be indexed at
// run time (local memory), and they are a few percent of a quartet's
// operations.
//
// The arithmetic is the first design's, operation for operation: the
// Boys algorithms of ops/boys.py (series at m_max and downward recursion
// below the switch, erf and upward recursion above it), the E recursion
// of e_scalar, the r_scalar recursion and the ket-then-bra assembly, in
// the same order.  f32 tier: float throughout; fp64 tier: double.
//
// Build: the ptxas lines (nvcc -Xptxas -v, sm_90a) that phase build of
// chip_smoke.py prints for the class kernels of the 0029/6-31g* plan, as
// built from csrc/eri_class.cu: registers, stack frame bytes, spill store
// / load bytes, f32 then fp64.
//   class regs stack spill st/ld  regs stack spill st/ld
//   0000   56   32    28/28      96   56    56/56
//   1000   72   16    12/12     122    0     0/0
//   1010   80   32    28/28     128   64    64/64
//   1100   96   16    12/12     168   56    52/52
//   1110  163    0     0/0      254    0     0/0
//   1111  228    0     0/0      255   88    92/112
//   2000   80   40    40/40     158    0     0/0
//   2010  128    0     0/0      240    0     0/0
//   2011  255    0     0/0      255   96   100/128
//   2020  168    0     0/0      252    0     0/0
//   2100  202    0     0/0      255  280   280/292
//   2110  255    8     4/4      255  856  1012/1360
//   2111  255   32    32/36     255 1136  2616/4404
//   2120  255   40    44/40     255 1016  2208/2932
//   2121  255  184   188/220    255 1472  5832/10492
//   2200  255  568   568/572    255 2144  2324/2312
//   2210  255 1344  1484/2276   255 2480  2992/6868
//   2211  255 1544  3560/6908   255 2776  5656/21852
//   2220  255 1344  2840/4428   255 2744  4584/14652
//   2221   80 1976    24/24      96 4016   112/192  (first design's loop)
//   2222   80 1976    24/24      96 4016   112/192  (first design's loop)
// Which spill, and why: the unrolled classes whose E tables, R table, s[]
// and block slice outgrow 255 registers (fp64 from L = 4, f32 from L = 5
// with a d pair) spill the excess to local memory.  Spills and all, the
// class kernels take 71 ms of a converged tile get_jk at 0029/6-31g*
// where the first design took 456 ms (PERF.md).  The 12-64 B of
// the small classes appear at 56-168 registers, so not from pressure;
// the out-of-line slow paths of IEEE division are the likely cause (not
// verified).  The looped classes' stack is their local scratch.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace jqc_eri {

constexpr double kTwoPi25 = 34.98683665524972;  // 2 * pi^(5/2)
constexpr double kSqrtPiOver2 = 0.88622692545275801;
constexpr double kInvSqrtPi = 0.56418958354775628;
constexpr int kThreads = 128;

struct Centers {
  const void* coord[4];
  const void* exps[4];
  const void* coefs[4];
  const int* idx[4];
  int l[4];
  int np[4];
};

// ptrs: per center a..d, (coord, exps, coefs, idx-or-null)
inline Centers make_centers(void* const* ptrs, const int* ls,
                            const int* nprims) {
  Centers c;
  for (int k = 0; k < 4; ++k) {
    c.coord[k] = ptrs[4 * k + 0];
    c.exps[k] = ptrs[4 * k + 1];
    c.coefs[k] = ptrs[4 * k + 2];
    c.idx[k] = static_cast<const int*>(ptrs[4 * k + 3]);
    c.l[k] = ls[k];
    c.np[k] = nprims[k];
  }
  return c;
}

// ------------------------------------------------------- index helpers
struct Tuv {
  int t, u, v;
};

__host__ __device__ constexpr int ncart(int l) { return (l + 1) * (l + 2) / 2; }

// number of (t, u, v) with t + u + v <= L
__host__ __device__ constexpr int ntri(int L) {
  return L < 0 ? 0 : (L + 1) * (L + 2) * (L + 3) / 6;
}

// (t, u, v) ordered by sum, then t, then u (ops/md.py::tri_set)
__host__ __device__ constexpr int tri_index(int t, int u, int v) {
  return ntri(t + u + v - 1) + t * (t + u + v + 1) - t * (t - 1) / 2 + u;
}

__host__ __device__ constexpr Tuv tri_entry(int k) {
  int s = 0;
  while (ntri(s) <= k) ++s;
  int r = k - ntri(s - 1), t = 0;
  while (r >= s - t + 1) {
    r -= s - t + 1;
    ++t;
  }
  return Tuv{t, r, s - t - r};
}

// Cartesian component c of shell l, ordered (lx desc, ly desc) as
// ops/harmonics.py::cart_components
__host__ __device__ constexpr Tuv cart(int l, int c) {
  int x = l;
  while (c > l - x) {
    c -= l - x + 1;
    --x;
  }
  return Tuv{x, l - x - c, c};
}

// f(Int<0>{}), ..., f(Int<N - 1>{}), each index a compile-time constant
template <int V>
struct Int {
  static constexpr int value = V;
};

template <int I, int N>
struct Unroll {
  template <typename F>
  static __device__ __forceinline__ void run(F&& f) {
    if constexpr (I < N) {
      f(Int<I>{});
      Unroll<I + 1, N>::run(f);
    }
  }
};

template <int N, typename F>
__device__ __forceinline__ void unroll(F&& f) {
  Unroll<0, N>::run(f);
}

template <typename R>
__device__ __forceinline__ R ld(const void* p, long long i) {
  return static_cast<const R*>(p)[i];
}

__device__ __forceinline__ float f_exp(float x) { return expf(x); }
__device__ __forceinline__ double f_exp(double x) { return exp(x); }
__device__ __forceinline__ float f_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double f_sqrt(double x) { return sqrt(x); }

// ---------------------------------------------------------------- Boys
// F_0..F_mmax (ops/boys.py): series at mmax + downward recursion below
// the switch, F_0 from erf + upward recursion above it.  With a
// compile-time mmax (the class kernels) the recursions unroll and F is
// registers.
__device__ __forceinline__ void boys(int mmax, double x, double* F) {
  const double sw = fmax(12.0, 2.0 * mmax + 5.0);
  if (x <= sw) {
    const double emx = exp(-x), two_x = 2.0 * x;
    double t = 1.0 / (2 * mmax + 1), s = t;
    const int n = (int)(2.0 * sw) + 30;
    for (int i = 0; i < n; ++i) {
      t = t * two_x / (double)(2 * mmax + 3 + 2 * i);
      s += t;
      if (t < s * 1e-17) break;
    }
    F[mmax] = emx * s;
#pragma unroll
    for (int m = mmax; m > 0; --m)
      F[m - 1] = (two_x * F[m] + emx) / (double)(2 * m - 1);
  } else {
    const double emx = exp(-x), inv_2x = 0.5 / x;
    double f = kSqrtPiOver2 * rsqrt(x) * erf(sqrt(x));
    F[0] = f;
#pragma unroll
    for (int m = 0; m < mmax; ++m) {
      f = ((double)(2 * m + 1) * f - emx) * inv_2x;
      F[m + 1] = f;
    }
  }
}

__device__ __forceinline__ void boys(int mmax, float x, float* F) {
  const float sw = fmaxf(10.0f, 2.0f * mmax + 3.0f);
  if (x <= sw) {
    const float emx = expf(-x), two_x = 2.0f * x;
    float t = 1.0f / (float)(2 * mmax + 1), s = t;
    const int n = (int)(2.0f * sw) + 30;
    for (int i = 0; i < n; ++i) {
      t = t * two_x / (float)(2 * mmax + 3 + 2 * i);
      s += t;
      if (t < s * 1e-9f) break;
    }
    F[mmax] = emx * s;
#pragma unroll
    for (int m = mmax; m > 0; --m)
      F[m - 1] = (two_x * F[m] + emx) / (float)(2 * m - 1);
  } else {
    // erfc(sqrt x) by its asymptotic series, as ops/boys.py::boys_f32
    const float emx = expf(-x), isx = rsqrtf(x), u = 0.5f / x;
    const float poly = 1.0f + u * (-1.0f + u * (3.0f - 15.0f * u));
    const float erf_l = 1.0f - emx * isx * (float)kInvSqrtPi * poly;
    float f = (float)kSqrtPiOver2 * isx * erf_l;
    F[0] = f;
#pragma unroll
    for (int m = 0; m < mmax; ++m) {
      f = ((float)(2 * m + 1) * f - emx) * u;
      F[m + 1] = f;
    }
  }
}

// ------------------------------------------------ the generic route
// The first design, for every l <= LM: run-time angular momenta, scratch
// sized by LM, each quartet's block (ket components fcd0 .. fcd1 - 1)
// added into the zeroed output.
template <typename R, int LM>
__device__ __forceinline__ void e_tables_rt(R* E, int li, int lj, R inv2p,
                                            const R* xpa, const R* xpb,
                                            R epref) {
  constexpr int NJ = LM + 1, NT = 2 * LM + 1, ND = (LM + 1) * NJ * NT;
#define EIX(i, j, t) (((i) * NJ + (j)) * NT + (t))
  for (int d = 0; d < 3; ++d) {
    R* Ed = E + d * ND;
    Ed[EIX(0, 0, 0)] = d == 0 ? epref : (R)1;
    for (int i = 0; i < li; ++i) {
      for (int t = 0; t <= i + 1; ++t) {
        R v = 0;
        if (t >= 1) v += inv2p * Ed[EIX(i, 0, t - 1)];
        if (t <= i) v += xpa[d] * Ed[EIX(i, 0, t)];
        if (t + 1 <= i) v += (R)(t + 1) * Ed[EIX(i, 0, t + 1)];
        Ed[EIX(i + 1, 0, t)] = v;
      }
    }
    for (int j = 0; j < lj; ++j) {
      for (int i = 0; i <= li; ++i) {
        for (int t = 0; t <= i + j + 1; ++t) {
          R v = 0;
          if (t >= 1) v += inv2p * Ed[EIX(i, j, t - 1)];
          if (t <= i + j) v += xpb[d] * Ed[EIX(i, j, t)];
          if (t + 1 <= i + j) v += (R)(t + 1) * Ed[EIX(i, j, t + 1)];
          Ed[EIX(i, j + 1, t)] = v;
        }
      }
    }
  }
#undef EIX
}

template <typename R, int LM>
__device__ __forceinline__ void eri_generic_task(const Centers& c, int T,
                                                 R omega,
                                                 R* __restrict__ out, int t,
                                                 int fcd0, int fcd1) {
  constexpr int NJ = LM + 1, NT = 2 * LM + 1, ND = (LM + 1) * NJ * NT;
  constexpr int LTOT = 4 * LM;

  const int la = c.l[0], lb = c.l[1], lc = c.l[2], ld_ = c.l[3];
  const int lab = la + lb, L = lab + lc + ld_;
  const int nfb = ncart(lb), nfd = ncart(ld_);
  const int nfab = ncart(la) * nfb, nfcd = ncart(lc) * nfd;

  long long row[4];
  R X[4][3];
  for (int k = 0; k < 4; ++k) {
    row[k] = c.idx[k] ? (long long)c.idx[k][t] : (long long)t;
    for (int d = 0; d < 3; ++d) X[k][d] = ld<R>(c.coord[k], row[k] * 3 + d);
  }

  R Eab[3 * ND], Ecd[3 * ND], Rt[ntri(LTOT)], F[LTOT + 1], pw[LTOT + 1],
      s[ntri(2 * LM)];

  for (int pa = 0; pa < c.np[0]; ++pa) {
    const R ea = ld<R>(c.exps[0], row[0] * c.np[0] + pa);
    const R ca = ld<R>(c.coefs[0], row[0] * c.np[0] + pa);
    for (int pb = 0; pb < c.np[1]; ++pb) {
      const R eb = ld<R>(c.exps[1], row[1] * c.np[1] + pb);
      const R cab = ca * ld<R>(c.coefs[1], row[1] * c.np[1] + pb);
      if (cab == (R)0) continue;
      const R p = ea + eb, invp = (R)1 / p;
      R P[3], xpa[3], xpb[3], r2 = 0;
      for (int d = 0; d < 3; ++d) {
        P[d] = (ea * X[0][d] + eb * X[1][d]) * invp;
        const R ab = X[0][d] - X[1][d];
        r2 += ab * ab;
        xpa[d] = P[d] - X[0][d];
        xpb[d] = P[d] - X[1][d];
      }
      const R epab = f_exp(-(ea * eb * invp) * r2);
      e_tables_rt<R, LM>(Eab, la, lb, (R)0.5 * invp, xpa, xpb, epab);

      for (int pc = 0; pc < c.np[2]; ++pc) {
        const R ec = ld<R>(c.exps[2], row[2] * c.np[2] + pc);
        const R cc = ld<R>(c.coefs[2], row[2] * c.np[2] + pc);
        for (int pd = 0; pd < c.np[3]; ++pd) {
          const R ed = ld<R>(c.exps[3], row[3] * c.np[3] + pd);
          const R ccd = cc * ld<R>(c.coefs[3], row[3] * c.np[3] + pd);
          if (ccd == (R)0) continue;
          const R q = ec + ed, invq = (R)1 / q;
          R Q[3], xqc[3], xqd[3], s2 = 0;
          for (int d = 0; d < 3; ++d) {
            Q[d] = (ec * X[2][d] + ed * X[3][d]) * invq;
            const R cd = X[2][d] - X[3][d];
            s2 += cd * cd;
            xqc[d] = Q[d] - X[2][d];
            xqd[d] = Q[d] - X[3][d];
          }
          const R epcd = f_exp(-(ec * ed * invq) * s2);
          e_tables_rt<R, LM>(Ecd, lc, ld_, (R)0.5 * invq, xqc, xqd, epcd);

          const R pq_sum = p + q;
          R theta = p * q / pq_sum;
          R pref = (R)kTwoPi25 / (p * q * f_sqrt(pq_sum));
          if (omega > (R)0) {
            const R w2 = omega * omega;
            const R fac = w2 / (theta + w2);
            theta *= fac;
            pref *= f_sqrt(fac);
          }
          pref *= cab * ccd;
          const R PQ[3] = {P[0] - Q[0], P[1] - Q[1], P[2] - Q[2]};
          boys(L, theta * (PQ[0] * PQ[0] + PQ[1] * PQ[1] + PQ[2] * PQ[2]), F);
          const R m2t = (R)-2 * theta;
          pw[0] = 1;
          for (int m = 1; m <= L; ++m) pw[m] = pw[m - 1] * m2t;
          Rt[0] = pw[L] * F[L];
          for (int m = L - 1; m >= 0; --m) {
            for (int sm = L - m; sm >= 1; --sm) {
              for (int tt = 0; tt <= sm; ++tt) {
                for (int uu = 0; uu <= sm - tt; ++uu) {
                  const int vv = sm - tt - uu;
                  R val;
                  if (tt > 0) {
                    val = PQ[0] * Rt[tri_index(tt - 1, uu, vv)];
                    if (tt > 1) val += (R)(tt - 1) * Rt[tri_index(tt - 2, uu, vv)];
                  } else if (uu > 0) {
                    val = PQ[1] * Rt[tri_index(tt, uu - 1, vv)];
                    if (uu > 1) val += (R)(uu - 1) * Rt[tri_index(tt, uu - 2, vv)];
                  } else {
                    val = PQ[2] * Rt[tri_index(tt, uu, vv - 1)];
                    if (vv > 1) val += (R)(vv - 1) * Rt[tri_index(tt, uu, vv - 2)];
                  }
                  Rt[tri_index(tt, uu, vv)] = val;
                }
              }
            }
            Rt[0] = pw[m] * F[m];
          }

          for (int fcd = fcd0; fcd < fcd1; ++fcd) {
            const Tuv cc3 = cart(lc, fcd / nfd), dd3 = cart(ld_, fcd % nfd);
            const R* Ex = Ecd + (cc3.t * NJ + dd3.t) * NT;
            const R* Ey = Ecd + ND + (cc3.u * NJ + dd3.u) * NT;
            const R* Ez = Ecd + 2 * ND + (cc3.v * NJ + dd3.v) * NT;
            for (int sb = 0; sb <= lab; ++sb) {
              for (int tb = 0; tb <= sb; ++tb) {
                for (int ub = 0; ub <= sb - tb; ++ub) {
                  const int vb = sb - tb - ub;
                  R acc = 0;
                  for (int tk = 0; tk <= cc3.t + dd3.t; ++tk) {
                    for (int uk = 0; uk <= cc3.u + dd3.u; ++uk) {
                      const R exy = Ex[tk] * Ey[uk];
                      for (int vk = 0; vk <= cc3.v + dd3.v; ++vk) {
                        const R e = exy * Ez[vk];
                        const R r = Rt[tri_index(tb + tk, ub + uk, vb + vk)];
                        acc += ((tk + uk + vk) & 1) ? -e * r : e * r;
                      }
                    }
                  }
                  s[tri_index(tb, ub, vb)] = acc;
                }
              }
            }
            for (int fab = 0; fab < nfab; ++fab) {
              const Tuv aa = cart(la, fab / nfb), bb = cart(lb, fab % nfb);
              const R* Fx = Eab + (aa.t * NJ + bb.t) * NT;
              const R* Fy = Eab + ND + (aa.u * NJ + bb.u) * NT;
              const R* Fz = Eab + 2 * ND + (aa.v * NJ + bb.v) * NT;
              R acc = 0;
              for (int tb = 0; tb <= aa.t + bb.t; ++tb) {
                for (int ub = 0; ub <= aa.u + bb.u; ++ub) {
                  const R exy = Fx[tb] * Fy[ub];
                  for (int vb = 0; vb <= aa.v + bb.v; ++vb)
                    acc += exy * Fz[vb] * s[tri_index(tb, ub, vb)];
                }
              }
              out[(long long)(fab * nfcd + fcd) * T + t] += pref * acc;
            }
          }
        }
      }
    }
  }
}

template <typename R, int LM>
__global__ void __launch_bounds__(kThreads)
    eri_generic_kernel(Centers c, int T, R omega, R* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < T)
    eri_generic_task<R, LM>(c, T, omega, out, t, 0,
                            ncart(c.l[2]) * ncart(c.l[3]));
}

// ------------------------------------------------ the class kernels' chain
// 1-D Hermite E tables of one pair, all three dimensions (e_scalar):
// E[d][i][j][t], i <= LI, j <= LJ, t <= i + j.
template <typename R, int LI, int LJ>
__device__ __forceinline__ void e_tables(R (&E)[3][LI + 1][LJ + 1][LI + LJ + 1],
                                         R inv2p, const R (&xpa)[3],
                                         const R (&xpb)[3], R epref) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    E[d][0][0][0] = d == 0 ? epref : (R)1;
#pragma unroll
    for (int i = 0; i < LI; ++i) {
#pragma unroll
      for (int t = 0; t <= LI; ++t) {
        if (t > i + 1) continue;
        R v = 0;
        if (t >= 1) v += inv2p * E[d][i][0][t - 1];
        if (t <= i) v += xpa[d] * E[d][i][0][t];
        if (t + 1 <= i) v += (R)(t + 1) * E[d][i][0][t + 1];
        E[d][i + 1][0][t] = v;
      }
    }
#pragma unroll
    for (int j = 0; j < LJ; ++j) {
#pragma unroll
      for (int i = 0; i <= LI; ++i) {
#pragma unroll
        for (int t = 0; t <= LI + LJ; ++t) {
          if (t > i + j + 1) continue;
          R v = 0;
          if (t >= 1) v += inv2p * E[d][i][j][t - 1];
          if (t <= i + j) v += xpb[d] * E[d][i][j][t];
          if (t + 1 <= i + j) v += (R)(t + 1) * E[d][i][j][t + 1];
          E[d][i][j + 1][t] = v;
        }
      }
    }
  }
}

// Hermite Coulomb R^0_{tuv}, t + u + v <= L (r_scalar): level m from L - 1
// down to 0, each level's entries by descending sum, so the level m + 1
// values it reads are not yet overwritten.
template <typename R, int L>
__device__ __forceinline__ void r_table(R (&Rt)[ntri(L)], const R (&F)[L + 1],
                                        R m2t, const R (&PQ)[3]) {
  R pw[L + 1];
  pw[0] = 1;
#pragma unroll
  for (int m = 1; m <= L; ++m) pw[m] = pw[m - 1] * m2t;
  Rt[0] = pw[L] * F[L];
  unroll<L>([&](auto I) {
    constexpr int m = L - 1 - decltype(I)::value;
    constexpr int n = ntri(L - m);
    unroll<n - 1>([&](auto J) {
      constexpr int k = n - 1 - decltype(J)::value;
      constexpr Tuv e = tri_entry(k);
      R val;
      if constexpr (e.t > 0) {
        val = PQ[0] * Rt[tri_index(e.t - 1, e.u, e.v)];
        if constexpr (e.t > 1)
          val += (R)(e.t - 1) * Rt[tri_index(e.t - 2, e.u, e.v)];
      } else if constexpr (e.u > 0) {
        val = PQ[1] * Rt[tri_index(e.t, e.u - 1, e.v)];
        if constexpr (e.u > 1)
          val += (R)(e.u - 1) * Rt[tri_index(e.t, e.u - 2, e.v)];
      } else {
        val = PQ[2] * Rt[tri_index(e.t, e.u, e.v - 1)];
        if constexpr (e.v > 1)
          val += (R)(e.v - 1) * Rt[tri_index(e.t, e.u, e.v - 2)];
      }
      Rt[k] = val;
    });
    Rt[0] = pw[m] * F[m];
  });
}

// the values of its task's block one thread keeps in registers
template <typename R>
struct AccCap;
template <>
struct AccCap<float> {
  static constexpr int value = 64;
};
template <>
struct AccCap<double> {
  static constexpr int value = 32;
};

// Classes with L = la + lb + lc + ld above this run the first design's
// loop, one thread per task and ket component: fully unrolled, each of
// (2,1,2,2), (2,2,2,1) and (2,2,2,2) took longer to build than a whole
// d-class source does now, and spilled kilobytes at 255 registers.
constexpr int kUnrolledL = 6;

template <typename R, int LA, int LB, int LC, int LD>
struct ClassShape {
  static constexpr int NFB = ncart(LB), NFD = ncart(LD);
  static constexpr int NFAB = ncart(LA) * NFB, NFCD = ncart(LC) * NFD;
  static constexpr int LAB = LA + LB, LCD = LC + LD, L = LAB + LCD;
  static constexpr bool UNROLLED = L <= kUnrolledL;
  // ket components per slice (one blockIdx.y each): NFAB * SLICE sums
  static constexpr int NS0 =
      (NFAB * NFCD + AccCap<R>::value - 1) / AccCap<R>::value;
  static constexpr int SLICE = UNROLLED ? (NFCD + NS0 - 1) / NS0 : 1;
  static constexpr int NSLICE = (NFCD + SLICE - 1) / SLICE;
};

// Ket component FCD of one primitive quartet, added into acc[:][J]: the
// ket contraction s[tuv] = sum_k (-1)^(tk+uk+vk) Ecd(k) R[tuv + k] over
// the nonzero ket E terms, then each bra component's contraction with s.
template <typename R, int LA, int LB, int LC, int LD, int FCD, int J,
          int NSL>
__device__ __forceinline__ void add_ket_component(
    R (&acc)[ClassShape<R, LA, LB, LC, LD>::NFAB][NSL],
    const R (&Eab)[3][LA + 1][LB + 1][LA + LB + 1],
    const R (&Ecd)[3][LC + 1][LD + 1][LC + LD + 1],
    const R (&Rt)[ntri(LA + LB + LC + LD)], R pref) {
  using S = ClassShape<R, LA, LB, LC, LD>;
  constexpr Tuv c = cart(LC, FCD / S::NFD), d = cart(LD, FCD % S::NFD);
  constexpr int KX = c.t + d.t + 1, KY = c.u + d.u + 1, KZ = c.v + d.v + 1;
  R ek[KX][KY][KZ];
#pragma unroll
  for (int tk = 0; tk < KX; ++tk) {
#pragma unroll
    for (int uk = 0; uk < KY; ++uk) {
      const R exy = Ecd[0][c.t][d.t][tk] * Ecd[1][c.u][d.u][uk];
#pragma unroll
      for (int vk = 0; vk < KZ; ++vk) {
        const R e = exy * Ecd[2][c.v][d.v][vk];
        ek[tk][uk][vk] = ((tk + uk + vk) & 1) ? -e : e;
      }
    }
  }
  R s[ntri(S::LAB)];
  unroll<ntri(S::LAB)>([&](auto K) {
    constexpr int k = decltype(K)::value;
    constexpr Tuv b = tri_entry(k);
    R a = 0;
#pragma unroll
    for (int tk = 0; tk < KX; ++tk) {
#pragma unroll
      for (int uk = 0; uk < KY; ++uk) {
#pragma unroll
        for (int vk = 0; vk < KZ; ++vk)
          a += ek[tk][uk][vk] * Rt[tri_index(b.t + tk, b.u + uk, b.v + vk)];
      }
    }
    s[k] = a;
  });
  unroll<S::NFAB>([&](auto FAB) {
    constexpr int fab = decltype(FAB)::value;
    constexpr Tuv a = cart(LA, fab / S::NFB), b = cart(LB, fab % S::NFB);
    R v = 0;
#pragma unroll
    for (int tb = 0; tb <= a.t + b.t; ++tb) {
#pragma unroll
      for (int ub = 0; ub <= a.u + b.u; ++ub) {
        const R exy = Eab[0][a.t][b.t][tb] * Eab[1][a.u][b.u][ub];
#pragma unroll
        for (int vb = 0; vb <= a.v + b.v; ++vb)
          v += exy * Eab[2][a.v][b.v][vb] * s[tri_index(tb, ub, vb)];
      }
    }
    acc[fab][J] += pref * v;
  });
}

// One task (t) and one ket-component slice of a specialised class.
template <typename R, int LA, int LB, int LC, int LD>
__device__ __forceinline__ void eri_class_task(const Centers& c, int T,
                                               R omega, R* __restrict__ out,
                                               int t, int slice) {
  using S = ClassShape<R, LA, LB, LC, LD>;
  constexpr int L = S::L;
  if constexpr (!S::UNROLLED) {
    // the first design's loop (l <= 2 scratch) for ket component `slice`,
    // which adds into its part of the block: zeroed here, so the
    // wrapper's buffer may be empty
    for (int fab = 0; fab < S::NFAB; ++fab)
      out[(long long)(fab * S::NFCD + slice) * T + t] = 0;
    eri_generic_task<R, 2>(c, T, omega, out, t, slice, slice + 1);
    return;
  }
  long long row[4];
  R X[4][3];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    row[k] = c.idx[k] ? (long long)c.idx[k][t] : (long long)t;
#pragma unroll
    for (int d = 0; d < 3; ++d) X[k][d] = ld<R>(c.coord[k], row[k] * 3 + d);
  }
  R acc[S::NFAB][S::SLICE];
#pragma unroll
  for (int f = 0; f < S::NFAB; ++f) {
#pragma unroll
    for (int j = 0; j < S::SLICE; ++j) acc[f][j] = 0;
  }

  for (int pa = 0; pa < c.np[0]; ++pa) {
    const R ea = ld<R>(c.exps[0], row[0] * c.np[0] + pa);
    const R ca = ld<R>(c.coefs[0], row[0] * c.np[0] + pa);
    for (int pb = 0; pb < c.np[1]; ++pb) {
      const R eb = ld<R>(c.exps[1], row[1] * c.np[1] + pb);
      const R cab = ca * ld<R>(c.coefs[1], row[1] * c.np[1] + pb);
      if (cab == (R)0) continue;
      // bra pair data (make_pair_data_c)
      const R p = ea + eb, invp = (R)1 / p;
      R P[3], xpa[3], xpb[3], r2 = 0;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        P[d] = (ea * X[0][d] + eb * X[1][d]) * invp;
        const R ab = X[0][d] - X[1][d];
        r2 += ab * ab;
        xpa[d] = P[d] - X[0][d];
        xpb[d] = P[d] - X[1][d];
      }
      const R epab = f_exp(-(ea * eb * invp) * r2);
      R Eab[3][LA + 1][LB + 1][S::LAB + 1];
      e_tables<R, LA, LB>(Eab, (R)0.5 * invp, xpa, xpb, epab);

      for (int pc = 0; pc < c.np[2]; ++pc) {
        const R ec = ld<R>(c.exps[2], row[2] * c.np[2] + pc);
        const R cc = ld<R>(c.coefs[2], row[2] * c.np[2] + pc);
        for (int pd = 0; pd < c.np[3]; ++pd) {
          const R ed = ld<R>(c.exps[3], row[3] * c.np[3] + pd);
          const R ccd = cc * ld<R>(c.coefs[3], row[3] * c.np[3] + pd);
          if (ccd == (R)0) continue;
          const R q = ec + ed, invq = (R)1 / q;
          R Q[3], xqc[3], xqd[3], s2 = 0;
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            Q[d] = (ec * X[2][d] + ed * X[3][d]) * invq;
            const R cd = X[2][d] - X[3][d];
            s2 += cd * cd;
            xqc[d] = Q[d] - X[2][d];
            xqd[d] = Q[d] - X[3][d];
          }
          const R epcd = f_exp(-(ec * ed * invq) * s2);
          R Ecd[3][LC + 1][LD + 1][S::LCD + 1];
          e_tables<R, LC, LD>(Ecd, (R)0.5 * invq, xqc, xqd, epcd);

          // R with the erf attenuation for omega > 0
          const R pq_sum = p + q;
          R theta = p * q / pq_sum;
          R pref = (R)kTwoPi25 / (p * q * f_sqrt(pq_sum));
          if (omega > (R)0) {
            const R w2 = omega * omega;
            const R fac = w2 / (theta + w2);
            theta *= fac;
            pref *= f_sqrt(fac);
          }
          pref *= cab * ccd;
          const R PQ[3] = {P[0] - Q[0], P[1] - Q[1], P[2] - Q[2]};
          R F[L + 1];
          boys(L, theta * (PQ[0] * PQ[0] + PQ[1] * PQ[1] + PQ[2] * PQ[2]), F);
          R Rt[ntri(L)];
          r_table<R, L>(Rt, F, (R)-2 * theta, PQ);

          unroll<S::NSLICE>([&](auto SL) {
            constexpr int s0 = decltype(SL)::value;
            if (slice != s0) return;
            unroll<S::SLICE>([&](auto JJ) {
              constexpr int j = decltype(JJ)::value;
              constexpr int fcd = s0 * S::SLICE + j;
              if constexpr (fcd < S::NFCD)
                add_ket_component<R, LA, LB, LC, LD, fcd, j, S::SLICE>(
                    acc, Eab, Ecd, Rt, pref);
            });
          });
        }
      }
    }
  }
  // one store per element, coalesced across the warp's tasks
#pragma unroll
  for (int j = 0; j < S::SLICE; ++j) {
    const int fcd = slice * S::SLICE + j;
    if (fcd >= S::NFCD) break;
#pragma unroll
    for (int fab = 0; fab < S::NFAB; ++fab)
      out[(long long)(fab * S::NFCD + fcd) * T + t] = acc[fab][j];
  }
}

// grid (ceil(T / kThreads), NSLICE): a thread per task and ket slice
template <typename R, int LA, int LB, int LC, int LD>
__global__ void __launch_bounds__(kThreads)
    eri_class_kernel(Centers c, int T, R omega, R* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < T) eri_class_task<R, LA, LB, LC, LD>(c, T, omega, out, t, blockIdx.y);
}

}  // namespace jqc_eri
