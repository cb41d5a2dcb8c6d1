// Contracted-ERI class chunk: hand-written CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel joltqc_tpu/ops/eri_pallas.py
// (eri_chunk_pallas / _kernel_fn, pl.pallas_call at :291), which runs the
// scalar McMurchie-Davidson chain of ops/md.py (make_pair_data_c,
// e_scalar, r_scalar, eri_scalar_g_rows) with a grid over primitive
// quartets.  Plain version: joltqc_tpu_torch/ops/md.py::eri_plain.
//
// What bounds it on the card: arithmetic.  Per task and primitive quartet
// the chain does the Boys function, the E and R recursions and the
// assembly, O(10^2..10^4) FLOPs against ~100 bytes of task geometry in,
// and each output element is written once per primitive quartet.  This
// first design runs far above that bound (about 170x at the (2,1,1,0)
// f32 class of a 302-AO 6-31g* Fock build on an H100 at 700 W, see
// PERF.md): per-thread scratch lives in local memory and each thread runs
// its whole chain serially.
//
// Design (simple and correct first):
//  - one thread per task; the primitive-quartet loop runs inside the
//    thread and skips quartets whose coefficient product is zero (the
//    padded primitives of merged classes and the pad shell);
//  - per quartet: Boys F_0..F_L (the algorithms of ops/boys.py in native
//    float / double), the 1-D E tables per dimension, R by the r_scalar
//    recursion (in place, descending Hermite order), then the ket-then-
//    bra assembly of eri_scalar_g_rows restricted to the nonzero E terms;
//  - the thread accumulates only into its own task's outputs, in a
//    component-major (nfab*nfcd, T) buffer zeroed by the wrapper: no
//    races, no atomics, and stores coalesce across the warp;
//  - per-thread scratch (E tables, R, Boys values, the ket-contracted
//    vector) is sized by the template parameter LM = max l of the class,
//    so s/p/d classes do not pay the local memory of g classes;
//  - geometry is read through optional per-center row indices, so the
//    J/K engine passes its per-class shell tables and task indices and
//    no gathered copy is made.
// f32 tier: float arithmetic throughout; fp64 tier: double.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr double kTwoPi25 = 34.98683665524972;  // 2 * pi^(5/2)
constexpr double kSqrtPiOver2 = 0.88622692545275801;
constexpr double kInvSqrtPi = 0.56418958354775628;

struct Centers {
  const void* coord[4];
  const void* exps[4];
  const void* coefs[4];
  const int* idx[4];
  int l[4];
  int np[4];
};

__device__ __forceinline__ int tri_index(int t, int u, int v) {
  const int s = t + u + v;
  return s * (s + 1) * (s + 2) / 6 + t * (s + 1) - t * (t - 1) / 2 + u;
}

__device__ __forceinline__ int ncart(int l) { return (l + 1) * (l + 2) / 2; }

// Cartesian component c of shell l, ordered (lx desc, ly desc).
__device__ __forceinline__ void cart_comp(int l, int c, int& lx, int& ly,
                                          int& lz) {
  int x = l;
  while (c > l - x) {
    c -= l - x + 1;
    --x;
  }
  lx = x;
  ly = l - x - c;
  lz = c;
}

__device__ __forceinline__ float f_exp(float x) { return expf(x); }
__device__ __forceinline__ double f_exp(double x) { return exp(x); }
__device__ __forceinline__ float f_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double f_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float f_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double f_rsqrt(double x) { return rsqrt(x); }

// Boys F_0..F_mmax (ops/boys.py): series at mmax + downward recursion
// below the switch, F_0 from erf + upward recursion above it.
__device__ void boys(int mmax, double x, double* F) {
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
    for (int m = mmax; m > 0; --m)
      F[m - 1] = (two_x * F[m] + emx) / (double)(2 * m - 1);
  } else {
    const double emx = exp(-x), inv_2x = 0.5 / x;
    double f = kSqrtPiOver2 * rsqrt(x) * erf(sqrt(x));
    F[0] = f;
    for (int m = 0; m < mmax; ++m) {
      f = ((double)(2 * m + 1) * f - emx) * inv_2x;
      F[m + 1] = f;
    }
  }
}

__device__ void boys(int mmax, float x, float* F) {
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
    for (int m = mmax; m > 0; --m)
      F[m - 1] = (two_x * F[m] + emx) / (float)(2 * m - 1);
  } else {
    // erfc(sqrt x) by its asymptotic series, as ops/boys.py::boys_f32
    const float emx = expf(-x), isx = rsqrtf(x), u = 0.5f / x;
    const float poly = 1.0f + u * (-1.0f + u * (3.0f - 15.0f * u));
    const float erf_l = 1.0f - emx * isx * (float)kInvSqrtPi * poly;
    float f = (float)kSqrtPiOver2 * isx * erf_l;
    F[0] = f;
    for (int m = 0; m < mmax; ++m) {
      f = ((float)(2 * m + 1) * f - emx) * u;
      F[m + 1] = f;
    }
  }
}

// 1-D Hermite E tables for one pair, all three dimensions:
// E[d][i][j][t], i <= li, j <= lj, t <= i + j (e_scalar of ops/md.py).
template <typename R, int LM>
__device__ void e_tables(R* E, int li, int lj, R inv2p, const R* xpa,
                         const R* xpb, R epref) {
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

template <typename R>
__device__ __forceinline__ R ld(const void* p, long long i) {
  return static_cast<const R*>(p)[i];
}

template <typename R, int LM>
__global__ void __launch_bounds__(128)
eri_kernel(Centers c, int T, R omega, R* __restrict__ out) {
  constexpr int NJ = LM + 1, NT = 2 * LM + 1, ND = (LM + 1) * NJ * NT;
  constexpr int LTOT = 4 * LM;
  constexpr int NR = (LTOT + 1) * (LTOT + 2) * (LTOT + 3) / 6;
  constexpr int NTAB = (2 * LM + 1) * (2 * LM + 2) * (2 * LM + 3) / 6;

  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;

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

  R Eab[3 * ND], Ecd[3 * ND], Rt[NR], F[LTOT + 1], pw[LTOT + 1], s[NTAB];

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
      for (int d = 0; d < 3; ++d) {
        P[d] = (ea * X[0][d] + eb * X[1][d]) * invp;
        const R ab = X[0][d] - X[1][d];
        r2 += ab * ab;
        xpa[d] = P[d] - X[0][d];
        xpb[d] = P[d] - X[1][d];
      }
      const R epab = f_exp(-(ea * eb * invp) * r2);
      e_tables<R, LM>(Eab, la, lb, (R)0.5 * invp, xpa, xpb, epab);

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
          e_tables<R, LM>(Ecd, lc, ld_, (R)0.5 * invq, xqc, xqd, epcd);

          // Hermite R (r_scalar), with the erf attenuation for omega > 0
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
            // in place: sums s descend, so level m+1 values at s-1, s-2
            // are still unread-over when level m's sum-s entries land
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

          // assembly (eri_scalar_g_rows): ket contraction into s[tb],
          // then the bra contraction of each output component
          for (int fcd = 0; fcd < nfcd; ++fcd) {
            int cx, cy, cz, dx, dy, dz;
            cart_comp(lc, fcd / nfd, cx, cy, cz);
            cart_comp(ld_, fcd % nfd, dx, dy, dz);
            const R* Ex = Ecd + (cx * NJ + dx) * NT;
            const R* Ey = Ecd + ND + (cy * NJ + dy) * NT;
            const R* Ez = Ecd + 2 * ND + (cz * NJ + dz) * NT;
            for (int sb = 0; sb <= lab; ++sb) {
              for (int tb = 0; tb <= sb; ++tb) {
                for (int ub = 0; ub <= sb - tb; ++ub) {
                  const int vb = sb - tb - ub;
                  R acc = 0;
                  for (int tk = 0; tk <= cx + dx; ++tk) {
                    for (int uk = 0; uk <= cy + dy; ++uk) {
                      const R exy = Ex[tk] * Ey[uk];
                      for (int vk = 0; vk <= cz + dz; ++vk) {
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
              int ax, ay, az, bx, by, bz;
              cart_comp(la, fab / nfb, ax, ay, az);
              cart_comp(lb, fab % nfb, bx, by, bz);
              const R* Fx = Eab + (ax * NJ + bx) * NT;
              const R* Fy = Eab + ND + (ay * NJ + by) * NT;
              const R* Fz = Eab + 2 * ND + (az * NJ + bz) * NT;
              R acc = 0;
              for (int tb = 0; tb <= ax + bx; ++tb) {
                for (int ub = 0; ub <= ay + by; ++ub) {
                  const R exy = Fx[tb] * Fy[ub];
                  for (int vb = 0; vb <= az + bz; ++vb)
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

template <typename R>
int launch(const Centers& c, int T, double omega, void* out,
           cudaStream_t stream) {
  int lm = 0;
  for (int k = 0; k < 4; ++k) lm = c.l[k] > lm ? c.l[k] : lm;
  const dim3 block(128), grid((T + 127) / 128);
  R* o = static_cast<R*>(out);
  if (lm <= 1)
    eri_kernel<R, 1><<<grid, block, 0, stream>>>(c, T, (R)omega, o);
  else if (lm == 2)
    eri_kernel<R, 2><<<grid, block, 0, stream>>>(c, T, (R)omega, o);
  else if (lm <= 4)
    eri_kernel<R, 4><<<grid, block, 0, stream>>>(c, T, (R)omega, o);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: per center a..d, (coord, exps, coefs, idx-or-null).
// dtype 0 = float32 (f32 tier), 1 = float64 (fp64 tier).
extern "C" int jqc_eri_launch(int dtype, void* const* ptrs, const int* ls,
                              const int* nprims, int T, double omega,
                              void* out, void* stream) {
  Centers c;
  for (int k = 0; k < 4; ++k) {
    c.coord[k] = ptrs[4 * k + 0];
    c.exps[k] = ptrs[4 * k + 1];
    c.coefs[k] = ptrs[4 * k + 2];
    c.idx[k] = static_cast<const int*>(ptrs[4 * k + 3]);
    c.l[k] = ls[k];
    c.np[k] = nprims[k];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(c, T, omega, out, s)
                    : launch<double>(c, T, omega, out, s);
}
