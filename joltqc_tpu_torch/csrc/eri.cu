// Kernel A, the generic route: eri_generic_kernel<R, 4> (csrc/eri.cuh)
// for every class that has no specialised kernel -- l = 3 or 4 (def2-tzvpp
// has f shells) and non-canonical l-tuples from direct callers of
// ops/eri.py::eri_chunk.  The J/K engine's classes with l <= 2 take
// eri_class_kernel (csrc/eri_class.cu); eri_chunk counts the launches
// of this route apart (eri_chunk.generic_launches).
// It keeps the first design: one thread per task, run-time angular
// momenta, scratch sized for l <= 4 in local memory, and each primitive
// quartet's block added into the output, which the wrapper zeroes.

#include "eri.cuh"

// ptrs: per center a..d, (coord, exps, coefs, idx-or-null).
// dtype 0 = float32 (f32 tier), 1 = float64 (fp64 tier).
extern "C" int jqc_eri_launch(int dtype, void* const* ptrs, const int* ls,
                              const int* nprims, int T, double omega,
                              void* out, void* stream) {
  using jqc_eri::eri_generic_kernel;
  using jqc_eri::kThreads;
  const jqc_eri::Centers c = jqc_eri::make_centers(ptrs, ls, nprims);
  for (int k = 0; k < 4; ++k)
    if (ls[k] < 0 || ls[k] > 4) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    eri_generic_kernel<float, 4><<<grid, kThreads, 0, s>>>(
        c, T, (float)omega, static_cast<float*>(out));
  else
    eri_generic_kernel<double, 4><<<grid, kThreads, 0, s>>>(
        c, T, omega, static_cast<double*>(out));
  return (int)cudaGetLastError();
}
