// Kernel A, the specialised classes: eri_class_kernel<R, la, lb, lc, ld>
// (csrc/eri.cuh, where the design is described) for one group of
// ops/eri.py::ERI_CLASS_GROUPS.  ops/cuda.py builds this source once per
// group into its own library (ops/eri.py::class_libraries), so that the
// groups build in parallel, with
//   -DJQC_ERI_CLASS_CODES=<codes>  la*1000 + lb*100 + lc*10 + ld of each
//                                  class, joined by '_' (e.g. 2100_2110)
//   -DJQC_ERI_TIERS=<mask>         1: f32 (float), 2: fp64 (double), 3: both
// jqc_eri_class_launch takes the arguments of jqc_eri_launch (csrc/eri.cu);
// a (tier, class) the library does not hold returns cudaErrorInvalidValue.

#include <utility>

#include "eri.cuh"

#if !defined(JQC_ERI_CLASS_CODES) || !defined(JQC_ERI_TIERS)
#error "build with -DJQC_ERI_CLASS_CODES and -DJQC_ERI_TIERS (ops/cuda.py)"
#endif

#define JQC_STR2(x) #x
#define JQC_STR(x) JQC_STR2(x)

namespace {

constexpr char kCodes[] = JQC_STR(JQC_ERI_CLASS_CODES);

constexpr int num_classes() {
  int n = 1;
  for (int i = 0; kCodes[i]; ++i) n += kCodes[i] == '_';
  return n;
}

// the k-th code of kCodes
constexpr int class_code(int k) {
  int i = 0;
  for (; k > 0; ++i) k -= kCodes[i] == '_';
  int code = 0;
  for (; kCodes[i] && kCodes[i] != '_'; ++i) code = 10 * code + (kCodes[i] - '0');
  return code;
}

template <typename R, int C>
int launch_class(const jqc_eri::Centers& cen, int T, double omega, void* out,
                 cudaStream_t stream) {
  constexpr int a = C / 1000, b = C / 100 % 10, c = C / 10 % 10, d = C % 10;
  using S = jqc_eri::ClassShape<R, a, b, c, d>;
  const dim3 grid((T + jqc_eri::kThreads - 1) / jqc_eri::kThreads, S::NSLICE);
  jqc_eri::eri_class_kernel<R, a, b, c, d>
      <<<grid, jqc_eri::kThreads, 0, stream>>>(cen, T, (R)omega,
                                               static_cast<R*>(out));
  return (int)cudaGetLastError();
}

template <typename R, int... K>
int launch_listed(int code, const jqc_eri::Centers& cen, int T, double omega,
                  void* out, cudaStream_t stream,
                  std::integer_sequence<int, K...>) {
  int rc = (int)cudaErrorInvalidValue;
  ((code == class_code(K)
        ? (void)(rc = launch_class<R, class_code(K)>(cen, T, omega, out,
                                                     stream))
        : (void)0),
   ...);
  return rc;
}

}  // namespace

extern "C" int jqc_eri_class_launch(int dtype, void* const* ptrs,
                                    const int* ls, const int* nprims, int T,
                                    double omega, void* out, void* stream) {
  const jqc_eri::Centers cen = jqc_eri::make_centers(ptrs, ls, nprims);
  const int code = ls[0] * 1000 + ls[1] * 100 + ls[2] * 10 + ls[3];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr auto classes = std::make_integer_sequence<int, num_classes()>();
  if constexpr ((JQC_ERI_TIERS & 1) != 0)
    if (dtype == 0)
      return launch_listed<float>(code, cen, T, omega, out, s, classes);
  if constexpr ((JQC_ERI_TIERS & 2) != 0)
    if (dtype == 1)
      return launch_listed<double>(code, cen, T, omega, out, s, classes);
  return (int)cudaErrorInvalidValue;
}
