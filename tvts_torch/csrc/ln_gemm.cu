// One ln_gemm kernel, variant TVTS_GEMM_PART of ln_gemm.cuh's list: this unit
// is compiled once for each variant, all of them in parallel
// (tvts_torch/ops/block_kernels.py::build).
#include "ln_gemm.cuh"

#define TVTS_CAT_(a, b) a##b
#define TVTS_CAT(a, b) TVTS_CAT_(a, b)

namespace tvts {
TVTS_GEMM_LAUNCHER(TVTS_CAT(TVTS_GEMM_VARIANT_, TVTS_GEMM_PART));
}  // namespace tvts
