// Device helpers shared by the SMO kernels (smo_update.cu, smo_chunk.cu).
//
// Every kernel of the port is compiled with -fmad=false, so nvcc contracts
// nothing on its own: the one fused multiply-add below is the rounding the
// JAX reference gets from XLA-CPU for f + delta * (K_i - K_j), and every other
// expression rounds op by op, as the plain PyTorch versions do.
#pragma once

#include <cuda_runtime.h>

// The SMO rank-2 indicator update of one element: f + delta * (K_i - K_j),
// with one rounding of the product-sum. Reused as the chunk kernel's tail.
__device__ __forceinline__ double smo_f_update_elem(double f, double ki,
                                                    double kj, double delta) {
  return fma(delta, ki - kj, f);
}

// NaN-propagating min / max: jnp.minimum / maximum / clip and torch's
// minimum / clamp return NaN when an operand is NaN; CUDA's fmin / fmax drop it.
__device__ __forceinline__ double nan_min(double a, double b) {
  return (isnan(a) || isnan(b)) ? a + b : (b < a ? b : a);
}

__device__ __forceinline__ double nan_max(double a, double b) {
  return (isnan(a) || isnan(b)) ? a + b : (b > a ? b : a);
}
