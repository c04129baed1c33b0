// RPR004 fixture: kernel-source constraints of the port's CUDA sources.
#include <cuda_runtime.h>

constexpr int kThreads = 256;

// RPR004 (below): no __launch_bounds__
__global__ void no_bounds(float* out, const float* in, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = in[i];
}

template <int D>
__global__ void __launch_bounds__(kThreads)
float_atomics(float* __restrict__ sums, double* total, const float* x,
              int* counts, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  atomicAdd(sums + i % D, x[i]);                          // RPR004
  atomicAdd(total, static_cast<double>(x[i]));            // RPR004
  atomicAdd(reinterpret_cast<float*>(counts), 1.0f);      // RPR004
  atomicAdd(&counts[i % D], 1);    // an integer atomic: exact, fine
}

// a comment that mentions __global__ void commented(float* p) and
// atomicAdd(p, 1.0f) is not code
__global__ void __launch_bounds__(kThreads, 4)
clean(const float* __restrict__ x, float* __restrict__ partial, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) partial[i] = 2.0f * x[i];
}
