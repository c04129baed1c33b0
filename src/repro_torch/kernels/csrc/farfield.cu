// Barnes-Hut cell interaction for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel `repro/kernels/farfield.py::bh_interaction_pallas`
// (body `_bh_kernel`).  Same contract as the plain PyTorch version
// `repro_torch/kernels/ref.py::bh_interaction_ref`: for X (N, d), an
// interaction batch idx (N, W) int32 into a target table (M, d) and slot
// weights w (N, W),
//
//     t_nj = |x_n - c_j|^2,  c_j = table[idx[n, j]]
//     s_n  = sum_j w_nj sp(t_nj)
//     F_n  = sum_j w_nj b(t_nj) (x_n - c_j)
//
// with (sp, b) the per-kind repulsive pair terms of ref.py's
// `negative_pair_terms`: exp(-t) for both (ee, ssne); K = 1/(1+t) and K^2
// (tee, tsne); max(1 - t, 0) and [t < 1] (epan).  The table holds cell
// centres of mass, the points themselves (the near field, table = X) or the
// residual centres of mass; sparse/farfield.py builds the batches.  X and
// the table are float32 or bfloat16 (widened to f32 after the load); w is
// always float32, since it carries cell occupancies; sums and outputs are
// float32.
//
// Bound on an H100 SXM (3.35 TB/s; ~15 flops and one exp or division a
// slot): memory.  The least traffic is the batch streamed once, N W 8 bytes
// of idx and w, plus X, the table and the outputs once.  At N = 70000 in
// float32 a far-field level (W = 96, 65536 table rows) is 55.7 MB, ~16.6 us;
// a near chunk (W = 128, whose table is X, read once) is 73.1 MB, ~21.8 us.
// The gathered table rows come from L2: a far table is at
// most 65536 x 2 x 4 B = 0.5 MB and the near table (X) 0.56 MB, against the
// 50 MB L2.  The design follows the ELL gather (csrc/ell.cu):
//
//   * A group of S lanes owns one row: a whole warp for W >= 32, else the
//     largest power of two <= W (at least 4), so that the 25-wide residual
//     batch runs 16 lanes a row and short rows keep the lanes busy.  Lanes
//     stride over the row's slots, so idx and w stream in coalesced,
//     evict-first loads; rows may be a column slice of a wider batch (the
//     row strides ld_idx and ld_w), so the caller's chunks need no copy.
//   * A slot with w = 0 (a rejected far cell, an empty or clipped near slot,
//     the self pair) skips its gather and adds exactly nothing.
//   * t is the difference form sum_c (x_c - c_c)^2, not the TPU kernel's
//     Gram identity |x|^2 + |c|^2 - 2 x.c, which existed to put x.c on the
//     MXU: at d = 2 the differences cost the same, give F's (x_n - c_j)
//     directly and do not cancel for near pairs at t ~ 0.  F is summed as
//     sum_j w b (x_n - c_j), not as the TPU kernel's (sum_j w b) x_n -
//     sum_j w b c_j, which loses digits when x_n is far from the origin and
//     near its targets; the plain version sums the same way, so the two
//     differ only in the order of the sums.  expf and the division are the
//     accurate ones (no fast-math).
//   * d is a template parameter for d <= 4 (the tree is 2-D); the wrapper
//     raises above that.
//   * No float atomics: each row is summed by one group in a fixed order
//     (strided slots, then a butterfly of shuffles), so reruns are
//     bit-identical.
//   * Indices must lie in [0, M); the kernel does not check them.
//
// Built by `repro_torch/kernels/_build.py` with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (`bh_interaction_launch`, plain C interface).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// kinds in ref.py's order: ee, ssne, tsne, tee, epan
enum Pair { GAUSS = 0, STUDENT = 1, EPAN = 2 };

constexpr int kThreads = 256;          // 8 warps a block

// bf16 is carried as its raw 16 bits; widening to f32 is exact.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

template <int PAIR>
__device__ __forceinline__ void pair_terms(float t, float& sp, float& b) {
  if constexpr (PAIR == GAUSS) {
    sp = expf(-t);
    b = sp;
  } else if constexpr (PAIR == STUDENT) {
    const float K = 1.0f / (1.0f + t);
    sp = K;
    b = K * K;
  } else {
    sp = fmaxf(1.0f - t, 0.0f);
    b = t < 1.0f ? 1.0f : 0.0f;
  }
}

// Sum (s, f[0..D)) over the S lanes of a group, in a fixed order.
template <int D, int S>
__device__ __forceinline__ void group_reduce(float& s, float (&f)[D]) {
#pragma unroll
  for (int off = S / 2; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
#pragma unroll
    for (int c = 0; c < D; ++c) f[c] += __shfl_xor_sync(0xffffffffu, f[c], off);
  }
}

template <typename T, int PAIR, int D, int S>
__global__ void __launch_bounds__(kThreads)
bh_rows(const T* __restrict__ X, const int* __restrict__ idx, long long ld_idx,
        const float* __restrict__ w, long long ld_w,
        const T* __restrict__ table, int n, int width,
        float* __restrict__ s_out, float* __restrict__ f_out) {
  const int lane = threadIdx.x % S;
  const long long r = (static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x) / S;
  const bool live = r < n;   // dead lanes still join the shuffles
  float s = 0.f;
  float f[D];
#pragma unroll
  for (int c = 0; c < D; ++c) f[c] = 0.f;
  if (live) {
    float x[D];
#pragma unroll
    for (int c = 0; c < D; ++c) x[c] = widen(__ldg(X + r * D + c));
    const int* ir = idx + r * ld_idx;
    const float* wr = w + r * ld_w;
    for (int j = lane; j < width; j += S) {
      const float wj = __ldcs(wr + j);
      const int m = __ldcs(ir + j);
      if (wj == 0.0f) continue;            // masked slot: adds nothing
      const T* cm = table + static_cast<size_t>(m) * D;
      float diff[D];
      float t = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        diff[c] = x[c] - widen(__ldg(cm + c));
        t += diff[c] * diff[c];
      }
      float sp, b;
      pair_terms<PAIR>(t, sp, b);
      s += wj * sp;
      const float wb = wj * b;
#pragma unroll
      for (int c = 0; c < D; ++c) f[c] += wb * diff[c];
    }
  }
  group_reduce<D, S>(s, f);
  if (live && lane == 0) {
    s_out[r] = s;
#pragma unroll
    for (int c = 0; c < D; ++c) f_out[r * D + c] = f[c];
  }
}

template <typename T, int PAIR, int D, int S>
int launch(const T* X, const int* idx, long long ld_idx, const float* w,
           long long ld_w, const T* table, int n, int width, float* s_out,
           float* f_out, cudaStream_t st) {
  const long long threads = static_cast<long long>(n) * S;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  bh_rows<T, PAIR, D, S><<<grid, kThreads, 0, st>>>(
      X, idx, ld_idx, w, ld_w, table, n, width, s_out, f_out);
  return static_cast<int>(cudaGetLastError());
}

// S: the lanes a row, the largest power of two <= width in [4, 32].
template <typename T, int PAIR, int D>
int launch_s(const T* X, const int* idx, long long ld_idx, const float* w,
             long long ld_w, const T* table, int n, int width, float* s_out,
             float* f_out, cudaStream_t st) {
  if (width >= 32)
    return launch<T, PAIR, D, 32>(X, idx, ld_idx, w, ld_w, table, n, width, s_out, f_out, st);
  if (width >= 16)
    return launch<T, PAIR, D, 16>(X, idx, ld_idx, w, ld_w, table, n, width, s_out, f_out, st);
  if (width >= 8)
    return launch<T, PAIR, D, 8>(X, idx, ld_idx, w, ld_w, table, n, width, s_out, f_out, st);
  return launch<T, PAIR, D, 4>(X, idx, ld_idx, w, ld_w, table, n, width, s_out, f_out, st);
}

template <typename T, int PAIR>
int launch_d(const T* X, const int* idx, long long ld_idx, const float* w,
             long long ld_w, const T* table, int n, int d, int width,
             float* s_out, float* f_out, cudaStream_t st) {
  switch (d) {
    case 1: return launch_s<T, PAIR, 1>(X, idx, ld_idx, w, ld_w, table, n, width, s_out, f_out, st);
    case 2: return launch_s<T, PAIR, 2>(X, idx, ld_idx, w, ld_w, table, n, width, s_out, f_out, st);
    case 3: return launch_s<T, PAIR, 3>(X, idx, ld_idx, w, ld_w, table, n, width, s_out, f_out, st);
    default: return launch_s<T, PAIR, 4>(X, idx, ld_idx, w, ld_w, table, n, width, s_out, f_out, st);
  }
}

template <typename T>
int launch_kind(int kind, const void* Xv, const int* idx, long long ld_idx,
                const float* w, long long ld_w, const void* tv, int n, int d,
                int width, float* s_out, float* f_out, cudaStream_t st) {
  const T* X = static_cast<const T*>(Xv);
  const T* table = static_cast<const T*>(tv);
  if (kind <= 1)
    return launch_d<T, GAUSS>(X, idx, ld_idx, w, ld_w, table, n, d, width, s_out, f_out, st);
  if (kind <= 3)
    return launch_d<T, STUDENT>(X, idx, ld_idx, w, ld_w, table, n, d, width, s_out, f_out, st);
  return launch_d<T, EPAN>(X, idx, ld_idx, w, ld_w, table, n, d, width, s_out, f_out, st);
}

}  // namespace

// X (n, d) and table (m, d): row-major, contiguous, in the storage type
// (bf16 != 0: bfloat16, else float32).  idx (n, width) int32 and w (n,
// width) float32: unit column stride, row strides ld_idx and ld_w.  kind:
// index into ("ee", "ssne", "tsne", "tee", "epan").  s_out (n,) and f_out
// (n, d): float32, contiguous.  Enqueues on `stream` and returns the launch
// status (cudaError_t as int).
extern "C" int bh_interaction_launch(const void* X, const void* idx,
                                     long long ld_idx, const void* w,
                                     long long ld_w, const void* table, int n,
                                     int m, int d, int width, int kind,
                                     int bf16, void* s_out, void* f_out,
                                     void* stream) {
  if (n < 0 || m < 1 || d < 1 || d > 4 || width < 1 || kind < 0 ||
      kind > 4 || ld_idx < width || ld_w < width)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  const float* wp = static_cast<const float*>(w);
  float* so = static_cast<float*>(s_out);
  float* fo = static_cast<float*>(f_out);
  return bf16 ? launch_kind<uint16_t>(kind, X, ip, ld_idx, wp, ld_w, table, n,
                                      d, width, so, fo, st)
              : launch_kind<float>(kind, X, ip, ld_idx, wp, ld_w, table, n, d,
                                   width, so, fo, st);
}
