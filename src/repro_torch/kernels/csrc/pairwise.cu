// Fused pairwise embedding terms for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel `repro/kernels/pairwise.py::pairwise_terms_pallas`
// (Pallas body `_pairwise_kernel` / `_tile_terms`).  Same contract as the
// plain PyTorch version `repro_torch/kernels/ref.py::pairwise_terms_ref`:
// for X (N, d) and symmetric, zero-diagonal weights Wa, Wb (N, N),
//
//     la_x = L(a) X,  lb_x = L(b) X,  e_plus,  s
//
// with the per-kind pair weights a(t), b(t) of ref.py and t = |x_n - x_m|^2.
// The N x N matrices of t, a and b are never stored.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): the kernel must read Wa and Wb once, 8 bytes a pair in f32 (4 in
// bf16), against ~25 flops a pair, so it is memory-bound by ~40x.  At
// N = 20000 that is 3.2 GB, ~0.96 ms a call in f32 and ~0.48 ms in bf16.
// The design follows from that bound:
//
//   * One warp owns one row n and streams its Wa and Wb rows once,
//     coalesced, 16 bytes a thread (float4 / 8 x bf16), with streaming
//     (evict-first) loads: the weights are touched once per call.
//   * A block of 8 warps (8 rows) stages a tile of 1024 X columns in
//     shared memory, in structure-of-arrays form so that each thread reads
//     its columns with 16-byte shared loads.  X is small (N d floats) and
//     sits in L2; the staging keeps it off the memory path of the weights.
//   * The launch shape is a runtime choice (`kernels/autotune.py` searches
//     it): 1-16 rows a block and a tile of any multiple of 32 VEC columns
//     (128 in f32, 256 in bf16), held in dynamic shared memory.  Lane l
//     takes the columns lane VEC + 32 VEC j of each tile, so with such a
//     tile every lane sums the same columns in the same order whatever the
//     tile, and a row's sums are the same bits at every shape.
//   * Per-row accumulators sum_m a (x_n - x_m), sum_m b (x_n - x_m), e_plus
//     and s live in registers; d is a template parameter for d <= 4 (the
//     paper embeds in d = 2), so nothing is padded to 128 lanes as on the
//     TPU.  Larger d takes a generic path (runtime d, four output
//     dimensions per block along gridDim.y, X read through the read-only
//     cache).
//
// What differs from the TPU kernel, and why:
//
//   * No in-order grid.  The TPU kernel accumulates la/lb row blocks across
//     column tiles, and e_plus/s across the whole grid, because its grid
//     runs in order.  Here a block loops over every column tile itself, so
//     no output is revisited across blocks.
//   * Scalars through partials, no float atomics.  Each row writes its
//     e_plus and s partials to a buffer; `reduce_partials` sums them in a
//     fixed order.  Warp reductions use a fixed butterfly.  Two runs on the
//     same inputs therefore give bit-identical outputs.
//   * The ragged edge is masked, not padded: rows past N do no work, and
//     columns past N are never read.  When N is not a multiple of the
//     vector width the rows are not 16-byte aligned, and the scalar-load
//     instantiation (VEC = 1) runs instead.
//   * t is formed as sum_k (x_nk - x_mk)^2 rather than by the Gram identity
//     |x_n|^2 + |x_m|^2 - 2 x_n.x_m: for d <= 4 it costs the same, needs no
//     clamp at 0, and cancels nothing.  The same differences give
//     L(a)X_n = sum_m a_nm (x_n - x_m) directly, where the oracle forms
//     (sum_m a_nm) x_n - sum_m a_nm x_m and loses digits when the two
//     nearly cancel (a spread-out embedding).
//   * Diagonal: like the TPU kernel, this kernel does not mask the pair
//     (n, n); its t there is exactly 0, as the oracle's is.  The contract
//     still requires Wa and Wb to have zero diagonals: the model's sums run
//     over pairs n != m, and every term below is multiplied by wa or wb, so
//     a zero weight is what keeps the pair (n, n) out of them.
//
// Built by `repro_torch/kernels/_build.py` with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (`pairwise_terms_launch`, plain C interface).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Kind { EE = 0, SSNE = 1, TSNE = 2, TEE = 3, EPAN = 4 };

constexpr int kWarps = 8;                 // default rows a block, a warp a row
constexpr int kMaxWarps = 16;             // most rows a block
constexpr int kMaxThreads = kMaxWarps * 32;
constexpr int kTileCols = 1024;           // default X columns staged a tile
constexpr int kMaxSmem = 48 * 1024;       // dynamic shared memory, no opt-in
constexpr int kReduceThreads = 1024;

// bf16 is carried as its raw 16 bits; widening to f32 is exact.
__device__ __forceinline__ float bf16_bits_to_f32(uint32_t h) {
  return __uint_as_float(h << 16);
}

template <typename T>
struct Storage;

template <>
struct Storage<float> {
  static constexpr int kVec = 4;          // 16 bytes
  __device__ static float x(const float* p) { return __ldg(p); }
  __device__ static float w(const float* p) { return __ldcs(p); }
  __device__ static void wvec(const float* p, float* out) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

template <>
struct Storage<uint16_t> {
  static constexpr int kVec = 8;          // 16 bytes
  __device__ static float x(const uint16_t* p) {
    return bf16_bits_to_f32(__ldg(p));
  }
  __device__ static float w(const uint16_t* p) {
    return bf16_bits_to_f32(*p);
  }
  __device__ static void wvec(const uint16_t* p, float* out) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      out[2 * m] = bf16_bits_to_f32(words[m] & 0xffffu);
      out[2 * m + 1] = __uint_as_float(words[m] & 0xffff0000u);
    }
  }
};

// Per-pair terms of the contract (ref.py table).  a, b: Laplacian weights;
// ep, s: the pair's share of e_plus and s.
template <int KIND>
__device__ __forceinline__ void pair_terms(float t, float wa, float wb,
                                           float& a, float& b, float& ep,
                                           float& s) {
  if constexpr (KIND == EE || KIND == SSNE) {
    a = wa;
    b = wb * expf(-t);
    ep = wa * t;
    s = b;
  } else if constexpr (KIND == TSNE) {
    const float K = 1.0f / (1.0f + t);
    a = wa * K;
    b = wb * (K * K);
    ep = wa * log1pf(t);
    s = wb * K;
  } else if constexpr (KIND == TEE) {
    const float K = 1.0f / (1.0f + t);
    a = wa;
    b = wb * (K * K);
    ep = wa * t;
    s = wb * K;
  } else {  // EPAN
    a = wa;
    b = t < 1.0f ? wb : 0.0f;
    ep = wa * t;
    s = wb * fmaxf(1.0f - t, 0.0f);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// VEC consecutive f32 values from shared memory; 16-byte loads when VEC is
// a multiple of 4 (p is then 16-byte aligned by construction).
template <int VEC>
__device__ __forceinline__ void smem_vec(const float* p, float* out) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(p)[q];
      out[4 * q] = v.x; out[4 * q + 1] = v.y;
      out[4 * q + 2] = v.z; out[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) out[v] = p[v];
  }
}

// d == D (1..4).  VEC = Storage<T>::kVec when every row is 16-byte aligned
// (N % kVec == 0), else 1.  A block of blockDim.x / 32 rows; `tile`
// columns staged at a time (a multiple of 32 Storage<T>::kVec).
template <typename T, int KIND, int D, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
pairwise_rows(const T* __restrict__ X, const T* __restrict__ Wa,
              const T* __restrict__ Wb, int n, int tile,
              float* __restrict__ la, float* __restrict__ lb,
              float* __restrict__ ep_part, float* __restrict__ s_part) {
  extern __shared__ __align__(16) float xs[];   // xs[k][c], SoA, D x tile
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  const bool active = row < n;

  float xi[D];
#pragma unroll
  for (int k = 0; k < D; ++k)
    xi[k] = active ? Storage<T>::x(X + (size_t)row * D + k) : 0.0f;
  float sep = 0.f, ss = 0.f;
  float sad[D], sbd[D];                    // sum a (x_n - x_m), sum b (...)
#pragma unroll
  for (int k = 0; k < D; ++k) { sad[k] = 0.f; sbd[k] = 0.f; }
  const T* wa_row = Wa + (size_t)(active ? row : 0) * n;
  const T* wb_row = Wb + (size_t)(active ? row : 0) * n;

  for (int j0 = 0; j0 < n; j0 += tile) {
    const int cols = min(tile, n - j0);
    __syncthreads();                       // previous tile consumed
    for (int e = threadIdx.x; e < cols * D; e += blockDim.x) {
      const int c = e / D;
      xs[(e - c * D) * tile + c] = Storage<T>::x(X + (size_t)j0 * D + e);
    }
    __syncthreads();
    if (!active) continue;
    // cols % VEC == 0 (N and the tile are multiples of VEC), so a chunk
    // is either wholly inside the row or wholly past its end
    for (int c0 = lane * VEC; c0 < cols; c0 += 32 * VEC) {
      float wa[VEC], wb[VEC];
      if constexpr (VEC > 1) {
        Storage<T>::wvec(wa_row + j0 + c0, wa);
        Storage<T>::wvec(wb_row + j0 + c0, wb);
      } else {
        wa[0] = Storage<T>::w(wa_row + j0 + c0);
        wb[0] = Storage<T>::w(wb_row + j0 + c0);
      }
      float xj[D][VEC];
#pragma unroll
      for (int k = 0; k < D; ++k) smem_vec<VEC>(xs + k * tile + c0, xj[k]);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float dx[D];
        float t = 0.f;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          dx[k] = xi[k] - xj[k][v];
          t = fmaf(dx[k], dx[k], t);
        }
        float a, b, ep, s;
        pair_terms<KIND>(t, wa[v], wb[v], a, b, ep, s);
        sep += ep; ss += s;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          sad[k] = fmaf(a, dx[k], sad[k]);
          sbd[k] = fmaf(b, dx[k], sbd[k]);
        }
      }
    }
  }
  if (!active) return;                     // whole warp: row is per warp
  sep = warp_sum(sep); ss = warp_sum(ss);
#pragma unroll
  for (int k = 0; k < D; ++k) { sad[k] = warp_sum(sad[k]); sbd[k] = warp_sum(sbd[k]); }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      la[(size_t)row * D + k] = sad[k];
      lb[(size_t)row * D + k] = sbd[k];
    }
    ep_part[row] = sep;
    s_part[row] = ss;
  }
}

// Any d: t over all d dimensions, accumulators for the four output
// dimensions [4 blockIdx.y, 4 blockIdx.y + 4).  Only blockIdx.y == 0 writes
// the scalar partials.
template <typename T, int KIND>
__global__ void __launch_bounds__(kMaxThreads)
pairwise_rows_any_d(const T* __restrict__ X, const T* __restrict__ Wa,
                    const T* __restrict__ Wb, int n, int d,
                    float* __restrict__ la, float* __restrict__ lb,
                    float* __restrict__ ep_part, float* __restrict__ s_part) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= n) return;                    // no shared memory, no barrier
  const int k0 = blockIdx.y * 4;
  const int nk = min(4, d - k0);
  const T* xrow = X + (size_t)row * d;
  float sep = 0.f, ss = 0.f;
  float sad[4] = {0.f, 0.f, 0.f, 0.f}, sbd[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = lane; j < n; j += 32) {
    const T* xcol = X + (size_t)j * d;
    float t = 0.f;
    for (int k = 0; k < d; ++k) {
      const float dk = Storage<T>::x(xrow + k) - Storage<T>::x(xcol + k);
      t = fmaf(dk, dk, t);
    }
    float a, b, ep, s;
    pair_terms<KIND>(t, Storage<T>::w(Wa + (size_t)row * n + j),
                     Storage<T>::w(Wb + (size_t)row * n + j), a, b, ep, s);
    sep += ep; ss += s;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c < nk) {
        const float dx = Storage<T>::x(xrow + k0 + c) - Storage<T>::x(xcol + k0 + c);
        sad[c] = fmaf(a, dx, sad[c]);
        sbd[c] = fmaf(b, dx, sbd[c]);
      }
    }
  }
  sep = warp_sum(sep); ss = warp_sum(ss);
#pragma unroll
  for (int c = 0; c < 4; ++c) { sad[c] = warp_sum(sad[c]); sbd[c] = warp_sum(sbd[c]); }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c < nk) {
        la[(size_t)row * d + k0 + c] = sad[c];
        lb[(size_t)row * d + k0 + c] = sbd[c];
      }
    }
    if (blockIdx.y == 0) {
      ep_part[row] = sep;
      s_part[row] = ss;
    }
  }
}

// Fixed-order sum of the n row partials: a strided per-thread sum, then a
// shared-memory tree.  One block; deterministic.
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials(const float* __restrict__ ep_part,
                const float* __restrict__ s_part, int n,
                float* __restrict__ out) {
  __shared__ float se[kReduceThreads];
  __shared__ float ssum[kReduceThreads];
  const int tid = threadIdx.x;
  float e = 0.f, s = 0.f;
  for (int i = tid; i < n; i += kReduceThreads) { e += ep_part[i]; s += s_part[i]; }
  se[tid] = e;
  ssum[tid] = s;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (tid < w) { se[tid] += se[tid + w]; ssum[tid] += ssum[tid + w]; }
    __syncthreads();
  }
  if (tid == 0) { out[0] = se[0]; out[1] = ssum[0]; }
}

// The launch shape: `rows` rows a block (one warp each) and, for d <= 4,
// `tile` X columns staged a tile.
struct Shape {
  int rows, tile;
};

template <typename T, int KIND, int D>
void launch_d(const T* X, const T* Wa, const T* Wb, int n, Shape sh,
              float* la, float* lb, float* ep_part, float* s_part,
              cudaStream_t st) {
  const dim3 grid((n + sh.rows - 1) / sh.rows);
  const size_t smem = sizeof(float) * D * sh.tile;
  constexpr int V = Storage<T>::kVec;
  if (n % V == 0)
    pairwise_rows<T, KIND, D, V><<<grid, 32 * sh.rows, smem, st>>>(
        X, Wa, Wb, n, sh.tile, la, lb, ep_part, s_part);
  else
    pairwise_rows<T, KIND, D, 1><<<grid, 32 * sh.rows, smem, st>>>(
        X, Wa, Wb, n, sh.tile, la, lb, ep_part, s_part);
}

template <typename T, int KIND>
void launch_kind(const void* Xv, const void* Wav, const void* Wbv, int n,
                 int d, Shape sh, float* la, float* lb, float* ep_part,
                 float* s_part, cudaStream_t st) {
  const T* X = static_cast<const T*>(Xv);
  const T* Wa = static_cast<const T*>(Wav);
  const T* Wb = static_cast<const T*>(Wbv);
  switch (d) {
    case 1: launch_d<T, KIND, 1>(X, Wa, Wb, n, sh, la, lb, ep_part, s_part, st); break;
    case 2: launch_d<T, KIND, 2>(X, Wa, Wb, n, sh, la, lb, ep_part, s_part, st); break;
    case 3: launch_d<T, KIND, 3>(X, Wa, Wb, n, sh, la, lb, ep_part, s_part, st); break;
    case 4: launch_d<T, KIND, 4>(X, Wa, Wb, n, sh, la, lb, ep_part, s_part, st); break;
    default: {
      const dim3 grid((n + sh.rows - 1) / sh.rows, (d + 3) / 4);
      pairwise_rows_any_d<T, KIND><<<grid, 32 * sh.rows, 0, st>>>(
          X, Wa, Wb, n, d, la, lb, ep_part, s_part);
    }
  }
}

template <typename T>
int launch_storage(const void* X, const void* Wa, const void* Wb, int n,
                   int d, int kind, Shape sh, float* la, float* lb,
                   float* ep_part, float* s_part, cudaStream_t st) {
  // a tile of whole 32-lane strides keeps every lane's columns, and so the
  // sum order, what it is at the default tile
  constexpr int kStride = 32 * Storage<T>::kVec;
  if (sh.rows < 1 || sh.rows > kMaxWarps || sh.tile < kStride ||
      sh.tile % kStride ||
      sizeof(float) * (d < 4 ? d : 4) * static_cast<size_t>(sh.tile) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (kind) {
    case EE:
    case SSNE:   // same pair terms as EE; s is normalised by the caller
      launch_kind<T, EE>(X, Wa, Wb, n, d, sh, la, lb, ep_part, s_part, st); break;
    case TSNE: launch_kind<T, TSNE>(X, Wa, Wb, n, d, sh, la, lb, ep_part, s_part, st); break;
    case TEE: launch_kind<T, TEE>(X, Wa, Wb, n, d, sh, la, lb, ep_part, s_part, st); break;
    case EPAN: launch_kind<T, EPAN>(X, Wa, Wb, n, d, sh, la, lb, ep_part, s_part, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// X (n, d), Wa, Wb (n, n): row-major, contiguous, 16-byte aligned, all in
// the storage type (bf16 != 0: bfloat16, else float32).  la, lb: (n, d)
// float32.  partials: 2 n float32 scratch.  out: 2 float32 (e_plus, s).
// rows: rows a block, 1..16 (0: 8); tile_cols: X columns staged a tile, a
// multiple of 128 in float32 and of 256 in bfloat16 whose min(d, 4) x
// tile_cols floats fit in 48 KB (0: 1024).  Every shape gives the same
// bits.  Enqueues on `stream` and returns the launch status (cudaError_t
// as int; cudaErrorInvalidValue for a shape out of range).
extern "C" int pairwise_terms_launch(const void* X, const void* Wa,
                                     const void* Wb, int n, int d, int kind,
                                     int bf16, int rows, int tile_cols,
                                     void* la, void* lb, void* partials,
                                     void* out, void* stream) {
  if (n < 1 || d < 1 || rows < 0 || tile_cols < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{rows ? rows : kWarps, tile_cols ? tile_cols : kTileCols};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ep_part = static_cast<float*>(partials);
  float* s_part = ep_part + n;
  const int bad =
      bf16 ? launch_storage<uint16_t>(X, Wa, Wb, n, d, kind, sh, static_cast<float*>(la),
                                      static_cast<float*>(lb), ep_part, s_part, st)
           : launch_storage<float>(X, Wa, Wb, n, d, kind, sh, static_cast<float*>(la),
                                   static_cast<float*>(lb), ep_part, s_part, st);
  if (bad) return bad;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<<<1, kReduceThreads, 0, st>>>(ep_part, s_part, n,
                                                static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
