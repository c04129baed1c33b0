// Directed ELL Laplacian gather for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernels of `repro/kernels/sparse_attractive.py`:
//   * layout 0, "vmem": `ell_lap_matvec_pallas` (body `_ell_kernel`), where
//     X is resident in VMEM and neighbour rows are gathered from it;
//   * layout 1, "hbm": `ell_lap_matvec_pallas_hbm` (body `_ell_hbm_kernel`),
//     where X stays in HBM and each chunk's neighbour rows are DMA'd into a
//     double-buffered VMEM scratch;
//   * the local-rows kernel `ell_gather_local`: `ell_lap_matvec_local_pallas`
//     (body `_ell_local_kernel`, which is `_ell_kernel` behind a
//     scalar-prefetched row offset), the row-sharded backend's product over
//     one rank's rows against a replicated X.
// Same contract as the plain PyTorch versions
// `repro_torch/kernels/ref.py::ell_lap_matvec_ref` and
// `ell_lap_matvec_local_ref`: for X (n_x, d), an ELL graph idx (n_rows, k)
// int32 with global column ids and weights w (n_rows, k),
//
//     out_r = (sum_j w_rj) x_{row0 + r} - sum_j w_rj x_{idx[r, j]}
//
// for the local rows r < n_rows.  The single-device entry point
// (`ell_lap_matvec_launch`) runs row0 = 0 and n_rows = n_x; the local-rows
// entry point (`ell_lap_matvec_local_launch`) takes any row0 with
// row0 + n_rows <= n_x.  The TPU kernel needs row0 to be a multiple of its
// row tile, because the offset moves a BlockSpec by whole blocks; here a
// group of lanes reads its own row x_{row0 + r}, so any row0 works.  X and w
// are float32 or bfloat16 (widened to f32 after the gather); sums and the
// output are float32.
//
// Bound on an H100 SXM (3.35 TB/s; ~3 flops a slot a dimension): memory,
// in two places.
//   * DRAM bytes.  The least traffic is the graph streamed once, N k
//     (4 + s_w) bytes, plus X read once and the output written once,
//     N d (s_x + 4) bytes; X itself stays in the 50 MB L2 at the sizes the
//     sparse backend runs (N = 70000, d = 2 is 0.56 MB).  At N = 70000,
//     k = 90 in f32 that is 51.5 MB, ~15 us a call; the local-rows kernel
//     over half the rows streams half the graph, ~26 MB, ~7.8 us.
//   * The gathers.  Each slot gathers a row x_m of X at a random m (the
//     neighbours of a row share few lines with those of the next), so a
//     warp's gather touches up to 32 distinct 128-byte lines, and every one
//     that misses L1 moves a 32-byte L2 sector: N k gathers, N k 32 bytes of
//     L2-to-SM traffic (6.3 M and 202 MB at N = 70000, k = 90), and L1 time
//     in proportion to the lines a load instruction touches.  Padding slots
//     (self, w = 0) of one row hit one line.
// The design follows:
//
//   * "vmem" and the local-rows kernel (direct gather, `gather_rows`).  A
//     group of S lanes owns one row: a whole warp for k > 16, else 32 / S
//     rows a warp so that short rows keep the lanes busy.  Lane l takes
//     slots l, l + S, ... and holds P = ceil(k / S) of them a pass (a
//     template bucket: 1, 2, 4 or 8; rows wider than 256 slots take passes
//     of 8).  It loads all of a pass's indices and weights first, in
//     coalesced evict-first loads, then issues all its gathers, then adds:
//     no gather waits on an index load behind another gather, so each lane
//     has P index pairs, then P gathers, in flight.  A gathered row of width
//     2 or 4 is one vector load through the read-only path (a float2 or
//     float4 in f32, a 4- or 8-byte word in bf16), one load instruction a
//     gather at the paper's d = 2 where there were two.  The group reduces
//     the degree and D sums with a fixed butterfly of shuffles and one lane
//     writes the row.  Both kernels run the one body, as the TPU's local
//     kernel runs `_ell_kernel`; they are separate kernels so that a
//     profile tells the sharded backend's launches from the single-device
//     ones.  On an H100 80GB HBM3 at 700 W, f32, N = 70000, the vector load
//     alone (a loop of one slot a step) takes the forward graph (k = 90)
//     from 57.0 to 55.3 us and the reverse (k = 229) not at all (82.5 us);
//     the buckets take them on to 53.5 and 67.1 us.  Registers (ptxas -v,
//     -O3, sm_90a; the build log beside the library): at the main path's
//     d = 2 in f32, 46 for P = 4 (k = 90, 40 warps an SM) and 64 for P = 8
//     (k = 229, 32 warps); 20-64 over the 140 instantiations, none
//     spilling.  __launch_bounds__ caps them at 64, so that at least 32
//     warps an SM stay resident; a lower cap spills at P = 8, and gathering
//     P = 8 in two register passes of 4 was slower on the card.  What is
//     left is the gathers that miss L1 and wait on L2 (its latency or its
//     sector traffic; the card's counters cannot be read to tell which):
//     the forward graph takes ~53 us in f32, and ~24 us when every gather
//     hits L1 (indices folded into 1024 rows) or the row's own line,
//     against its 15.4 us byte bound.  Staging X in the distributed shared
//     memory of a cluster of 2-8 blocks, gathered with ld.shared::cluster,
//     was slower still.
//   * "hbm" (staged gather).  A block walks its rows in chunks of one row a
//     group.  The chunk's indices, then its k neighbour rows a row, are
//     copied into a double-buffered shared-memory ring with cp.async: while
//     chunk c is reduced from shared memory, chunk c + 1's rows and chunk
//     c + 2's indices are in flight, which is what the TPU kernel's DMA
//     double buffer does.  On Hopper X never has to leave device memory for
//     capacity, so this layout pays only if the asynchronous copies hide
//     the gather latency better than the direct loads do; it is kept, checked
//     and timed beside "vmem".  cp.async moves 4-byte words: one element in
//     float32, a pair in bfloat16 when d is even.  bfloat16 rows of odd d
//     are not word-aligned and are staged with plain loads (no overlap).
//
// Shared rules:
//   * The direct gather takes d <= 4 as a template parameter (the paper
//     embeds in d = 2), so nothing is padded to 128 lanes as on the TPU and
//     no component is guarded; larger d runs four output dimensions a block
//     along gridDim.y.  "hbm" takes D = min(d, 4) and guards each column.
//   * The row is formed as the TPU kernel forms it, deg * x_n - acc, so the
//     kernel and the plain version round alike.  A padding slot (self
//     index, w = 0) adds exactly 0 to both sums; duplicate columns sum.
//   * No float atomics: every row is summed by one group in a fixed order
//     (slot j on lane j mod S in increasing j, then the butterfly; the
//     bucket P does not change it), so reruns are bit-identical.
//   * Indices must lie in [0, n_x); the kernels do not check them (the
//     local-rows wrapper checks each index array once).
//
// Built by `repro_torch/kernels/_build.py` with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (`ell_lap_matvec_launch`,
// `ell_lap_matvec_local_launch`; plain C interface).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // "vmem": 8 warps a block
constexpr int kMinBlocks = 4;          // so <= 64 registers a thread
constexpr int kHbmThreads = 128;       // "hbm": 4 warps a block
constexpr int kHbmChunks = 8;          // chunks a block walks
constexpr int kMaxSmem = 232448;       // dynamic shared memory a block may use

// bf16 is carried as its raw 16 bits; widening to f32 is exact.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Sum (deg, acc[0..D)) over the S lanes of a group, in a fixed order.
template <int D, int S>
__device__ __forceinline__ void group_reduce(float& deg, float (&acc)[D]) {
#pragma unroll
  for (int off = S / 2; off > 0; off >>= 1) {
    deg += __shfl_xor_sync(0xffffffffu, deg, off);
#pragma unroll
    for (int c = 0; c < D; ++c)
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
  }
}

template <typename T, int D>
__device__ __forceinline__ void write_row(const T* __restrict__ X, int d,
                                          int c0, int xrow, int r, float deg,
                                          const float (&acc)[D],
                                          float* __restrict__ out) {
  const T* xn = X + static_cast<size_t>(xrow) * d + c0;
  float* o = out + static_cast<size_t>(r) * d + c0;
#pragma unroll
  for (int c = 0; c < D; ++c)
    if (c0 + c < d) o[c] = deg * widen(__ldg(xn + c)) - acc[c];
}

// One gathered row x_m (D columns from c0) into v, widened to f32.  kSplit:
// d > 4, so D = 4 columns from c0 = 4 blockIdx.y, scalar loads behind a
// guard (v is 0 past d).  Otherwise D is d, c0 is 0, and a row of width 2
// or 4 is one vector load: a float2 or float4 in f32, a 4- or 8-byte word
// of bf16 pairs (row m of a 16-byte aligned X is aligned to its width).
template <typename T, int D, bool kSplit>
__device__ __forceinline__ void load_row(const T* __restrict__ X, int m,
                                         int d, int c0, float (&v)[D]) {
  if constexpr (kSplit) {
    const T* xm = X + static_cast<size_t>(m) * d + c0;
#pragma unroll
    for (int c = 0; c < D; ++c) v[c] = c0 + c < d ? widen(__ldg(xm + c)) : 0.f;
  } else if constexpr (sizeof(T) == 4 && D == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(X) + m);
    v[0] = a.x;
    v[1] = a.y;
  } else if constexpr (sizeof(T) == 4 && D == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(X) + m);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else if constexpr (sizeof(T) == 2 && D == 2) {
    const unsigned a = __ldg(reinterpret_cast<const unsigned*>(X) + m);
    v[0] = __uint_as_float(a << 16);
    v[1] = __uint_as_float(a & 0xffff0000u);
  } else if constexpr (sizeof(T) == 2 && D == 4) {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(X) + m);
    v[0] = __uint_as_float(a.x << 16);
    v[1] = __uint_as_float(a.x & 0xffff0000u);
    v[2] = __uint_as_float(a.y << 16);
    v[3] = __uint_as_float(a.y & 0xffff0000u);
  } else {
    const T* xm = X + static_cast<size_t>(m) * D;
#pragma unroll
    for (int c = 0; c < D; ++c) v[c] = widen(__ldg(xm + c));
  }
}

// The direct gather, one group of S lanes a row: the body of "vmem" and of
// the local-rows kernel.  Lane l holds slots j = l + p S, p < P, of each
// pass of S P slots (one pass unless k > 256): it loads all their indices
// and weights, then issues their gathers, G at a time (G D <= 16 values in
// registers), then adds them in increasing j.
template <typename T, int D, bool kSplit, int S, int P>
__device__ __forceinline__ void gather_rows(const T* __restrict__ X,
                                            const int* __restrict__ idx,
                                            const T* __restrict__ w, int d,
                                            int k, int row0, int n_rows,
                                            float* __restrict__ out) {
  constexpr int G = P * D <= 16 ? P : 4;
  const int lane = threadIdx.x % S;
  const int r = (blockIdx.x * kThreads + threadIdx.x) / S;
  const int c0 = kSplit ? blockIdx.y * D : 0;
  const bool live = r < n_rows;   // dead lanes still join the shuffles
  float deg = 0.f;
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  if (live) {
    const int* ir = idx + static_cast<size_t>(r) * k;
    const T* wr = w + static_cast<size_t>(r) * k;
#pragma unroll 1
    for (int j0 = lane; j0 < k; j0 += S * P) {
      int m[P];
      T wv[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int j = j0 + p * S;
        m[p] = j < k ? __ldcs(ir + j) : 0;
        wv[p] = j < k ? __ldcs(wr + j) : T(0);
      }
#pragma unroll
      for (int g = 0; g < P; g += G) {
        float xv[G][D];
#pragma unroll
        for (int q = 0; q < G; ++q)
          if (j0 + (g + q) * S < k)
            load_row<T, D, kSplit>(X, m[g + q], d, c0, xv[q]);
#pragma unroll
        for (int q = 0; q < G; ++q) {
          if (j0 + (g + q) * S < k) {
            const float wj = widen(wv[g + q]);
            deg += wj;
#pragma unroll
            for (int c = 0; c < D; ++c) acc[c] += wj * xv[q][c];
          }
        }
      }
    }
  }
  group_reduce<D, S>(deg, acc);
  if (live && lane == 0) write_row<T, D>(X, d, c0, row0 + r, r, deg, acc, out);
}

// "vmem": every row of the graph (row0 = 0).
template <typename T, int D, bool kSplit, int S, int P>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ell_gather(const T* __restrict__ X, const int* __restrict__ idx,
           const T* __restrict__ w, int d, int k, int n_rows,
           float* __restrict__ out) {
  gather_rows<T, D, kSplit, S, P>(X, idx, w, d, k, 0, n_rows, out);
}

// The local-rows kernel: rows [row0, row0 + n_rows) of X's graph.
template <typename T, int D, bool kSplit, int S, int P>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ell_gather_local(const T* __restrict__ X, const int* __restrict__ idx,
                 const T* __restrict__ w, int d, int k, int row0, int n_rows,
                 float* __restrict__ out) {
  gather_rows<T, D, kSplit, S, P>(X, idx, w, d, k, row0, n_rows, out);
}

// "hbm": staged gather through a double-buffered shared-memory ring.
// Shared memory: sidx[2][CH k] int32, then sx[2][CH k D] in the storage type.
template <typename T, int D, int S>
__global__ void __launch_bounds__(kHbmThreads)
ell_gather_staged(const T* __restrict__ X, const int* __restrict__ idx,
                  const T* __restrict__ w, int d, int k, int row0, int n_rows,
                  float* __restrict__ out) {
  constexpr int CH = kHbmThreads / S;            // rows a chunk, one a group
  extern __shared__ __align__(16) unsigned char smem[];
  int* sidx = reinterpret_cast<int*>(smem);
  T* sx = reinterpret_cast<T*>(sidx + 2 * CH * k);
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * D;
  const int first = blockIdx.x * CH * kHbmChunks;
  const int n_chunks = min(kHbmChunks, (n_rows - first + CH - 1) / CH);
  // the rows of chunk c that exist
  auto rows_of = [&](int c) { return min(CH, n_rows - first - c * CH); };

  auto stage_idx = [&](int c) {
    const int n = rows_of(c) * k;
    const int* src = idx + static_cast<size_t>(first + c * CH) * k;
    int* dst = sidx + (c & 1) * CH * k;
    for (int e = tid; e < n; e += kHbmThreads) cp_async4(dst + e, src + e);
  };
  auto stage_x = [&](int c) {
    const int n = rows_of(c) * k;
    const int* si = sidx + (c & 1) * CH * k;
    T* dst = sx + (c & 1) * CH * k * D;
    for (int s = tid; s < n; s += kHbmThreads) {
      const T* src = X + static_cast<size_t>(si[s]) * d + c0;
      T* row = dst + s * D;
      if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int c = 0; c < D; ++c)
          if (c0 + c < d) cp_async4(row + c, src + c);
      } else {
        // bf16 pairs are word-aligned when d (hence D) is even; odd d takes
        // plain loads
        bool pairs = false;
        if constexpr (D % 2 == 0) pairs = (d & 1) == 0;
        if (pairs) {
#pragma unroll
          for (int c = 0; c < D; c += 2)
            if (c0 + c < d) cp_async4(row + c, src + c);
        } else {
#pragma unroll
          for (int c = 0; c < D; ++c)
            if (c0 + c < d) row[c] = __ldg(src + c);
        }
      }
    }
  };

  if (n_chunks <= 0) return;
  stage_idx(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  stage_x(0);
  if (n_chunks > 1) stage_idx(1);
  cp_async_commit();

  const int g = tid / S;
  const int lane = tid % S;
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_all();   // chunk c's rows and chunk c + 1's indices
    __syncthreads();
    if (c + 1 < n_chunks) {
      stage_x(c + 1);
      if (c + 2 < n_chunks) stage_idx(c + 2);   // into chunk c's idx slot
      cp_async_commit();
    }
    const int r = first + c * CH + g;
    const bool live = g < rows_of(c);
    float deg = 0.f;
    float acc[D];
#pragma unroll
    for (int cc = 0; cc < D; ++cc) acc[cc] = 0.f;
    if (live) {
      const T* wr = w + static_cast<size_t>(r) * k;
      const T* xs = sx + (c & 1) * CH * k * D + g * k * D;
      for (int j = lane; j < k; j += S) {
        const float wj = widen(__ldcs(wr + j));
        deg += wj;
#pragma unroll
        for (int cc = 0; cc < D; ++cc)
          if (c0 + cc < d) acc[cc] += wj * widen(xs[j * D + cc]);
      }
    }
    group_reduce<D, S>(deg, acc);
    if (live && lane == 0)
      write_row<T, D>(X, d, c0, row0 + r, r, deg, acc, out);
    __syncthreads();       // chunk c's slot is free for chunk c + 2
  }
}

// layout: 0 "vmem", 1 "hbm", kLocal the local-rows kernel.
constexpr int kLocal = 2;

template <typename T, int D, bool kSplit, int S, int P>
int launch_direct(int layout, const T* X, const int* idx, const T* w, int d,
                  int k, int row0, int n_rows, float* out, cudaStream_t st) {
  const dim3 grid(
      static_cast<unsigned>((static_cast<long long>(n_rows) * S + kThreads - 1)
                            / kThreads),
      kSplit ? (d + D - 1) / D : 1);
  if (layout == 0)
    ell_gather<T, D, kSplit, S, P><<<grid, kThreads, 0, st>>>(X, idx, w, d, k,
                                                              n_rows, out);
  else
    ell_gather_local<T, D, kSplit, S, P><<<grid, kThreads, 0, st>>>(
        X, idx, w, d, k, row0, n_rows, out);
  return static_cast<int>(cudaGetLastError());
}

// S, the lanes a row: a power of two >= k up to a warp, at least 4 (the
// sum order of a row follows S, not P).  P, a lane's slots a pass:
// ceil(k / S) rounded up to 1, 2, 4 or 8; wider rows take passes of 8.
template <typename T, int D, bool kSplit>
int launch_direct_k(int layout, const T* X, const int* idx, const T* w,
                    int d, int k, int row0, int n_rows, float* out,
                    cudaStream_t st) {
#define ELL_DIRECT(S, P) \
  launch_direct<T, D, kSplit, S, P>(layout, X, idx, w, d, k, row0, n_rows, \
                                    out, st)
  if (k <= 4) return ELL_DIRECT(4, 1);
  if (k <= 8) return ELL_DIRECT(8, 1);
  if (k <= 16) return ELL_DIRECT(16, 1);
  if (k <= 32) return ELL_DIRECT(32, 1);
  if (k <= 64) return ELL_DIRECT(32, 2);
  if (k <= 128) return ELL_DIRECT(32, 4);
  return ELL_DIRECT(32, 8);
#undef ELL_DIRECT
}

template <typename T, int D, int S>
int launch_staged(const T* X, const int* idx, const T* w, int d, int k,
                  int row0, int n_rows, float* out, cudaStream_t st) {
  constexpr int CH = kHbmThreads / S;
  const size_t bytes = 2ull * CH * k * (sizeof(int) + D * sizeof(T));
  if (bytes > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ell_gather_staged<T, D, S>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n_rows + CH * kHbmChunks - 1) / (CH * kHbmChunks),
                  (d + D - 1) / D);
  ell_gather_staged<T, D, S><<<grid, kHbmThreads, bytes, st>>>(
      X, idx, w, d, k, row0, n_rows, out);
  return static_cast<int>(cudaGetLastError());
}

// "hbm": S a power of two >= k up to a warp, at least 4.
template <typename T, int D>
int launch_staged_k(const T* X, const int* idx, const T* w, int d, int k,
                    int row0, int n_rows, float* out, cudaStream_t st) {
  if (k <= 4) return launch_staged<T, D, 4>(X, idx, w, d, k, row0, n_rows, out, st);
  if (k <= 8) return launch_staged<T, D, 8>(X, idx, w, d, k, row0, n_rows, out, st);
  if (k <= 16) return launch_staged<T, D, 16>(X, idx, w, d, k, row0, n_rows, out, st);
  return launch_staged<T, D, 32>(X, idx, w, d, k, row0, n_rows, out, st);
}

template <typename T>
int launch_d(int layout, const void* Xv, const int* idx, const void* wv, int d,
             int k, int row0, int n_rows, float* out, cudaStream_t st) {
  const T* X = static_cast<const T*>(Xv);
  const T* w = static_cast<const T*>(wv);
  if (layout == 1) {
    switch (d) {
      case 1: return launch_staged_k<T, 1>(X, idx, w, d, k, row0, n_rows, out, st);
      case 2: return launch_staged_k<T, 2>(X, idx, w, d, k, row0, n_rows, out, st);
      case 3: return launch_staged_k<T, 3>(X, idx, w, d, k, row0, n_rows, out, st);
      default: return launch_staged_k<T, 4>(X, idx, w, d, k, row0, n_rows, out, st);
    }
  }
  switch (d) {
    case 1: return launch_direct_k<T, 1, false>(layout, X, idx, w, d, k, row0, n_rows, out, st);
    case 2: return launch_direct_k<T, 2, false>(layout, X, idx, w, d, k, row0, n_rows, out, st);
    case 3: return launch_direct_k<T, 3, false>(layout, X, idx, w, d, k, row0, n_rows, out, st);
    case 4: return launch_direct_k<T, 4, false>(layout, X, idx, w, d, k, row0, n_rows, out, st);
    default: return launch_direct_k<T, 4, true>(layout, X, idx, w, d, k, row0, n_rows, out, st);
  }
}

int launch_any(int layout, const void* X, const void* idx, const void* w,
               int n_x, int d, int k, int row0, int n_rows, int bf16,
               void* out, void* stream) {
  if (n_x < 1 || d < 1 || k < 1 || row0 < 0 || n_rows < 0 ||
      row0 > n_x - n_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  return bf16 ? launch_d<uint16_t>(layout, X, ip, w, d, k, row0, n_rows, o, st)
              : launch_d<float>(layout, X, ip, w, d, k, row0, n_rows, o, st);
}

}  // namespace

// X (n, d), idx (n, k) int32, w (n, k): row-major, contiguous, X and w in
// the storage type (bf16 != 0: bfloat16, else float32), all 16-byte
// aligned.  out: (n, d) float32.  layout: 0 "vmem" (direct gather), 1 "hbm"
// (staged).  Enqueues on `stream` and returns the launch status
// (cudaError_t as int).
extern "C" int ell_lap_matvec_launch(const void* X, const void* idx,
                                     const void* w, int n, int d, int k,
                                     int bf16, int layout, void* out,
                                     void* stream) {
  if (layout != 0 && layout != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_any(layout, X, idx, w, n, d, k, 0, n, bf16, out, stream);
}

// The local-rows kernel: X (n_x, d) replicated, idx (n_rows, k) int32 with
// global ids in [0, n_x) and w (n_rows, k) one rank's rows of the graph,
// whose row r is row row0 + r of X (0 <= row0 <= n_x - n_rows).  out:
// (n_rows, d) float32.  Otherwise as `ell_lap_matvec_launch`.
extern "C" int ell_lap_matvec_local_launch(const void* X, const void* idx,
                                           const void* w, int n_x, int d,
                                           int k, int row0, int n_rows,
                                           int bf16, void* out, void* stream) {
  return launch_any(kLocal, X, idx, w, n_x, d, k, row0, n_rows, bf16, out,
                    stream);
}
