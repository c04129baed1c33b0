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
//   * "hbm" (staged gather, `ell_gather_staged`).  Hopper's way to keep
//     many gathers in flight without spending registers on them: a lane
//     copies its slots' rows into shared memory with cp.async and adds them
//     later.  A warp walks a span of 8 row groups (8 rows at k > 16) as
//     rounds of one slot a lane, the slots the direct gather gives its
//     lanes.  Each lane runs its own ring of NS = 3 stages of B = 2 rounds:
//     a stage's rows are copied NS - 1 stages before they are added, and
//     its indices and weights are loaded into registers (coalesced,
//     evict-first) two stages before that; cp.async.wait_group NS - 1 is the
//     only synchronization, since the lane that copies a cell is the lane
//     that reads it.  A row is one cp.async of its width (8 bytes in f32 at
//     d = 2, 4 in bf16), and a slot of the row's own index copies nothing
//     (its x_n is the row's own, loaded once a row), so the reverse graph
//     copies its 6.3 M live rows, not its 16.0 M slots.  bf16 rows of odd d
//     are not 4-byte aligned and are loaded plainly when they are added.
//     The rings hold a fixed number of slots a lane whatever k is, so any
//     row width runs.  The slots are added by `add_slot` in the direct
//     gather's order and reduced by the same butterfly, so the two layouts
//     give the same bits.  The kernel asks for a 15% shared-memory carveout
//     (9216 bytes a block at d = 2 in f32, 4608 in bf16), leaving L1 its
//     room for X.  On an H100 80GB HBM3 at 700 W, N = 70000, d = 2
//     (`ell_ab.py` at the repo's root, mean of two turns): 61.0 / 79.6 us
//     on the forward (k = 90) / reverse (k = 229) graph in f32 and
//     54.8 / 77.2 us in bf16, against the direct gather's 53.4 / 67.3 and
//     40.8 / 53.8 us, so "vmem" stays the default.  L1 holds it back: the
//     rings take shared memory from the L1 that caches X, and the larger
//     first ring (4 stages of 4 rounds, one index stage ahead, one wave of
//     warps, no carveout) took 77.4 / 104.9 us; the runtime's own carveout
//     costs 2.2 us forward, 4 rounds a stage 5.6 us; indices one stage
//     ahead cost 3.8 us on the reverse graph; copying the self slots too
//     takes the reverse graph to 97.8 us.
//     ptxas -v: 55 registers at d = 2 in f32 for k > 16, 54 in bf16; 43-70
//     over the 40 instantiations; four (f32, d = 3 at S = 8, 16 and 32,
//     d = 4 at S = 8) spill 4-8 bytes; no static shared memory (the rings
//     are dynamic: 9216 bytes a block at d = 2 in f32, 4608 in bf16).
//
// The launch shape is a runtime choice (`kernels/autotune.py` searches
// it), and every shape gives the same bits:
//   * "vmem" and local: rows a block (threads a block / S, 32 to 512
//     threads; default 256) and P, a lane's slots a pass (default the
//     bucket that k gives).  A row's sum order follows S, which stays what
//     k gives; P only cuts the row into passes.  Only S = 32 has more than
//     one P: at k <= 16 (S < 32) a lane holds one slot whatever P, so no
//     other P is instantiated there.  __launch_bounds__(512, 2) keeps the
//     64-register cap of (256, 4) at every block size.
//   * "hbm": rows a block (warps a block x span x rows a warp-group, 1 to 8
//     warps; default 4) and the span (row groups a warp walks; default 8).
//     Slots are added in the direct gather's order whatever the span.
//
// Shared rules:
//   * The direct gather takes d <= 4 as a template parameter (the paper
//     embeds in d = 2), so nothing is padded to 128 lanes as on the TPU and
//     no component is guarded; larger d runs four output dimensions a block
//     along gridDim.y.  "hbm" takes d the same way.
//   * The row is formed as the TPU kernel forms it, deg * x_n - acc, so the
//     kernel and the plain version round alike.  A padding slot (self
//     index, w = 0) adds exactly 0 to both sums; duplicate columns sum.
//   * No float atomics: every row is summed by one group in a fixed order
//     (slot j on lane j mod S in increasing j, then the butterfly; neither
//     the bucket P nor the staging changes it), so reruns are bit-identical
//     and both layouts give the same bits.
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

constexpr int kThreads = 256;          // "vmem": default threads a block
constexpr int kMaxThreads = 512;       // "vmem": most threads a block ...
constexpr int kMinBlocks = 2;          // ... and so <= 64 registers a thread
constexpr int kMaxSmem = 232448;       // dynamic shared memory a block may use

// "hbm".  The ring's shape and the carveout, fixed by measurement on an
// H100 (the header above); warps a block and the span are the launch shape.
constexpr int kStagedWarps = 4;        // default warps a block, a ring each
constexpr int kMaxStagedWarps = 8;
constexpr int kStages = 3;             // stages in a lane's ring
constexpr int kRounds = 2;             // rounds (one slot a lane) in a stage
constexpr int kAhead = 2;              // stages of indices and weights ahead
constexpr int kSpan = 8;               // default row groups a warp walks
constexpr int kCarveout = 15;          // percent of L1 asked for shared memory
static_assert(kStages >= 2 && kRounds >= 1 && kStages * kRounds <= 32,
              "a lane's ring keeps a bit a round in one word");

// bf16 is carried as its raw 16 bits; widening to f32 is exact.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// cp.async of N bytes (4, 8 or 16), through L1; of the N bytes only
// src_bytes are read and the rest are zero-filled.
template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int src_bytes = N) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(gmem), "n"(N), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// One slot's update of a lane's sums.  Both gathers call it, so that the
// compiler contracts it into the same FMA in each and they round alike.
template <int D>
__device__ __forceinline__ void add_slot(float& deg, float (&acc)[D],
                                         float wj, const float (&v)[D]) {
  deg += wj;
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] += wj * v[c];
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
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) / S;
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
          if (j0 + (g + q) * S < k)
            add_slot<D>(deg, acc, widen(wv[g + q]), xv[q]);
        }
      }
    }
  }
  group_reduce<D, S>(deg, acc);
  if (live && lane == 0) write_row<T, D>(X, d, c0, row0 + r, r, deg, acc, out);
}

// "vmem": every row of the graph (row0 = 0).
template <typename T, int D, bool kSplit, int S, int P>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
ell_gather(const T* __restrict__ X, const int* __restrict__ idx,
           const T* __restrict__ w, int d, int k, int n_rows,
           float* __restrict__ out) {
  gather_rows<T, D, kSplit, S, P>(X, idx, w, d, k, 0, n_rows, out);
}

// The local-rows kernel: rows [row0, row0 + n_rows) of X's graph.
template <typename T, int D, bool kSplit, int S, int P>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
ell_gather_local(const T* __restrict__ X, const int* __restrict__ idx,
                 const T* __restrict__ w, int d, int k, int row0, int n_rows,
                 float* __restrict__ out) {
  gather_rows<T, D, kSplit, S, P>(X, idx, w, d, k, row0, n_rows, out);
}

// A staged cell: the gathered row's D values in the storage type, or the
// row's index where rows are loaded plainly (bf16 at odd d: a row there is
// not 4-byte aligned, the least cp.async moves).
template <typename T, int D, bool kSplit>
constexpr bool kMayCopy = sizeof(T) == 4 || kSplit || D % 2 == 0;
template <typename T, int D, bool kSplit>
constexpr int kCellBytes =
    !kMayCopy<T, D, kSplit> || D * sizeof(T) < 4 ? 4 : D * sizeof(T);

// Copy row x_m (D columns from c0) into `cell`: one cp.async of the row's
// width (4, 8 or 16 bytes) where the row is that wide, else one a column
// (f32 at d = 3 or d > 4) or a column pair (bf16 at even d > 4), columns
// past d zero-filled, not read.
template <typename T, int D, bool kSplit>
__device__ __forceinline__ void copy_row(unsigned char* cell,
                                         const T* __restrict__ X, int m,
                                         int d, int c0) {
  if constexpr (kSplit) {
    constexpr int E = 4 / sizeof(T);     // elements a 4-byte copy moves
    const T* src = X + static_cast<size_t>(m) * d + c0;
#pragma unroll
    for (int c = 0; c < D; c += E) {
      const bool in = c0 + c < d;
      cp_async<4>(cell + c * sizeof(T), in ? src + c : X, in ? 4 : 0);
    }
  } else if constexpr (D * sizeof(T) == 12) {
    const T* src = X + static_cast<size_t>(m) * D;
#pragma unroll
    for (int c = 0; c < D; ++c) cp_async<4>(cell + 4 * c, src + c);
  } else if constexpr (kMayCopy<T, D, kSplit>) {
    cp_async<D * sizeof(T)>(cell, X + static_cast<size_t>(m) * D);
  }
}

// A staged row, widened to f32 as `load_row` widens it.
template <typename T, int D>
__device__ __forceinline__ void read_cell(const unsigned char* cell,
                                          float (&v)[D]) {
  if constexpr (sizeof(T) == 4 && D == 2) {
    const float2 a = *reinterpret_cast<const float2*>(cell);
    v[0] = a.x;
    v[1] = a.y;
  } else if constexpr (sizeof(T) == 4 && D == 4) {
    const float4 a = *reinterpret_cast<const float4*>(cell);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else if constexpr (sizeof(T) == 2 && D == 2) {
    const unsigned a = *reinterpret_cast<const unsigned*>(cell);
    v[0] = __uint_as_float(a << 16);
    v[1] = __uint_as_float(a & 0xffff0000u);
  } else if constexpr (sizeof(T) == 2 && D == 4) {
    const uint2 a = *reinterpret_cast<const uint2*>(cell);
    v[0] = __uint_as_float(a.x << 16);
    v[1] = __uint_as_float(a.x & 0xffff0000u);
    v[2] = __uint_as_float(a.y << 16);
    v[3] = __uint_as_float(a.y & 0xffff0000u);
  } else {
    const T* e = reinterpret_cast<const T*>(cell);
#pragma unroll
    for (int c = 0; c < D; ++c) v[c] = widen(e[c]);
  }
}

// A position in a warp's stream of rounds: row group rg, round jr of its row.
struct Round {
  int rg = 0, jr = 0;
  __device__ __forceinline__ void next(int R) {
    if (++jr == R) {
      jr = 0;
      ++rg;
    }
  }
};

// "hbm": the staged gather.  A warp walks a span of rows as a stream of
// rounds.  In a round each lane holds one slot: slot j = jr S + l % S of row
// r_begin + rg G + l / S (G = 32 / S groups a warp, R = ceil(k / S) rounds a
// row), the slot the direct gather gives lane l % S of that row's group.  B
// rounds make a stage, and each lane runs a ring of NS stages in shared
// memory: its own cells, one a round, each holding the gathered row (or, for
// rows loaded plainly, the row's index) and the slot's weight.  Iteration s
// issues stage s + NS - 1 (the copies of the rows whose indices were loaded
// L = kAhead iterations before), loads the indices and weights of stage
// s + NS - 1 + L into the registers that freed, waits until stage s has
// landed (cp.async.wait_group NS - 1) and adds it.  The lane that copies a
// cell is the lane that reads it, so the ring needs no barrier.  A block of
// blockDim.x / 32 warps; each walks `span_groups` row groups.
template <typename T, int D, bool kSplit, int S>
__global__ void __launch_bounds__(kMaxStagedWarps * 32)
ell_gather_staged(const T* __restrict__ X, const int* __restrict__ idx,
                  const T* __restrict__ w, int d, int k, int row0, int n_rows,
                  int span_groups, float* __restrict__ out) {
  constexpr int G = 32 / S, B = kRounds, NS = kStages;
  constexpr int CB = kCellBytes<T, D, kSplit>;
  constexpr int kRing = NS * B * 32;           // cells of a warp's ring
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32, grp = lane / S, sl = lane % S;
  const int warp = threadIdx.x / 32;
  const int span = span_groups * G;
  const long long first =
      (static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + warp) *
      span;
  if (first >= n_rows) return;                 // the whole warp leaves
  const int r_begin = static_cast<int>(first);
  const int r_end = static_cast<int>(min(static_cast<long long>(n_rows),
                                         first + span));
  const int R = (k + S - 1) / S;
  const int n_rounds = (r_end - r_begin + G - 1) / G * R;
  const int n_stages = (n_rounds + B - 1) / B;
  const int c0 = kSplit ? blockIdx.y * D : 0;
  const bool copies = kMayCopy<T, D, kSplit> && (sizeof(T) == 4 || d % 2 == 0);
  unsigned char* xs = smem + warp * kRing * (CB + sizeof(T));
  T* ws = reinterpret_cast<T*>(xs + kRing * CB);

  constexpr int L = kAhead;
  int m[L][B];              // the next L stages' indices (-1: no slot) ...
  T wv[L][B];               // ... and weights; stage t in set t % L
  Round ld, is, cs;         // where the loads, the copies and the adds are
  auto load = [&](int (&mm)[B], T (&ww)[B]) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int r = r_begin + ld.rg * G + grp;
      const int j = ld.jr * S + sl;
      const bool live = r < r_end && j < k;
      const size_t at = static_cast<size_t>(r) * k + j;
      mm[b] = live ? __ldcs(idx + at) : -1;
      ww[b] = live ? __ldcs(w + at) : T(0);
      ld.next(R);
    }
  };
  unsigned self = 0;        // a bit a round in the ring: the row's own slot
  auto issue = [&](int slot, int pos, const int (&mm)[B],
                   const T (&ww)[B]) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int r = r_begin + is.rg * G + grp;
      const int cell = (slot * B + b) * 32 + lane;
      unsigned char* xc = xs + cell * CB;
      ws[cell] = ww[b];
      if (!copies)
        *reinterpret_cast<int*>(xc) = mm[b];
      else if (mm[b] == row0 + r)
        self |= 1u << (pos + b);
      else if (mm[b] >= 0)
        copy_row<T, D, kSplit>(xc, X, mm[b], d, c0);
      is.next(R);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int u = 0; u < L; ++u) load(m[u], wv[u]);
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    issue(t, t * B, m[t % L], wv[t % L]);
    load(m[t % L], wv[t % L]);
  }
  float deg = 0.f;
  float acc[D], xn[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = xn[c] = 0.f;
  int xn_row = -1;          // the row whose x_n is in xn
#pragma unroll 1
  for (int s0 = 0; s0 < n_stages; s0 += L) {
#pragma unroll
    for (int u = 0; u < L; ++u) {
      const int s = s0 + u;   // the stage added; s0 % L == 0 keeps sets static
      if (s >= n_stages) break;
      issue((s + NS - 1) % NS, (NS - 1) * B, m[(u + NS - 1) % L],
            wv[(u + NS - 1) % L]);
      load(m[(u + NS - 1) % L], wv[(u + NS - 1) % L]);
      cp_async_wait<NS - 1>();
      const int slot = s % NS;
#pragma unroll
      for (int b = 0; b < B; ++b) {
        if (s * B + b >= n_rounds) break;
        const int r = r_begin + cs.rg * G + grp;
        const bool live = r < r_end;           // dead lanes still shuffle
        if (live && cs.jr * S + sl < k) {
          const int cell = (slot * B + b) * 32 + lane;
          const unsigned char* xc = xs + cell * CB;
          float v[D];
          if (!copies) {
            load_row<T, D, kSplit>(X, *reinterpret_cast<const int*>(xc), d,
                                   c0, v);
          } else if (self >> b & 1) {
            if (xn_row != r) {
              load_row<T, D, kSplit>(X, row0 + r, d, c0, xn);
              xn_row = r;
            }
#pragma unroll
            for (int c = 0; c < D; ++c) v[c] = xn[c];
          } else {
            read_cell<T, D>(xc, v);
          }
          add_slot<D>(deg, acc, widen(ws[cell]), v);
        }
        if (cs.jr == R - 1) {                  // the row's last round
          group_reduce<D, S>(deg, acc);
          if (live && sl == 0)
            write_row<T, D>(X, d, c0, row0 + r, r, deg, acc, out);
          deg = 0.f;
#pragma unroll
          for (int c = 0; c < D; ++c) acc[c] = 0.f;
        }
        cs.next(R);
      }
      self >>= B;
    }
  }
}

// layout: 0 "vmem", 1 "hbm", kLocal the local-rows kernel.
constexpr int kLocal = 2;

// The launch shape.  "vmem" and local: `rows` rows a block and P, a lane's
// slots a pass (`chunk`); "hbm": `rows` rows a block and the span in row
// groups (`chunk`).  0 takes the default.
struct Shape {
  int rows, chunk;
};

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

template <typename T, int D, bool kSplit, int S, int P>
int launch_direct(int layout, int threads, const T* X, const int* idx,
                  const T* w, int d, int k, int row0, int n_rows, float* out,
                  cudaStream_t st) {
  const dim3 grid(
      static_cast<unsigned>((static_cast<long long>(n_rows) * S + threads - 1)
                            / threads),
      kSplit ? (d + D - 1) / D : 1);
  if (layout == 0)
    ell_gather<T, D, kSplit, S, P><<<grid, threads, 0, st>>>(X, idx, w, d, k,
                                                             n_rows, out);
  else
    ell_gather_local<T, D, kSplit, S, P><<<grid, threads, 0, st>>>(
        X, idx, w, d, k, row0, n_rows, out);
  return static_cast<int>(cudaGetLastError());
}

// S, the lanes a row: a power of two >= k up to a warp, at least 4 (the
// sum order of a row follows S, not P).  P, a lane's slots a pass: by
// default ceil(k / S) rounded up to 1, 2, 4 or 8 (wider rows take passes
// of 8); at S = 32 any of the four.  Threads a block: rows x S, a multiple
// of 32 up to 512.
template <typename T, int D, bool kSplit>
int launch_direct_k(int layout, Shape sh, const T* X, const int* idx,
                    const T* w, int d, int k, int row0, int n_rows,
                    float* out, cudaStream_t st) {
  const int S = k <= 4 ? 4 : k <= 8 ? 8 : k <= 16 ? 16 : 32;
  const int threads = sh.rows ? sh.rows * S : kThreads;
  const int P = sh.chunk ? sh.chunk
                         : k <= 32 ? 1 : k <= 64 ? 2 : k <= 128 ? 4 : 8;
  if (sh.rows > kMaxThreads || threads < 32 || threads > kMaxThreads ||
      threads % 32)
    return kInvalid;
#define ELL_DIRECT(S, P)                                                      \
  launch_direct<T, D, kSplit, S, P>(layout, threads, X, idx, w, d, k, row0,  \
                                    n_rows, out, st)
  if (S < 32) {
    if (P != 1) return kInvalid;
    if (S == 4) return ELL_DIRECT(4, 1);
    if (S == 8) return ELL_DIRECT(8, 1);
    return ELL_DIRECT(16, 1);
  }
  switch (P) {
    case 1: return ELL_DIRECT(32, 1);
    case 2: return ELL_DIRECT(32, 2);
    case 4: return ELL_DIRECT(32, 4);
    case 8: return ELL_DIRECT(32, 8);
    default: return kInvalid;
  }
#undef ELL_DIRECT
}

// "hbm": `warps` warps a block, each walking `span_groups` row groups.
template <typename T, int D, bool kSplit, int S>
int launch_staged(int warps, int span_groups, const T* X, const int* idx,
                  const T* w, int d, int k, int row0, int n_rows, float* out,
                  cudaStream_t st) {
  const long long rows_a_block =
      static_cast<long long>(span_groups) * (32 / S) * warps;
  const size_t bytes = static_cast<size_t>(warps) * kStages * kRounds * 32 *
                       (kCellBytes<T, D, kSplit> + sizeof(T));
  static_assert(static_cast<size_t>(kMaxStagedWarps) * kStages * kRounds *
                        32 * (kCellBytes<T, D, kSplit> + sizeof(T)) <=
                    kMaxSmem,
                "the rings outgrow shared memory");
  const auto kernel = ell_gather_staged<T, D, kSplit, S>;
  cudaError_t err = cudaSuccess;
  if (bytes > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               kCarveout);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n_rows + rows_a_block - 1) /
                                        rows_a_block),
                  kSplit ? (d + D - 1) / D : 1);
  kernel<<<grid, 32 * warps, bytes, st>>>(X, idx, w, d, k, row0, n_rows,
                                          span_groups, out);
  return static_cast<int>(cudaGetLastError());
}

// "hbm": S as for the direct gather, so that both give a row's slots to the
// same lanes in the same order.  rows = warps x span x (32 / S).
template <typename T, int D, bool kSplit>
int launch_staged_k(Shape sh, const T* X, const int* idx, const T* w, int d,
                    int k, int row0, int n_rows, float* out,
                    cudaStream_t st) {
  const int S = k <= 4 ? 4 : k <= 8 ? 8 : k <= 16 ? 16 : 32;
  const int span = sh.chunk ? sh.chunk : kSpan;
  const int per_warp = span * (32 / S);
  const int warps = sh.rows ? sh.rows / per_warp : kStagedWarps;
  if (span < 1 || span > 4096 || (sh.rows && sh.rows % per_warp) ||
      warps < 1 || warps > kMaxStagedWarps)
    return kInvalid;
#define ELL_STAGED(S)                                                      \
  launch_staged<T, D, kSplit, S>(warps, span, X, idx, w, d, k, row0, n_rows, \
                                 out, st)
  if (S == 4) return ELL_STAGED(4);
  if (S == 8) return ELL_STAGED(8);
  if (S == 16) return ELL_STAGED(16);
  return ELL_STAGED(32);
#undef ELL_STAGED
}

template <typename T>
int launch_d(int layout, Shape sh, const void* Xv, const int* idx,
             const void* wv, int d, int k, int row0, int n_rows, float* out,
             cudaStream_t st) {
  const T* X = static_cast<const T*>(Xv);
  const T* w = static_cast<const T*>(wv);
  if (layout == 1) {
    switch (d) {
      case 1: return launch_staged_k<T, 1, false>(sh, X, idx, w, d, k, row0, n_rows, out, st);
      case 2: return launch_staged_k<T, 2, false>(sh, X, idx, w, d, k, row0, n_rows, out, st);
      case 3: return launch_staged_k<T, 3, false>(sh, X, idx, w, d, k, row0, n_rows, out, st);
      case 4: return launch_staged_k<T, 4, false>(sh, X, idx, w, d, k, row0, n_rows, out, st);
      default: return launch_staged_k<T, 4, true>(sh, X, idx, w, d, k, row0, n_rows, out, st);
    }
  }
  switch (d) {
    case 1: return launch_direct_k<T, 1, false>(layout, sh, X, idx, w, d, k, row0, n_rows, out, st);
    case 2: return launch_direct_k<T, 2, false>(layout, sh, X, idx, w, d, k, row0, n_rows, out, st);
    case 3: return launch_direct_k<T, 3, false>(layout, sh, X, idx, w, d, k, row0, n_rows, out, st);
    case 4: return launch_direct_k<T, 4, false>(layout, sh, X, idx, w, d, k, row0, n_rows, out, st);
    default: return launch_direct_k<T, 4, true>(layout, sh, X, idx, w, d, k, row0, n_rows, out, st);
  }
}

int launch_any(int layout, Shape sh, const void* X, const void* idx,
               const void* w, int n_x, int d, int k, int row0, int n_rows,
               int bf16, void* out, void* stream) {
  if (n_x < 1 || d < 1 || k < 1 || row0 < 0 || n_rows < 0 ||
      row0 > n_x - n_rows || sh.rows < 0 || sh.chunk < 0)
    return kInvalid;
  if (n_rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  return bf16 ? launch_d<uint16_t>(layout, sh, X, ip, w, d, k, row0, n_rows, o, st)
              : launch_d<float>(layout, sh, X, ip, w, d, k, row0, n_rows, o, st);
}

}  // namespace

// X (n, d), idx (n, k) int32, w (n, k): row-major, contiguous, X and w in
// the storage type (bf16 != 0: bfloat16, else float32), all 16-byte
// aligned.  out: (n, d) float32.  layout: 0 "vmem" (direct gather), 1 "hbm"
// (staged).  The launch shape (0: the default): "vmem": rows a block
// (rows x S threads, a multiple of 32 up to 512) and P, a lane's slots a
// pass (1, 2, 4 or 8; 1 where k <= 16); "hbm": rows a block (warps x span
// x 32 / S, 1 to 8 warps) and the span in row groups.  Every shape gives
// the same bits.  Enqueues on `stream` and returns the launch status
// (cudaError_t as int; cudaErrorInvalidValue for a shape out of range).
extern "C" int ell_lap_matvec_launch(const void* X, const void* idx,
                                     const void* w, int n, int d, int k,
                                     int bf16, int layout, int rows,
                                     int chunk, void* out, void* stream) {
  if (layout != 0 && layout != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_any(layout, Shape{rows, chunk}, X, idx, w, n, d, k, 0, n,
                    bf16, out, stream);
}

// The local-rows kernel: X (n_x, d) replicated, idx (n_rows, k) int32 with
// global ids in [0, n_x) and w (n_rows, k) one rank's rows of the graph,
// whose row r is row row0 + r of X (0 <= row0 <= n_x - n_rows).  out:
// (n_rows, d) float32.  rows, chunk: the launch shape, as for "vmem".
// Otherwise as `ell_lap_matvec_launch`.
extern "C" int ell_lap_matvec_local_launch(const void* X, const void* idx,
                                           const void* w, int n_x, int d,
                                           int k, int row0, int n_rows,
                                           int bf16, int rows, int chunk,
                                           void* out, void* stream) {
  return launch_any(kLocal, Shape{rows, chunk}, X, idx, w, n_x, d, k, row0,
                    n_rows, bf16, out, stream);
}
