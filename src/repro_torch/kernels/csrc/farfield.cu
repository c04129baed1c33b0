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
// The fused evaluation, `bh_tree` (`bh_tree_launch`), is the Hopper design
// of the same TPU kernel.  The TPU kernel takes materialised (idx, w)
// streams because XLA fuses the integer work that builds them; here that
// work would be ~15 int64 (N, W) temporaries a far level and 614 MB of
// streams an evaluation at N = 70000, written only to be read back, in 12
// launches with their zero-fills and adds.  `bh_tree` instead takes the
// grid state of one evaluation (kernels/ref.py `TreeGrid`: X and the cell
// ids in sorted order, the finest cells' starts and counts, every far
// level's counts and centre-of-mass table, the residual tables) and
// derives every slot of every batch in registers, with the integers of
// ref.py `tree_slots`:
//
//   * far level l: cl = coord >> (D - l), the window offset, the in-bounds
//     and parent-near tests, tcell, w = counts_l[tcell];
//   * near: sorted position pos = starts[tcell] + slot, listed iff slot <
//     count, self iff pos == p (so the target is Xs[pos]);
//   * residual: res_cnt[tcell], minus one in the own cell when the row's
//     rank p - starts[cid] is >= cap.
//
// A warp owns sorted position p, so a block's 8 rows are neighbours on the
// grid and share far windows and near cells in L1.  The sums keep the
// per-batch path's order exactly: batches far l1..D, near, residual; each
// in <= chunk-wide column slices; in a slice, slot j on lane (j - c0) mod
// S, S as `launch_s` picks it for that slice's width, lanes >= S holding
// exact zeros through the extra shuffle offsets (+0 changes nothing);
// slices summed into the batch's (s, F) and F into the total, as
// sparse/farfield.py's `_apply_chunked` and `_tree_repulsion_batched` do.
// Both kernels call one per-slot function (`add_slot`), so every s row and
// F equal the per-batch path's bit for bit.  Keep the pair terms and the
// adds in that one function: where b = sp (the exp kinds) the compiler
// shares w sp between s and F, and code that computes the terms apart (in
// another lane, through shared memory) rounds s otherwise.  The rows are
// written once, through perm[p], with no atomics.  d = 2 only (the tree is
// 2-D).
//
// Bound of `bh_tree` on an H100 SXM: operations.  It reads the state and
// writes its outputs once (~7 MB at N = 70000, ~2 us at 3.35 TB/s); it
// does ~18 integer operations a slot to derive the slot and ~10 float
// operations a live one, over N x 1097 slots at the default plan, of
// which ~10% are live (chip_smoke.py counts them per run).  What holds it
// is instructions issued, not bytes: the slot derivation is more than half
// of them, and a warp runs the pair terms of a step when any of its lanes
// has a live slot.  So the derivation is lean: 32-bit offsets, each range
// test one unsigned compare, the level tables walked by pointer, a shift
// for a power-of-two cap.  Tried and slower: staging the coarse levels'
// tables in shared memory, prefetching the next slot's target into
// registers, and compacting the live slots of four steps into one pass of
// the pair terms (through shared memory; also not bit-equal, as above).
//
// The launch shape is a runtime choice (`kernels/autotune.py` searches
// it): rows a block, up to 512 threads (`bh_rows`: rows x S threads, by
// default 256; `bh_tree`: a warp a row, by default 8 rows).  A row is
// summed by its own group of lanes whatever the block, so every shape gives
// the same bits.  `chunk` is not a launch shape: it sets the slices a
// batch is summed in, and so the sum order.
//
// Built by `repro_torch/kernels/_build.py` with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (`bh_interaction_launch`, `bh_tree_launch`,
// plain C interfaces).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// kinds in ref.py's order: ee, ssne, tsne, tee, epan
enum Pair { GAUSS = 0, STUDENT = 1, EPAN = 2 };

constexpr int kThreads = 256;          // default threads a block
constexpr int kMaxThreads = 512;       // most threads a block
constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

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

// One slot: t = |x - c|^2, the pair terms, and the weighted adds into the
// lane's (s, f).  Both kernels call it, so their sums round alike.
template <typename T, int PAIR, int D>
__device__ __forceinline__ void add_slot(const float (&x)[D],
                                         const T* __restrict__ cm, float wj,
                                         float& s, float (&f)[D]) {
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

template <typename T, int PAIR, int D, int S>
__global__ void __launch_bounds__(kMaxThreads)
bh_rows(const T* __restrict__ X, const int* __restrict__ idx, long long ld_idx,
        const float* __restrict__ w, long long ld_w,
        const T* __restrict__ table, int n, int width,
        float* __restrict__ s_out, float* __restrict__ f_out) {
  const int lane = threadIdx.x % S;
  const long long r = (static_cast<long long>(blockIdx.x) * blockDim.x +
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
      add_slot<T, PAIR, D>(x, table + static_cast<size_t>(m) * D, wj, s, f);
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
int launch(int threads, const T* X, const int* idx, long long ld_idx,
           const float* w, long long ld_w, const T* table, int n, int width,
           float* s_out, float* f_out, cudaStream_t st) {
  const long long lanes = static_cast<long long>(n) * S;
  const dim3 grid(static_cast<unsigned>((lanes + threads - 1) / threads));
  bh_rows<T, PAIR, D, S><<<grid, threads, 0, st>>>(
      X, idx, ld_idx, w, ld_w, table, n, width, s_out, f_out);
  return static_cast<int>(cudaGetLastError());
}

// S: the lanes a row, the largest power of two <= width in [4, 32].
// threads: rows x S (0 rows: 256 threads), a multiple of 32 up to 512.
template <typename T, int PAIR, int D>
int launch_s(int rows, const T* X, const int* idx, long long ld_idx,
             const float* w, long long ld_w, const T* table, int n, int width,
             float* s_out, float* f_out, cudaStream_t st) {
  const int S = width >= 32 ? 32 : width >= 16 ? 16 : width >= 8 ? 8 : 4;
  const int t = rows ? rows * S : kThreads;
  if (rows < 0 || rows > kMaxThreads || t < 32 || t > kMaxThreads || t % 32)
    return kInvalid;
  if (S == 32)
    return launch<T, PAIR, D, 32>(t, X, idx, ld_idx, w, ld_w, table, n, width, s_out, f_out, st);
  if (S == 16)
    return launch<T, PAIR, D, 16>(t, X, idx, ld_idx, w, ld_w, table, n, width, s_out, f_out, st);
  if (S == 8)
    return launch<T, PAIR, D, 8>(t, X, idx, ld_idx, w, ld_w, table, n, width, s_out, f_out, st);
  return launch<T, PAIR, D, 4>(t, X, idx, ld_idx, w, ld_w, table, n, width, s_out, f_out, st);
}

template <typename T, int PAIR>
int launch_d(int rows, const T* X, const int* idx, long long ld_idx,
             const float* w, long long ld_w, const T* table, int n, int d,
             int width, float* s_out, float* f_out, cudaStream_t st) {
  switch (d) {
    case 1: return launch_s<T, PAIR, 1>(rows, X, idx, ld_idx, w, ld_w, table, n, width, s_out, f_out, st);
    case 2: return launch_s<T, PAIR, 2>(rows, X, idx, ld_idx, w, ld_w, table, n, width, s_out, f_out, st);
    case 3: return launch_s<T, PAIR, 3>(rows, X, idx, ld_idx, w, ld_w, table, n, width, s_out, f_out, st);
    default: return launch_s<T, PAIR, 4>(rows, X, idx, ld_idx, w, ld_w, table, n, width, s_out, f_out, st);
  }
}

template <typename T>
int launch_kind(int kind, int rows, const void* Xv, const int* idx,
                long long ld_idx, const float* w, long long ld_w,
                const void* tv, int n, int d, int width, float* s_out,
                float* f_out, cudaStream_t st) {
  const T* X = static_cast<const T*>(Xv);
  const T* table = static_cast<const T*>(tv);
  if (kind <= 1)
    return launch_d<T, GAUSS>(rows, X, idx, ld_idx, w, ld_w, table, n, d, width, s_out, f_out, st);
  if (kind <= 3)
    return launch_d<T, STUDENT>(rows, X, idx, ld_idx, w, ld_w, table, n, d, width, s_out, f_out, st);
  return launch_d<T, EPAN>(rows, X, idx, ld_idx, w, ld_w, table, n, d, width, s_out, f_out, st);
}

// -- the fused evaluation ------------------------------------------------------

constexpr int kWarps = kThreads / 32;  // default rows (sorted positions) a block

// The lanes `launch_s` gives a slice of `width` slots.
__device__ __forceinline__ int slice_lanes(int width) {
  return width >= 32 ? 32 : width >= 16 ? 16 : width >= 8 ? 8 : 4;
}

// A derived slot: its weight (0: masked) and its target row.
template <typename T>
struct Target {
  float w;
  const T* cm;
};

// A batch's (or the evaluation's) sums: s and F.
struct Sums {
  float s, f0, f1;
};

// One batch of `width` slots summed as the per-batch path sums it: <= chunk
// columns a slice, slot j of a slice on lane (j - c0) mod S in increasing
// j, a butterfly over the warp (lanes >= S hold +0: their offsets add
// nothing), each slice's sum added into the batch's from zero.  slot(j)
// returns slot j's Target.  Every lane ends with the same sums: a float
// add commutes.
template <typename T, int PAIR, typename Slot>
__device__ __forceinline__ Sums batch_sum(int width, int chunk, int lane,
                                          const float (&x)[2], Slot slot) {
  Sums b = {0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < width; c0 += chunk) {
    const int end = min(c0 + chunk, width);
    const int S = slice_lanes(end - c0);
    float s = 0.f;
    float f[2] = {0.f, 0.f};
    if (lane < S) {
      for (int j = c0 + lane; j < end; j += S) {
        const Target<T> tg = slot(j);
        if (tg.w == 0.0f) continue;        // masked slot: adds nothing
        add_slot<T, PAIR, 2>(x, tg.cm, tg.w, s, f);
      }
    }
    group_reduce<2, 32>(s, f);
    b.s = b.s + s;
    b.f0 = b.f0 + f[0];
    b.f1 = b.f1 + f[1];
  }
  return b;
}

// 0 <= v < size, one unsigned compare
__device__ __forceinline__ bool in_range(int v, int size) {
  return static_cast<unsigned>(v) < static_cast<unsigned>(size);
}

template <typename T, int PAIR>
__global__ void __launch_bounds__(kMaxThreads)
bh_tree(const T* __restrict__ Xs, const int* __restrict__ cids,
        const int* __restrict__ perm, const int* __restrict__ starts,
        const int* __restrict__ counts, const int* __restrict__ lvl_counts,
        const T* __restrict__ lvl_com, const int* __restrict__ res_cnt,
        const T* __restrict__ res_com, const int2* __restrict__ far, int wf,
        const int2* __restrict__ near, int wn, int n, int depth, int l1,
        int r, int cap, int chunk, float* __restrict__ s_out,
        long long ld_s, float* __restrict__ f_out) {
  const int lane = threadIdx.x % 32;
  const int p = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (p >= n) return;                      // the whole warp
  const float x[2] = {widen(__ldg(Xs + 2ll * p)),
                      widen(__ldg(Xs + 2ll * p + 1))};
  const int G = 1 << depth;
  const int cid = __ldg(cids + p);
  const int cx = cid >> depth, cy = cid & (G - 1);
  float* s_row = s_out + __ldg(perm + p);  // the row's point, batch 0
  Sums F = {0.f, 0.f, 0.f};
  auto finish = [&](const Sums& b) {
    F.f0 = F.f0 + b.f0;
    F.f1 = F.f1 + b.f1;
    if (lane == 0) *s_row = b.s;
    s_row += ld_s;
  };

  // far levels l1..depth against each level's centre-of-mass table
  const int* cnt = lvl_counts;             // level l's first table row
  const T* com = lvl_com;
  for (int lev = l1; lev <= depth; ++lev) {
    const int Gl = 1 << lev;
    const int clx = cx >> (depth - lev), cly = cy >> (depth - lev);
    // parent-was-near, |(t >> 1) - (c >> 1)| <= r, as one unsigned compare
    // of (t >> 1) - (c >> 1) + r against 2 r
    const int px = r - (clx >> 1), py = r - (cly >> 1);
    finish(batch_sum<T, PAIR>(wf, chunk, lane, x, [=](int j) {
      const int2 o = __ldg(far + j);
      const int tx = clx + o.x, ty = cly + o.y;
      if (!in_range(tx, Gl) || !in_range(ty, Gl) ||
          !in_range((tx >> 1) + px, 2 * r + 1) ||
          !in_range((ty >> 1) + py, 2 * r + 1))
        return Target<T>{};
      const int tcell = (tx << lev) + ty;
      return Target<T>{static_cast<float>(__ldg(cnt + tcell)),
                       com + 2 * tcell};
    }));
    cnt += Gl * Gl;
    com += 2 * Gl * Gl;
  }

  // near: cap listed sorted positions a cell of the window, self masked; a
  // power-of-two cap splits j with a shift
  const int cap_shift = (cap & (cap - 1)) == 0 ? __ffs(cap) - 1 : -1;
  finish(batch_sum<T, PAIR>(wn * cap, chunk, lane, x, [=](int j) {
    const int k = cap_shift >= 0 ? j >> cap_shift : j / cap;
    const int slot = j - k * cap;
    const int2 o = __ldg(near + k);
    const int tx = cx + o.x, ty = cy + o.y;
    if (!in_range(tx, G) || !in_range(ty, G)) return Target<T>{};
    const int tcell = (tx << depth) + ty;
    if (slot >= __ldg(counts + tcell)) return Target<T>{};
    const int pos = __ldg(starts + tcell) + slot;
    if (pos == p) return Target<T>{};
    return Target<T>{1.f, Xs + 2ll * pos};
  }));

  // residual: one centre of mass a spilling cell, self dropped from the own
  // cell's when the row is ranked past cap
  const int self = p - __ldg(starts + cid) >= cap ? 1 : 0;
  finish(batch_sum<T, PAIR>(wn, chunk, lane, x, [=](int j) {
    const int2 o = __ldg(near + j);
    const int tx = cx + o.x, ty = cy + o.y;
    if (!in_range(tx, G) || !in_range(ty, G)) return Target<T>{};
    const int tcell = (tx << depth) + ty;
    const int w = __ldg(res_cnt + tcell) - ((o.x | o.y) == 0 ? self : 0);
    if (w <= 0) return Target<T>{};
    return Target<T>{static_cast<float>(w), res_com + 2 * tcell};
  }));

  if (lane == 0) {
    const long long dst = __ldg(perm + p);
    f_out[2 * dst] = F.f0;
    f_out[2 * dst + 1] = F.f1;
  }
}

template <typename T>
int tree_kind(int kind, int rows, const void* Xs, const int* cids,
              const int* perm, const int* starts, const int* counts,
              const int* lvl_counts, const void* lvl_com, const int* res_cnt,
              const void* res_com, const int2* far, int wf, const int2* near,
              int wn, int n, int depth, int l1, int r, int cap, int chunk,
              float* s_out, long long ld_s, float* f_out, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((n + rows - 1) / rows));
  const int threads = 32 * rows;
  const T* X = static_cast<const T*>(Xs);
  const T* lc = static_cast<const T*>(lvl_com);
  const T* rc = static_cast<const T*>(res_com);
  if (kind <= 1)
    bh_tree<T, GAUSS><<<grid, threads, 0, st>>>(
        X, cids, perm, starts, counts, lvl_counts, lc, res_cnt, rc, far, wf,
        near, wn, n, depth, l1, r, cap, chunk, s_out, ld_s, f_out);
  else if (kind <= 3)
    bh_tree<T, STUDENT><<<grid, threads, 0, st>>>(
        X, cids, perm, starts, counts, lvl_counts, lc, res_cnt, rc, far, wf,
        near, wn, n, depth, l1, r, cap, chunk, s_out, ld_s, f_out);
  else
    bh_tree<T, EPAN><<<grid, threads, 0, st>>>(
        X, cids, perm, starts, counts, lvl_counts, lc, res_cnt, rc, far, wf,
        near, wn, n, depth, l1, r, cap, chunk, s_out, ld_s, f_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X (n, d) and table (m, d): row-major, contiguous, in the storage type
// (bf16 != 0: bfloat16, else float32).  idx (n, width) int32 and w (n,
// width) float32: unit column stride, row strides ld_idx and ld_w.  kind:
// index into ("ee", "ssne", "tsne", "tee", "epan").  s_out (n,) and f_out
// (n, d): float32, contiguous.  rows: rows a block (rows x S threads, a
// multiple of 32 up to 512; 0: 256 threads).  Enqueues on `stream` and
// returns the launch status (cudaError_t as int; cudaErrorInvalidValue for
// a shape out of range).
extern "C" int bh_interaction_launch(const void* X, const void* idx,
                                     long long ld_idx, const void* w,
                                     long long ld_w, const void* table, int n,
                                     int m, int d, int width, int kind,
                                     int bf16, int rows, void* s_out,
                                     void* f_out, void* stream) {
  if (n < 0 || m < 1 || d < 1 || d > 4 || width < 1 || kind < 0 ||
      kind > 4 || ld_idx < width || ld_w < width)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  const float* wp = static_cast<const float*>(w);
  float* so = static_cast<float*>(s_out);
  float* fo = static_cast<float*>(f_out);
  return bf16 ? launch_kind<uint16_t>(kind, rows, X, ip, ld_idx, wp, ld_w,
                                      table, n, d, width, so, fo, st)
              : launch_kind<float>(kind, rows, X, ip, ld_idx, wp, ld_w, table,
                                   n, d, width, so, fo, st);
}

// One whole tree evaluation from the grid state (d = 2).  Xs (n, 2): X in
// sorted order, in the storage type (bf16 != 0: bfloat16, else float32);
// cids (n,) and perm (n,): each sorted point's finest cell id (ascending)
// and point id; starts, counts, res_cnt (G^2,) with G = 2^depth; lvl_counts
// and lvl_com (4^l rows, l = l1..depth, concatenated; lvl_com (., 2) in
// the storage type); res_com (G^2, 2) in the storage type; far (wf, 2) and
// near (wn, 2) int32 window offsets.  All integers int32, all contiguous.
// rows: rows (a warp each) a block, 1 to 16 (0: 8).
// Writes s_out (depth - l1 + 3 rows of row stride ld_s >= n: far levels,
// near, residual) and f_out (n, 2), float32, in point order.  kind: index
// into ("ee", "ssne", "tsne", "tee", "epan").  Enqueues on `stream` and
// returns the launch status (cudaError_t as int).
extern "C" int bh_tree_launch(const void* Xs, const void* cids,
                              const void* perm, const void* starts,
                              const void* counts, const void* lvl_counts,
                              const void* lvl_com, const void* res_cnt,
                              const void* res_com, const void* far, int wf,
                              const void* near, int wn, int n, int depth,
                              int l1, int r, int cap, int chunk, int kind,
                              int bf16, int rows, void* s_out, long long ld_s,
                              void* f_out, void* stream) {
  if (rows == 0) rows = kWarps;
  if (n < 0 || l1 < 1 || depth < l1 || depth > 14 || r < 1 || cap < 1 ||
      chunk < 1 || wf < 1 || wn < 1 || kind < 0 || kind > 4 || ld_s < n ||
      rows < 1 || rows > kMaxThreads / 32)
    return kInvalid;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ci = static_cast<const int*>(cids);
  const int* pe = static_cast<const int*>(perm);
  const int* sa = static_cast<const int*>(starts);
  const int* co = static_cast<const int*>(counts);
  const int* lc = static_cast<const int*>(lvl_counts);
  const int* rc = static_cast<const int*>(res_cnt);
  const int2* fa = static_cast<const int2*>(far);
  const int2* ne = static_cast<const int2*>(near);
  float* so = static_cast<float*>(s_out);
  float* fo = static_cast<float*>(f_out);
  return bf16 ? tree_kind<uint16_t>(kind, rows, Xs, ci, pe, sa, co, lc,
                                    lvl_com, rc, res_com, fa, wf, ne, wn, n,
                                    depth, l1, r, cap, chunk, so, ld_s, fo, st)
              : tree_kind<float>(kind, rows, Xs, ci, pe, sa, co, lc, lvl_com,
                                 rc, res_com, fa, wf, ne, wn, n, depth, l1, r,
                                 cap, chunk, so, ld_s, fo, st);
}
