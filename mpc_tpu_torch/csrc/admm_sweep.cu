// Fused relaxed-ADMM sweep for a batch of condensed-MPC QPs, for Hopper (sm_90a).
//
// Replaces mpc_tpu/ops/pallas_qp.py::_admm_kernel, the TPU kernel that keeps
// x, z and y of a tile of problems in VMEM for a fixed number of iterations.
// Here it is the inner sweep of the ADMM backend (mpc_tpu/ops/qp.py
// admm_step, run check_every times between residual checks):
//
//   rhs = σx − q + Aᵀ(ρ∘z − y)
//   x̃   = Minv rhs                    Minv = (P + σI + AᵀρA)⁻¹, pre-factorised
//   x   ← αx̃ + (1 − α)x
//   ẑ   = αAx̃ + (1 − α)z
//   z   ← clip(ẑ + y/ρ, l, u)
//   y   ← y + ρ∘(ẑ − z)
//
// Layout: one thread block per group of lanes of ONE controller (the table of
// utils/lanes.py::lane_blocks).  The block copies the controller's A into
// shared memory once with asynchronous copies (cp.async) for all its lanes.
// Each lane reads its Minv and ρ from the controller's ρ ladder through its
// rung: Minvs (n_d, n_lad, n, n) and rhovs (n_d, n_lad, m), so no per-lane
// copy of either is gathered in device memory.  Two variants, chosen by
// ops/admm_kernel.py::launch_geometry:
//
// * admm_warp_kernel, n ≤ 32 and a batch of at least 8 lanes per SM: one
//   warp per lane, warp-synchronous, up to 16 lanes a block.  A lane's l, u,
//   ρ, z, y and Minv live in the warp's slice of shared memory; thread j < n
//   holds xⱼ and qⱼ in registers.  Aᵀv, v = ρ∘z − y, is split over ⌊32/n⌋
//   row classes × n columns (one partial sum a thread), then summed per
//   column; Minv·rhs is a thread per output; A·x̃ and the projection are a
//   thread per row.  Three __syncwarp() a sweep, no block barrier after the
//   load.
// * admm_group_kernel, n > 32 or a smaller batch: the block's ACTIVE lanes
//   run the `iters` sweeps in step on 256 threads.  Aᵀv and A·x̃ are small
//   products over those lanes, register-tiled: a thread reads one A element
//   from shared memory and applies it to every lane of the block (kGroup =
//   2 accumulators), so A is read once per pair of lanes instead of once
//   per lane.  Block barriers separate the three phases of a sweep.  Two
//   lanes a block only while the batch leaves two blocks per SM: at
//   8x8/Hp=15, B=256, that is one lane a block, 8 warps on it; at B=4096,
//   two.  Four or eight lanes a block (one block an SM) were slower there.
//   The tensor cores are not used: f32 would need TF32, which keeps ~3 digits
//   against the kernel's 1e-4·(1 + max|plain|) bar, and the f64 path (DMMA,
//   mma.sync m8n8k4) is left for later work.
//
// A per-lane geometry (admm_warp_kernel's OWN, resident layout) takes a
// batch where every lane is its own controller (n_d = B: the SLMPC and
// NonLinMPC fleets' ADMM, n ≤ 3), which the grouping above would run a lane
// a block: up to 16 lanes share a block, one a warp, each warp copying its
// lane's A into its own area in the same asynchronous group as the lane's
// l, u, ρ, z, y and Minv (16-byte pieces where the ends allow), with one
// wait and no block barrier.  The Aᵀv partials are stored column by column
// so that thread j reads its column's ⌊32/n⌋ partials ahead of their sum,
// which keeps its order.  At n = 2 and n = 3 (the pendulum fleets) n is a
// compile-time constant (template parameter NC): the column loops unroll, x̃
// sits in registers for A·x̃, and each thread updates its rows i and i + 32
// together while both exist (both rows' loads ahead of both rows' stores).  A row's
// arithmetic is the same in the same order: the same bits as the
// lane-a-block grouping.
//
// A second layout, "global", takes QPs whose block would not fit the SM's
// shared memory at all (the last resort of ops/admm_kernel.py::
// launch_geometry).  It is the same two kernels (LAYOUT == kGlobal): A, l, u
// and ρ are read where they lie in device memory, and what a block keeps
// after A in shared memory (its lanes' z, y, Minv or z, y, ρz − y, x, q,
// rhs, x̃, and the Aᵀv partial sums) lies in the block's own slice of a
// workspace the wrapper allocates, in the same order.
//
// A third layout, "staged" (admm_staged_kernel, the lanes in step only),
// takes QPs whose A does not fit beside the lanes but whose lanes do: the
// 8x8 fleet at Hp=60 (n=33, m=2017, f32: A is 266 KB, a lane's z and y
// 16 KB).  What bounds it is the bytes of A a block reads from L2 a pass,
// and the latency of each thread's chain of shared-memory reads.  It keeps
// up to four lanes' z, y, x, q, rhs and their ρz − y and x̃ (interleaved
// across the lanes, one vector load a row or a column) in shared memory,
// holds A's leading `rows` rows there for the whole launch, and streams the
// other rows through a ring of `stages` chunks of `tile` rows, each A's
// rows (from the wrapper's copy with rows padded to 16 bytes, so 16-byte
// cp.async and vector loads) with the lanes' l, u and ρ of those rows, so
// the next chunk loads while the block works on the current one.  It
// passes over A once a sweep, not twice: on each chunk it first runs A·x̃,
// the projection and the z, y and ρz − y updates of the chunk's rows, a
// thread a row, then (after a barrier) adds the chunk's rows to the NEXT
// sweep's Aᵀv partial sums, which each thread keeps in registers over the
// pass; one extra pass ahead of the first sweep forms its Aᵀv, so a launch
// reads A iters + 1 times, each A element serving every lane of the block.
// At the Hp=60 fleet (B=4096) on an H100 it is 1.4x faster than the global
// layout and still at 5 % of its bound: the chains of a row's updates and
// the per-chunk barriers, with 8 warps an SM, are not hidden
// (profile_layouts.py times the parts).
//
// Every per-lane sum keeps its order in every layout (the (pp, pj) split of
// Aᵀv over ascending rows, the parts in ascending p, A·x̃ and Minv·rhs over
// ascending columns), so the three layouts return the same bits.
//
// What bounds it on this card (NVIDIA H100 SXM: 3.35 TB/s, 67 TFLOP/s f32):
// per lane and sweep ~4mn + 2n² flops (2,070 at the 2x2 Hp=10 headline, n=5,
// m=101; 83.5k at 8x8 Hp=15, n=33, m=577), against one read of l, u, z, y,
// x, q (and the ladder entries) and one write of x, z, y per launch: ~2.4 µs
// of device memory at the headline (B=4096, 10 sweeps), ~2.8 µs of f32 FMA
// at 8x8 (B=256).  The sweeps run from shared memory as chains of dependent
// shared-memory reads, so the kernel is bound by latency per lane; the design
// answers with many independent lanes in flight (32 per SM at the headline:
// 2 blocks of 16 warps, as the occupancy calculator gives them) and A loaded
// once per block.  Lanes whose `active` flag is 0 are skipped and leave x,
// z, y untouched: that is the lockstep freeze of the reference's vmapped
// while_loop.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 16;   // ops/_build.py::MAX_WARPS
constexpr int kWarpMinBlocks = 2;   // blocks of kMaxWarps warps an SM holds (64 registers)
constexpr int kGroup = 2;       // lanes in step in a block, at most (ops/admm_kernel.py::GROUP)
constexpr int kStagedGroup = 4; // the same in the staged layout (STAGED_LANES)
constexpr int kGroupThreads = 256;
constexpr int kMaxParts = 16;  // row classes of the grouped Aᵀv split, at most
// layouts, as ops/_build.py::LAYOUT_CODE numbers them
constexpr int kResident = 0, kGlobal = 1, kStaged = 2;

template <typename T>
__device__ __forceinline__ T clip(T v, T lo, T hi) {
  // NaN passes through, as in jnp.clip / torch.clamp
  return v < lo ? lo : (v > hi ? hi : v);
}

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, int count, int t, int nt) {
  for (int e = t; e < count; e += nt) __pipeline_memcpy_async(dst + e, src + e, sizeof(T));
}

// a lane's inputs into its slice: asynchronous copies into shared memory, or
// plain loads and stores into the workspace (cp.async writes shared memory
// only); either way complete after __pipeline_wait_prior(0) and a barrier
template <bool GLOBAL, typename T>
__device__ __forceinline__ void copy_in(T* dst, const T* src, int count, int t, int nt) {
  if constexpr (GLOBAL) {
    for (int e = t; e < count; e += nt) dst[e] = src[e];
  } else {
    copy_async(dst, src, count, t, nt);
  }
}

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

// `bytes` (a multiple of 4) from `src` to `dst` in shared memory, as
// asynchronous copies of 16 bytes where both ends and the size allow it,
// else 8, else 4
__device__ __forceinline__ void copy_bytes_async(void* dst, const void* src, size_t bytes,
                                                 int t, int nt) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) | bytes;
  char* d = static_cast<char*>(dst);
  const char* g = static_cast<const char*>(src);
  if ((a & 15) == 0) {
    for (size_t e = (size_t)t * 16; e < bytes; e += (size_t)nt * 16)
      __pipeline_memcpy_async(d + e, g + e, 16);
  } else if ((a & 7) == 0) {
    for (size_t e = (size_t)t * 8; e < bytes; e += (size_t)nt * 8)
      __pipeline_memcpy_async(d + e, g + e, 8);
  } else {
    for (size_t e = (size_t)t * 4; e < bytes; e += (size_t)nt * 4)
      __pipeline_memcpy_async(d + e, g + e, 4);
  }
}

// shared memory, in the order of ops/admm_kernel.py::smem_bytes; the global
// layout's workspace holds each block's part after A without l, u and ρ
// (workspace_bytes); a per-lane block (own_bytes) is one area a warp, its
// lane's A and then its slice
template <typename T>
__host__ __device__ size_t warp_slice(int n, int m, bool global) {
  return align16(sizeof(T) * ((global ? 2 : 5) * (size_t)m + n * n + 2 * n + (32 / n) * n));
}
template <typename T>
__host__ __device__ size_t own_area(int n, int m) {
  return align16(sizeof(T) * (size_t)m * n) + warp_slice<T>(n, m, false);
}
template <typename T>
__host__ __device__ size_t group_lane(int n, int m, bool global) {
  return align16(sizeof(T) * ((global ? 3 : 6) * (size_t)m + 4 * n));
}
// row classes of the grouped Aᵀv split: as many as the threads allow, up to
// kMaxParts, so that small n does not end in a long serial sum of partials;
// one when n > kGroupThreads, each thread then taking several columns
__host__ __device__ inline int group_parts(int n) {
  const int p = kGroupThreads / n;
  return p < 1 ? 1 : (p > kMaxParts ? kMaxParts : p);
}
template <typename T>
__host__ __device__ size_t group_part(int n, int width) {
  return align16(sizeof(T) * (size_t)group_parts(n) * width * n);
}
// the staged layout (ops/admm_kernel.py::staged_bytes): A's rows padded to
// 16 bytes; a lane's slice (z, y, x, q, rhs); a chunk of `rows` rows (A's
// rows, then the W lanes' l, u and ρ of them); the whole block: W slices,
// ρz − y and x̃ of the W lanes, the partial sums, the resident chunk and
// the ring of `stages` chunks of `tile` rows
template <typename T>
__host__ __device__ constexpr int row_stride(int n) {
  return (n + int(16 / sizeof(T)) - 1) / int(16 / sizeof(T)) * int(16 / sizeof(T));
}
template <typename T>
__host__ __device__ size_t staged_lane(int n, int m) {
  return align16(sizeof(T) * (2 * (size_t)m + 3 * n));
}
template <typename T>
__host__ __device__ size_t staged_chunk(int n, int width, int rows) {
  return align16(sizeof(T) * (size_t)rows * row_stride<T>(n)) +
         align16(sizeof(T) * 3 * (size_t)width * rows);
}
template <typename T>
__host__ __device__ size_t staged_bytes(int n, int m, int width, int rows, int tile, int stages) {
  return width * staged_lane<T>(n, m) + align16(sizeof(T) * (size_t)m * width) +
         align16(sizeof(T) * (size_t)n * width) + group_part<T>(n, width) +
         staged_chunk<T>(n, width, rows) + stages * staged_chunk<T>(n, width, tile);
}

// one row of one lane after A·x̃: the relaxation, the projection and the
// dual step; returns ρz − y for the next Aᵀv
template <typename T>
__device__ __forceinline__ T row_step(T ax, T alpha, T one_m_alpha, T lo, T hi, T rho, T* zi,
                                      T* yi) {
  const T yo = *yi;
  const T zp = alpha * ax + one_m_alpha * *zi;
  const T zn = clip(zp + yo / rho, lo, hi);
  const T yn = yo + rho * (zp - zn);
  *yi = yn;
  *zi = zn;
  return rho * zn - yn;
}

// ---- one warp per lane (n ≤ 32) ------------------------------------------------
// OWN (resident only): the per-lane geometry, where every lane is its own
// controller: `block_ctrl` is then each LANE's controller, each warp copies
// its lane's A into its own area in the same asynchronous group as the
// lane's other loads and waits once, with no block barrier; the Aᵀv partial
// sums lie column by column, so that a column's ⌊32/n⌋ partials are read
// together and summed in the same order (the same bits).
template <typename T, int LAYOUT, bool OWN, int NC = 0>
__global__ void __launch_bounds__(32 * kMaxWarps, kWarpMinBlocks)
admm_warp_kernel(const T* __restrict__ Minvs, const T* __restrict__ A,
                 const int32_t* __restrict__ table, const int32_t* __restrict__ block_ctrl,
                 int width, const int32_t* __restrict__ rung, const T* __restrict__ q,
                 const T* __restrict__ l, const T* __restrict__ u, const T* __restrict__ rhovs,
                 T* __restrict__ x, T* __restrict__ z, T* __restrict__ y,
                 const uint8_t* __restrict__ active, unsigned char* ws, int n, int m, int n_lad,
                 int iters, T sigma, T alpha) {
  if constexpr (NC > 0) n = NC;        // the launch checked n == NC
  constexpr bool GLOBAL = LAYOUT == kGlobal;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t slice = warp_slice<T>(n, m, GLOBAL);
  const T* sA;                                                  // m*n
  unsigned char* wsm;
  int c;
  if constexpr (OWN) {
    const int b0 = warp < width ? table[(size_t)blockIdx.x * width + warp] : -1;
    if (b0 < 0 || !active[b0]) return;
    c = block_ctrl[b0];
    T* A_w = reinterpret_cast<T*>(smem_raw + (size_t)warp * own_area<T>(n, m));
    copy_bytes_async(A_w, A + (size_t)c * m * n, sizeof(T) * (size_t)m * n, lane, 32);
    sA = A_w;
    wsm = reinterpret_cast<unsigned char*>(A_w) + align16(sizeof(T) * (size_t)m * n);
  } else if constexpr (GLOBAL) {
    c = block_ctrl[blockIdx.x];
    sA = A + (size_t)c * m * n;
    wsm = ws + ((size_t)blockIdx.x * (blockDim.x >> 5) + warp) * slice;
  } else {
    c = block_ctrl[blockIdx.x];
    T* A_s = reinterpret_cast<T*>(smem_raw);
    copy_async(A_s, A + (size_t)c * m * n, m * n, tid, blockDim.x);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    sA = A_s;
    wsm = smem_raw + align16(sizeof(T) * (size_t)m * n) + warp * slice;
  }
  const int b = warp < width ? table[(size_t)blockIdx.x * width + warp] : -1;
  if (b < 0 || !active[b]) return;
  const size_t bn = (size_t)b * n, bm = (size_t)b * m;
  const size_t rg = (size_t)c * n_lad + rung[b];
  // the slice: (l, u, ρ: resident only) z, y (m each), Minv (n*n), rhs, x̃
  // (n each), the (32/n)*n partial sums of Aᵀv
  T* w0 = reinterpret_cast<T*>(wsm);
  const T* sl = GLOBAL ? l + bm : w0;
  const T* su = GLOBAL ? u + bm : w0 + m;
  const T* srho = GLOBAL ? rhovs + rg * m : w0 + 2 * m;
  T* sz = GLOBAL ? w0 : w0 + 3 * m;
  T* sy = sz + m;
  T* sM = sy + m;
  T* srhs = sM + n * n;
  T* sxt = srhs + n;
  T* spart = sxt + n;
  if constexpr (OWN) {
    copy_bytes_async(w0, l + bm, sizeof(T) * m, lane, 32);
    copy_bytes_async(w0 + m, u + bm, sizeof(T) * m, lane, 32);
    copy_bytes_async(w0 + 2 * m, rhovs + rg * m, sizeof(T) * m, lane, 32);
    copy_bytes_async(sz, z + bm, sizeof(T) * m, lane, 32);
    copy_bytes_async(sy, y + bm, sizeof(T) * m, lane, 32);
    copy_bytes_async(sM, Minvs + rg * n * n, sizeof(T) * n * n, lane, 32);
  } else {
    if constexpr (!GLOBAL) {
      copy_async(w0, l + bm, m, lane, 32);
      copy_async(w0 + m, u + bm, m, lane, 32);
      copy_async(w0 + 2 * m, rhovs + rg * m, m, lane, 32);
    }
    copy_in<GLOBAL>(sz, z + bm, m, lane, 32);
    copy_in<GLOBAL>(sy, y + bm, m, lane, 32);
    copy_in<GLOBAL>(sM, Minvs + rg * n * n, n * n, lane, 32);
  }
  __pipeline_commit();
  T xj = T(0), qj = T(0);
  if (lane < n) {
    xj = x[bn + lane];
    qj = q[bn + lane];
  }
  __pipeline_wait_prior(0);
  __syncwarp();

  const int parts = 32 / n;            // row classes of the Aᵀv split
  const int pj = lane % n, pp = lane / n;
  const T one_m_alpha = T(1) - alpha;
  for (int it = 0; it < iters; ++it) {
    // Aᵀv: thread (pp, pj) sums the rows i ≡ pp (mod parts) of column pj
    if (pp < parts) {
      T acc = T(0);
#pragma unroll 4
      for (int i = pp; i < m; i += parts)
        acc += sA[(size_t)i * n + pj] * (srho[i] * sz[i] - sy[i]);
      spart[OWN ? pj * parts + pp : pp * n + pj] = acc;
    }
    __syncwarp();
    if (lane < n) {
      T s = T(0);
      if constexpr (OWN) {
        // the column's partials read ahead of the sum, summed in p order
        const T* sp = spart + lane * parts;
#pragma unroll
        for (int p = 0; p < 32; ++p)
          if (p < parts) s += sp[p];
      } else {
        for (int p = 0; p < parts; ++p) s += spart[p * n + lane];
      }
      srhs[lane] = sigma * xj - qj + s;
    }
    __syncwarp();
    if (lane < n) {
      T s = T(0);
      for (int k = 0; k < n; ++k) s += sM[lane * n + k] * srhs[k];
      sxt[lane] = s;
      xj = alpha * s + one_m_alpha * xj;
    }
    __syncwarp();
    if constexpr (NC > 0) {
      // this thread's rows i0 and i0 + 32 in one pass while both exist
      // (both rows' loads ahead of their stores), then a last row alone
      T xt[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) xt[j] = sxt[j];
      int i0 = lane;
      for (; i0 + 32 < m; i0 += 64) {
        const int i1 = i0 + 32;
        T zt0 = T(0), zt1 = T(0);
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          zt0 += sA[i0 * NC + j] * xt[j];
          zt1 += sA[i1 * NC + j] * xt[j];
        }
        const T z0 = sz[i0], y0 = sy[i0], r0 = srho[i0], lo0 = sl[i0], hi0 = su[i0];
        const T z1 = sz[i1], y1 = sy[i1], r1 = srho[i1], lo1 = sl[i1], hi1 = su[i1];
        const T zp0 = alpha * zt0 + one_m_alpha * z0;
        const T zp1 = alpha * zt1 + one_m_alpha * z1;
        const T zn0 = clip(zp0 + y0 / r0, lo0, hi0);
        const T zn1 = clip(zp1 + y1 / r1, lo1, hi1);
        sy[i0] = y0 + r0 * (zp0 - zn0);
        sz[i0] = zn0;
        sy[i1] = y1 + r1 * (zp1 - zn1);
        sz[i1] = zn1;
      }
      if (i0 < m) {
        T zt = T(0);
#pragma unroll
        for (int j = 0; j < NC; ++j) zt += sA[i0 * NC + j] * xt[j];
        const T zp = alpha * zt + one_m_alpha * sz[i0];
        const T zn = clip(zp + sy[i0] / srho[i0], sl[i0], su[i0]);
        const T yn = sy[i0] + srho[i0] * (zp - zn);
        sy[i0] = yn;
        sz[i0] = zn;
      }
    } else {
      for (int i = lane; i < m; i += 32) {
        T zt = T(0);
#pragma unroll 4
        for (int j = 0; j < n; ++j) zt += sA[(size_t)i * n + j] * sxt[j];
        const T zp = alpha * zt + one_m_alpha * sz[i];
        const T zn = clip(zp + sy[i] / srho[i], sl[i], su[i]);
        const T yn = sy[i] + srho[i] * (zp - zn);
        sy[i] = yn;
        sz[i] = zn;
      }
    }
    __syncwarp();
  }
  if (lane < n) x[bn + lane] = xj;
  for (int i = lane; i < m; i += 32) {
    z[bm + i] = sz[i];
    y[bm + i] = sy[i];
  }
}

// The block's active lanes, from the table: s_lane[0..nact) (shared), by
// thread 0; the caller passes a barrier before reading them.
__device__ __forceinline__ void active_lanes(const int32_t* __restrict__ table,
                                             const uint8_t* __restrict__ active, int width,
                                             int* s_lane, int* s_nact) {
  if (threadIdx.x == 0) {
    int k = 0;
    for (int s = 0; s < width; ++s) {
      const int b = table[(size_t)blockIdx.x * width + s];
      if (b >= 0 && active[b]) s_lane[k++] = b;
    }
    *s_nact = k;
  }
}

// ---- the block's active lanes in step (n > 32, or a small batch) -------------
// W lane slices (the table's width): the block's active lanes fill the
// first nact, and the products run over all W with no per-lane test in the
// inner loops; a slice past nact computes on whatever it holds and is never
// read back (in the global layout it reads the first lane's l, u and ρ).
template <typename T, int W, int LAYOUT>
__global__ void __launch_bounds__(kGroupThreads)
admm_group_kernel(const T* __restrict__ Minvs, const T* __restrict__ A,
                  const int32_t* __restrict__ table, const int32_t* __restrict__ block_ctrl,
                  int width, const int32_t* __restrict__ rung, const T* __restrict__ q,
                  const T* __restrict__ l, const T* __restrict__ u, const T* __restrict__ rhovs,
                  T* __restrict__ x, T* __restrict__ z, T* __restrict__ y,
                  const uint8_t* __restrict__ active, unsigned char* ws, int n, int m,
                  int n_lad, int iters, T sigma, T alpha) {
  constexpr bool GLOBAL = LAYOUT == kGlobal;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int c = block_ctrl[blockIdx.x];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_lane[W];
  __shared__ int s_nact;
  const size_t lane_bytes = group_lane<T>(n, m, GLOBAL);
  T* const A_s = reinterpret_cast<T*>(smem_raw);
  const T* sA = GLOBAL ? A + (size_t)c * m * n : A_s;          // m*n
  unsigned char* lanes0 =
      GLOBAL ? ws + (size_t)blockIdx.x * (W * lane_bytes + group_part<T>(n, W))
             : smem_raw + align16(sizeof(T) * (size_t)m * n);
  T* spart = reinterpret_cast<T*>(lanes0 + W * lane_bytes);     // parts*W*n
  // lane w's slice: (resident only) l, u, ρ, then z, y, v = ρ∘z − y (m
  // each), then x, q, rhs, x̃ (n each), z at offset `oz`; the global layout
  // reads l, u and ρ in place (LO, HI, RH)
  const int oz = GLOBAL ? 0 : 3 * m;
  T* S[W];
#pragma unroll
  for (int w = 0; w < W; ++w) S[w] = reinterpret_cast<T*>(lanes0 + w * lane_bytes);

  active_lanes(table, active, width, s_lane, &s_nact);
  __syncthreads();
  const int nact = s_nact;
  if (nact == 0) return;
  const T* LO[W];
  const T* HI[W];
  const T* RH[W];
  if constexpr (GLOBAL) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const size_t b = s_lane[w < nact ? w : 0];
      LO[w] = l + b * m;
      HI[w] = u + b * m;
      RH[w] = rhovs + ((size_t)c * n_lad + rung[b]) * m;
    }
  } else {
    copy_async(A_s, A + (size_t)c * m * n, m * n, tid, nt);
  }
  for (int w = 0; w < nact; ++w) {
    const size_t b = s_lane[w];
    const size_t rg = (size_t)c * n_lad + rung[b];
    if constexpr (!GLOBAL) {
      copy_async(S[w], l + b * m, m, tid, nt);
      copy_async(S[w] + m, u + b * m, m, tid, nt);
      copy_async(S[w] + 2 * m, rhovs + rg * m, m, tid, nt);
    }
    copy_in<GLOBAL>(S[w] + oz, z + b * m, m, tid, nt);
    copy_in<GLOBAL>(S[w] + oz + m, y + b * m, m, tid, nt);
    copy_in<GLOBAL>(S[w] + oz + 3 * m, x + b * n, n, tid, nt);
    copy_in<GLOBAL>(S[w] + oz + 3 * m + n, q + b * n, n, tid, nt);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int e = tid; e < nact * m; e += nt) {
    const int w = e / m, i = e % m;
    T* L = S[w];
    const T rho = GLOBAL ? RH[w][i] : L[2 * m + i];
    L[oz + 2 * m + i] = rho * L[oz + i] - L[oz + m + i];
  }
  __syncthreads();

  const int parts = group_parts(n);
  const T one_m_alpha = T(1) - alpha;
  for (int it = 0; it < iters; ++it) {
    // Aᵀv over the block's lanes: split (pp, pj) sums the rows
    // i ≡ pp (mod parts) of column pj for every lane, one A read for all;
    // a thread takes one split, or several when n > kGroupThreads
    for (int e = tid; e < parts * n; e += nt) {
      const int pp = e / n, pj = e - pp * n;
      T acc[W];
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] = T(0);
#pragma unroll 2
      for (int i = pp; i < m; i += parts) {
        const T a = sA[(size_t)i * n + pj];
#pragma unroll
        for (int w = 0; w < W; ++w) acc[w] += a * S[w][oz + 2 * m + i];
      }
#pragma unroll
      for (int w = 0; w < W; ++w) spart[((size_t)pp * W + w) * n + pj] = acc[w];
    }
    __syncthreads();
    for (int e = tid; e < nact * n; e += nt) {
      const int w = e / n, j = e % n;
      T* L = S[w];
      T s = T(0);
      for (int p = 0; p < parts; ++p) s += spart[((size_t)p * W + w) * n + j];
      L[oz + 3 * m + 2 * n + j] = sigma * L[oz + 3 * m + j] - L[oz + 3 * m + n + j] + s;
    }
    __syncthreads();
    // x̃ = Minv rhs, each lane with its rung's Minv (read through L1)
    for (int e = tid; e < nact * n; e += nt) {
      const int w = e / n, j = e % n;
      T* L = S[w];
      const T* M = Minvs + ((size_t)c * n_lad + rung[s_lane[w]]) * n * n + (size_t)j * n;
      T s = T(0);
#pragma unroll 4
      for (int k = 0; k < n; ++k) s += __ldg(M + k) * L[oz + 3 * m + 2 * n + k];
      L[oz + 3 * m + 3 * n + j] = s;
      L[oz + 3 * m + j] = alpha * s + one_m_alpha * L[oz + 3 * m + j];
    }
    __syncthreads();
    // A·x̃ and the projection: a thread per row, one A read for all lanes
    for (int i = tid; i < m; i += nt) {
      T acc[W];
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] = T(0);
#pragma unroll 2
      for (int j = 0; j < n; ++j) {
        const T a = sA[(size_t)i * n + j];
#pragma unroll
        for (int w = 0; w < W; ++w) acc[w] += a * S[w][oz + 3 * m + 3 * n + j];
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        T* L = S[w];
        const T rho = GLOBAL ? RH[w][i] : L[2 * m + i], yo = L[oz + m + i];
        const T zp = alpha * acc[w] + one_m_alpha * L[oz + i];
        const T zn = clip(zp + yo / rho, GLOBAL ? LO[w][i] : L[i], GLOBAL ? HI[w][i] : L[m + i]);
        const T yn = yo + rho * (zp - zn);
        L[oz + m + i] = yn;
        L[oz + i] = zn;
        L[oz + 2 * m + i] = rho * zn - yn;
      }
    }
    __syncthreads();
  }
  for (int w = 0; w < nact; ++w) {
    const size_t b = s_lane[w];
    for (int j = tid; j < n; j += nt) x[b * n + j] = S[w][oz + 3 * m + j];
    for (int i = tid; i < m; i += nt) {
      z[b * m + i] = S[w][oz + i];
      y[b * m + i] = S[w][oz + m + i];
    }
  }
}

// ---- the lanes in step, A staged through shared memory (n ≤ kGroupThreads) ---
// Shared memory (staged_bytes): per lane z, y (m each) and x, q, rhs (n
// each); the lanes' ρz − y interleaved by row (vq[i·W + w]) and their x̃
// interleaved by column (xq[j·W + w]), so that one vector load gives a row's
// or a column's values of all W lanes; the parts·W·n partial sums; then
// chunks of rows, each A's rows (padded to 16 bytes, lda apart: the
// wrapper's padded copy `Ap`) followed by the W lanes' l, u and ρ of those
// rows ([k·W + w][row]): the resident chunk (rows [0, rows), loaded once)
// and a ring of `stages` chunks of `tile` rows for the rows [rows, m),
// which stream once a pass.  A pass over a chunk is phase A, a thread a row
// holding W sums (the projection and the updates of z, y, ρz − y; in pass
// 0 only ρz − y), a barrier, then phase B: thread (pp, pj) < parts·n adds
// the chunk's rows i ≡ pp (mod parts) of column pj to the next sweep's Aᵀv
// sums of the W lanes, held in registers over the pass.
template <typename T, int W>
struct alignas(sizeof(T) * W < 16 ? sizeof(T) * W : 16) Pack {
  T v[W];
};

template <typename T, int W>
__global__ void __launch_bounds__(kGroupThreads)
admm_staged_kernel(const T* __restrict__ Minvs, const T* __restrict__ Ap,
                   const int32_t* __restrict__ table, const int32_t* __restrict__ block_ctrl,
                   int width, const int32_t* __restrict__ rung, const T* __restrict__ q,
                   const T* __restrict__ l, const T* __restrict__ u,
                   const T* __restrict__ rhovs, T* __restrict__ x, T* __restrict__ z,
                   T* __restrict__ y, const uint8_t* __restrict__ active, int n, int m,
                   int n_lad, int iters, T sigma, T alpha, int rows, int tile, int stages) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int c = block_ctrl[blockIdx.x];
  const int lda = row_stride<T>(n);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_lane[W];
  __shared__ size_t s_rg[W];
  __shared__ int s_nact;
  unsigned char* p = smem_raw;
  const size_t lane_bytes = staged_lane<T>(n, m);
  T* S[W];                                   // lane w: z, y, x, q, rhs
#pragma unroll
  for (int w = 0; w < W; ++w) S[w] = reinterpret_cast<T*>(p + w * lane_bytes);
  p += W * lane_bytes;
  T* vq = reinterpret_cast<T*>(p);           // m*W  ρz − y, by row
  p += align16(sizeof(T) * (size_t)m * W);
  T* xq = reinterpret_cast<T*>(p);           // n*W  x̃, by column
  p += align16(sizeof(T) * (size_t)n * W);
  T* spart = reinterpret_cast<T*>(p);        // parts*W*n
  p += group_part<T>(n, W);
  T* res = reinterpret_cast<T*>(p);          // the resident chunk
  p += staged_chunk<T>(n, W, rows);
  T* ring = reinterpret_cast<T*>(p);         // `stages` chunks of `tile` rows
  const size_t stage = staged_chunk<T>(n, W, tile) / sizeof(T);
  const T* Ac = Ap + (size_t)c * m * lda;

  if (tid == 0) {
    int k = 0;
    for (int s = 0; s < width; ++s) {
      const int b = table[(size_t)blockIdx.x * width + s];
      if (b >= 0 && active[b]) {
        s_lane[k] = b;
        s_rg[k] = (size_t)c * n_lad + rung[b];
        ++k;
      }
    }
    s_nact = k;
  }
  __syncthreads();
  const int nact = s_nact;
  if (nact == 0) return;
  // rows [r0, r0 + nr) of A and of the lanes' l, u, ρ into a chunk of `cap`
  // rows (asynchronous copies, 16 bytes at a time for A)
  auto load = [&](T* buf, int cap, int r0, int nr) {
    const int4* src = reinterpret_cast<const int4*>(Ac + (size_t)r0 * lda);
    int4* dst = reinterpret_cast<int4*>(buf);
    const int n16 = (int)(sizeof(T) * (size_t)nr * lda / 16);
    for (int e = tid; e < n16; e += nt) __pipeline_memcpy_async(dst + e, src + e, 16);
    T* lur = buf + align16(sizeof(T) * (size_t)cap * lda) / sizeof(T);
    for (int w = 0; w < nact; ++w) {
      const size_t bm = (size_t)s_lane[w] * m + r0;
      copy_async(lur + (size_t)w * cap, l + bm, nr, tid, nt);
      copy_async(lur + (size_t)(W + w) * cap, u + bm, nr, tid, nt);
      copy_async(lur + (size_t)(2 * W + w) * cap, rhovs + s_rg[w] * m + r0, nr, tid, nt);
    }
  };
  for (int w = 0; w < nact; ++w) {
    const size_t b = s_lane[w];
    copy_async(S[w], z + b * m, m, tid, nt);
    copy_async(S[w] + m, y + b * m, m, tid, nt);
    copy_async(S[w] + 2 * m, x + b * n, n, tid, nt);
    copy_async(S[w] + 2 * m + n, q + b * n, n, tid, nt);
  }
  if (rows > 0) load(res, rows, 0, rows);
  __pipeline_commit();
  // the streamed chunks: the g-th of the launch is tile g % n_tiles of pass
  // g / n_tiles, in stage g % stages; one commit a chunk, empty past the end
  const int streamed = m - rows;
  const int n_tiles = tile > 0 ? (streamed + tile - 1) / tile : 0;
  const int total = n_tiles * (iters + 1);
  auto issue = [&](int g) {
    if (g < total) {
      const int r0 = rows + (g % n_tiles) * tile;
      load(ring + (size_t)(g % stages) * stage, tile, r0, min(tile, m - r0));
    }
    __pipeline_commit();
  };
  for (int g = 0; g < stages - 1; ++g) issue(g);

  const int parts = group_parts(n);
  const bool splits = tid < parts * n;
  const int pp = tid / n, pj = tid - pp * n;
  const T one_m_alpha = T(1) - alpha;
  constexpr int V = 16 / sizeof(T);          // A's elements in 16 bytes
  T acc[W];
  // phase A on a chunk `buf` of `cap` rows holding rows [r0, r0 + nr)
  auto phase_a = [&](const T* buf, int cap, int r0, int nr, bool sweep) {
    const T* lur = buf + align16(sizeof(T) * (size_t)cap * lda) / sizeof(T);
    for (int i = tid; i < nr; i += nt) {
      const int r = r0 + i;
      T ax[W];
#pragma unroll
      for (int w = 0; w < W; ++w) ax[w] = T(0);
      if (sweep) {
        const T* ar = buf + (size_t)i * lda;
        int j = 0;
        for (; j + V <= n; j += V) {
          const Pack<T, V> a = *reinterpret_cast<const Pack<T, V>*>(ar + j);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const Pack<T, W> xv = *reinterpret_cast<const Pack<T, W>*>(xq + (size_t)(j + k) * W);
#pragma unroll
            for (int w = 0; w < W; ++w) ax[w] += a.v[k] * xv.v[w];
          }
        }
        for (; j < n; ++j) {
          const T a = ar[j];
          const Pack<T, W> xv = *reinterpret_cast<const Pack<T, W>*>(xq + (size_t)j * W);
#pragma unroll
          for (int w = 0; w < W; ++w) ax[w] += a * xv.v[w];
        }
      }
      Pack<T, W> vv;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        vv.v[w] = T(0);
        if (w < nact) {
          T* L = S[w];
          const T lo = lur[(size_t)w * cap + i], hi = lur[(size_t)(W + w) * cap + i];
          const T rho = lur[(size_t)(2 * W + w) * cap + i];
          vv.v[w] = sweep ? row_step(ax[w], alpha, one_m_alpha, lo, hi, rho, L + r, L + m + r)
                          : rho * L[r] - L[m + r];
        }
      }
      *reinterpret_cast<Pack<T, W>*>(vq + (size_t)r * W) = vv;
    }
  };
  // phase B on the chunk's A rows
  auto phase_b = [&](const T* buf, int r0, int nr) {
    if (!splits) return;
    int i = r0 + (pp - r0 % parts + parts) % parts;   // the first i ≥ r0, i ≡ pp
#pragma unroll 4
    for (; i < r0 + nr; i += parts) {
      const T a = buf[(size_t)(i - r0) * lda + pj];
      const Pack<T, W> vv = *reinterpret_cast<const Pack<T, W>*>(vq + (size_t)i * W);
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] += a * vv.v[w];
    }
  };

  __pipeline_wait_prior(stages - 1);   // the lanes and the resident chunk
  __syncthreads();
  int g = 0;
  for (int pass = 0; pass <= iters; ++pass) {
    const bool sweep = pass > 0, atv = pass < iters;
    if (sweep) {
      // rhs and x̃ of this sweep from the partial sums of the last pass
      for (int e = tid; e < nact * n; e += nt) {
        const int w = e / n, j = e % n;
        T* L = S[w];
        T s = T(0);
        for (int p2 = 0; p2 < parts; ++p2) s += spart[((size_t)p2 * W + w) * n + j];
        L[2 * m + 2 * n + j] = sigma * L[2 * m + j] - L[2 * m + n + j] + s;
      }
      __syncthreads();
      for (int e = tid; e < nact * n; e += nt) {
        const int w = e / n, j = e % n;
        T* L = S[w];
        const T* M = Minvs + s_rg[w] * n * n + (size_t)j * n;
        T s = T(0);
#pragma unroll 4
        for (int k = 0; k < n; ++k) s += __ldg(M + k) * L[2 * m + 2 * n + k];
        xq[(size_t)j * W + w] = s;
        L[2 * m + j] = alpha * s + one_m_alpha * L[2 * m + j];
      }
      __syncthreads();
    }
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = T(0);
    if (rows > 0) {
      phase_a(res, rows, 0, rows, sweep);
      if (atv) {
        __syncthreads();
        phase_b(res, 0, rows);
      }
    }
    for (int k = 0; k < n_tiles; ++k, ++g) {
      __pipeline_wait_prior(stages - 2);
      __syncthreads();          // chunk g landed; every thread is done with chunk g − 1
      issue(g + stages - 1);    // into chunk g − 1's stage
      const int r0 = rows + k * tile;
      const T* buf = ring + (size_t)(g % stages) * stage;
      phase_a(buf, tile, r0, min(tile, m - r0), sweep);
      if (atv) {
        __syncthreads();
        phase_b(buf, r0, min(tile, m - r0));
      }
    }
    if (atv && splits) {
#pragma unroll
      for (int w = 0; w < W; ++w) spart[((size_t)pp * W + w) * n + pj] = acc[w];
    }
    __syncthreads();
  }
  for (int w = 0; w < nact; ++w) {
    const size_t b = s_lane[w];
    for (int j = tid; j < n; j += nt) x[b * n + j] = S[w][2 * m + j];
    for (int i = tid; i < m; i += nt) {
      z[b * m + i] = S[w][i];
      y[b * m + i] = S[w][m + i];
    }
  }
}

// the instantiation a launch of this variant, table width, layout and
// geometry (`own`: per-lane blocks) takes
template <typename T>
const void* kernel_for(int grouped, int width, int layout, int own, int n) {
  if (own) {
    if (grouped || layout != kResident) return nullptr;
    return n == 2   ? (const void*)admm_warp_kernel<T, kResident, true, 2>
           : n == 3 ? (const void*)admm_warp_kernel<T, kResident, true, 3>
                    : (const void*)admm_warp_kernel<T, kResident, true>;
  }
  if (layout == kStaged) {
    if (!grouped) return nullptr;
    if (width <= 1) return (const void*)admm_staged_kernel<T, 1>;
    if (width <= 2) return (const void*)admm_staged_kernel<T, 2>;
    return (const void*)admm_staged_kernel<T, kStagedGroup>;
  }
  const bool global = layout == kGlobal;
  if (!grouped) return global ? (const void*)admm_warp_kernel<T, kGlobal, false>
                              : (const void*)admm_warp_kernel<T, kResident, false>;
  if (width <= 1) return global ? (const void*)admm_group_kernel<T, 1, kGlobal>
                                : (const void*)admm_group_kernel<T, 1, kResident>;
  return global ? (const void*)admm_group_kernel<T, 2, kGlobal>
                : (const void*)admm_group_kernel<T, 2, kResident>;
}

template <typename T>
int launch(const void* Minvs, const void* A, const void* table, const void* block_ctrl,
           const void* rung, const void* q, const void* l, const void* u, const void* rhovs,
           void* x, void* z, void* y, const void* active, void* ws, int n_blocks, int width,
           int warps, int grouped, int own, int n, int m, int n_lad, int iters, int smem_bytes,
           int layout, int rows, int tile, int stages, double sigma, double alpha,
           void* stream) {
  if (n_blocks <= 0 || iters <= 0) return 0;
  if (n < 1 || m < 1 || n_lad < 1 || width < 1) return (int)cudaErrorInvalidValue;
  if (!grouped && n > 32) return (int)cudaErrorInvalidValue;
  if (layout < kResident || layout > kStaged) return (int)cudaErrorInvalidValue;
  if (own && (grouped || layout != kResident || width != warps)) return (int)cudaErrorInvalidValue;
  const bool by_warp = !grouped;
  size_t need;
  int threads;
  if (layout == kStaged) {
    // the lanes in step, one split a thread; rows and the ring cover A
    if (by_warp || width > kStagedGroup || n > kGroupThreads || rows < 0 || rows > m ||
        stages < 2 || tile < 0 || (rows < m && tile < 1))
      return (int)cudaErrorInvalidValue;
    // the instantiation's lane slices: the table's width rounded up to 1, 2, 4
    need = staged_bytes<T>(n, m, width <= 1 ? 1 : (width <= 2 ? 2 : kStagedGroup), rows, tile,
                           stages);
    threads = kGroupThreads;
  } else if (by_warp) {
    if (warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
    need = own ? warps * own_area<T>(n, m)
               : align16(sizeof(T) * (size_t)m * n) + warps * warp_slice<T>(n, m, false);
    threads = 32 * warps;
  } else {
    if (width > kGroup) return (int)cudaErrorInvalidValue;
    need = align16(sizeof(T) * (size_t)m * n) + width * group_lane<T>(n, m, false) +
           group_part<T>(n, width);
    threads = kGroupThreads;
  }
  if (layout == kGlobal) need = 0;
  if ((size_t)smem_bytes != need || (layout == kGlobal && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const void* fn = kernel_for<T>(grouped, width, layout, own, n);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto Mv = static_cast<const T*>(Minvs);
  const auto Av = static_cast<const T*>(A);
  const auto tb = static_cast<const int32_t*>(table);
  const auto bc = static_cast<const int32_t*>(block_ctrl);
  const auto rgv = static_cast<const int32_t*>(rung);
  const auto qv = static_cast<const T*>(q);
  const auto lv = static_cast<const T*>(l);
  const auto uv = static_cast<const T*>(u);
  const auto rv = static_cast<const T*>(rhovs);
  const auto act = static_cast<const uint8_t*>(active);
  if (layout == kStaged) {
    using Kern = void (*)(const T*, const T*, const int32_t*, const int32_t*, int,
                          const int32_t*, const T*, const T*, const T*, const T*, T*, T*, T*,
                          const uint8_t*, int, int, int, int, T, T, int, int, int);
    auto kern = reinterpret_cast<Kern>(const_cast<void*>(fn));
    kern<<<n_blocks, threads, smem_bytes, s>>>(
        Mv, Av, tb, bc, width, rgv, qv, lv, uv, rv, static_cast<T*>(x), static_cast<T*>(z),
        static_cast<T*>(y), act, n, m, n_lad, iters, static_cast<T>(sigma),
        static_cast<T>(alpha), rows, tile, stages);
  } else {
    using Kern = void (*)(const T*, const T*, const int32_t*, const int32_t*, int,
                          const int32_t*, const T*, const T*, const T*, const T*, T*, T*, T*,
                          const uint8_t*, unsigned char*, int, int, int, int, T, T);
    auto kern = reinterpret_cast<Kern>(const_cast<void*>(fn));
    kern<<<n_blocks, threads, smem_bytes, s>>>(
        Mv, Av, tb, bc, width, rgv, qv, lv, uv, rv, static_cast<T*>(x), static_cast<T*>(z),
        static_cast<T*>(y), act, static_cast<unsigned char*>(ws), n, m, n_lad, iters,
        static_cast<T>(sigma), static_cast<T>(alpha));
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define MPC_ADMM_ENTRY(NAME, T)                                                               \
  extern "C" int NAME(const void* Minvs, const void* A, const void* table,                    \
                      const void* block_ctrl, const void* rung, const void* q, const void* l, \
                      const void* u, const void* rhovs, void* x, void* z, void* y,            \
                      const void* active, void* ws, int n_blocks, int width, int warps,       \
                      int grouped, int own, int n, int m, int n_lad, int iters,               \
                      int smem_bytes, int layout, int rows, int tile, int stages,             \
                      double sigma, double alpha, void* stream) {                             \
    return launch<T>(Minvs, A, table, block_ctrl, rung, q, l, u, rhovs, x, z, y, active, ws,  \
                     n_blocks, width, warps, grouped, own, n, m, n_lad, iters, smem_bytes,    \
                     layout, rows, tile, stages, sigma, alpha, stream);                       \
  }

MPC_ADMM_ENTRY(mpc_admm_sweep_f32, float)
MPC_ADMM_ENTRY(mpc_admm_sweep_f64, double)

// Blocks of `threads` threads and `smem_bytes` of shared memory resident on
// one SM (the runtime's occupancy calculator) for a variant, a table `width`,
// a layout (0: resident, 1: global, 2: staged) and a geometry: one warp a
// lane, or (`grouped`) the lanes in step; `own` the per-lane blocks (at n
// variables).  Returns −1 on an error.
extern "C" int mpc_admm_blocks_per_sm(int f64, int layout, int grouped, int width, int threads,
                                      int smem_bytes, int own, int n) {
  const void* fn = f64 ? kernel_for<double>(grouped, width, layout, own, n)
                       : kernel_for<float>(grouped, width, layout, own, n);
  if (fn == nullptr) return -1;
  // as a launch does: raise the kernel's shared-memory limit above the default
  // 48 KB only (a lower setting would refuse a later, larger launch)
  if (smem_bytes > 48 * 1024 &&
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes) !=
          cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem_bytes) !=
      cudaSuccess)
    return -1;
  return blocks;
}
