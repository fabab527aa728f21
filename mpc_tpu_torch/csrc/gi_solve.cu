// Per-lane Goldfarb–Idnani dual active-set QP solve, for Hopper (sm_90a).
//
// Replaces, for the GPU, the TPU work of one GI solve per lane:
//   * docs/pallas_gi_experiment.py:84 `kmv`, the Pallas kernel of the violation
//     scan A·x over a lane-major (m, n, B) table;
//   * the XLA loop bodies that carry it, mpc_tpu/ops/qp_active.py:339
//     (`warm_body`: warm-row insert by bordering, the KKT jump, wrong-sign
//     drops) and :407 (`body`: scan, fused select + pivot step, the unified
//     rank-one update of Ginv, slot-cap overflow, f32 anti-cycling detectors,
//     the one-shot cold restart, the infeasibility certificate).
// The plain torch version of the same contract is
// mpc_tpu_torch/ops/gi_kernel.py::gi_solve_reference.
//
// Layout: one thread block per group of lanes of ONE controller (the table of
// utils/lanes.py::lane_blocks, at most 32 lanes and ⌈B/SMs⌉ rounded up to a
// power of two, so a small batch still spreads over the SMs), one warp per
// lane, up to 16 warps.  The block copies the controller's A (data type TD)
// and P⁻¹ (slot type TS) into shared memory once with asynchronous copies
// (cp.async), computes the row norms ‖aᵢ‖ once, and passes one
// __syncthreads(); from then on every warp runs a lane's whole solve on its
// own and takes the block's next lane from a counter in shared memory when
// it is done (a persistent block: no warp waits for the block's slowest
// lane).  A lane's l, u, Ginv, x, λ, the slot table Aact and its slot-space
// vectors live in the warp's own slice of shared memory.
//
// A second layout, "global", is the last resort for QPs whose one warp's
// block would not fit the SM's shared memory even without A
// (ops/gi_kernel.py::launch_geometry).  It is the same kernel (LAYOUT ==
// kGlobal): A, P⁻¹, l and u are read where they lie in device memory (A's
// rows unpadded, lda = n, so loaded one element at a time), each block
// computes the row norms into its own slice of a workspace the wrapper
// allocates, and each lane's slice (a warp's slice of shared memory without
// l and u) lies in that workspace at the lane's index, so no two lanes of a
// block share one.  Shared memory holds only the block's lane counter.
//
// A third layout, "split", takes QPs whose A does not fit beside the warps
// but whose small state does: the 8x8 fleet at Hp=60 (n=33, m=2017, f32:
// A is 266 KB, a warp's state without l and u 4.9 KB).  The warps pivot on
// their own, so A cannot stream through one ring for the block; the scan,
// bounded by the latency of its loads a pivot, reads A's rows as fast as
// each part allows instead.  P⁻¹, the row norms and every warp's state stay
// in shared memory; A's leading `rows` rows (as many as the rest leaves
// room for) sit there padded to 16 bytes, so the scan reads them 16 bytes
// at a time; the scan reads the other rows from a column-major copy of
// them (n × (m − rows), made by the wrapper), where the 32 threads of a
// warp load 128 contiguous bytes at each column; pivot rows come from A
// where it lies.  l and u are read in place.
//
// A per-lane geometry (template parameter OWN, resident layout) takes a
// batch where every lane is its own controller (n_d = B: SLMPC, NonLinMPC,
// the MHE fleets' per-lane windows), which the grouping above would run a
// lane a block, each block waiting on its own serial loads (A and P⁻¹,
// a block barrier, the row norms, another barrier, then the lane's state).
// There, up to 16 lanes share a block, one a warp, and each warp copies its
// lane's P⁻¹ and A (into its own area, A's rows padded to 16 bytes, in 16-
// or 8-byte pieces where the rows allow) in the same asynchronous group as
// the lane's l, u and Ginv, waits once, and computes the lane's row norms
// itself; no block barrier follows the lane counter's set-up.  A second lane
// map, `pmap`, serves lanes that share A but not P⁻¹ (the MHE fleet's NaN
// variant): the blocks group the lanes by A's controller and each warp copies
// its lane's P⁻¹ into its slice (resident) or reads it where it lies.
//
// Each row's aᵢ·x is one thread's sum in j order in every layout, and the
// scan's argmax order (NaN first, then larger, ties to the lower row) is
// total, so any split of the rows between threads and storage picks the
// same winner with the same aᵢ·x: the three layouts return the same bits.
//
// Warp-synchronous solve: the lane's scalar carry (it, done, p, the step
// lengths, every pivot decision) is held by all 32 threads of the warp in
// registers, each computing it from the same shared vectors, so it is the
// same in every thread and no value is broadcast through shared memory.  The
// vector phases stride the 32 threads over rows, variables or slots (two
// outputs a thread in one pass above n = 32) and end in __syncwarp(); the
// scan takes up to four rows a thread at once and its argmax is a butterfly
// of warp shuffles that leaves the winner (value, row, aᵢ·x) in every thread.
// There is no block barrier inside the warm or the main loop, and each warp
// leaves on its own `done` or cap.  Mixed precision is the reference's
// (qp_active.py:187-204): the scan, its scale and eps_d in the data type TD;
// x, λ, P⁻¹, Ginv and every pivot decision in the slot type TS.  Each row's
// aᵢ·x is one thread's sum in j order, every other sum keeps its order, and
// every argmax/argmin breaks ties toward the lower index with NaN as the
// extreme, as jnp.argmax/argmin do: on an H100 the kernel returns the same
// bits as the one-block-per-lane design it replaces.
//
// What bounds it on this card (NVIDIA H100 SXM: 3.35 TB/s, 67 TFLOP/s f32):
// at headline-GI (B=4096, n=5, m=101) the bytes, ~6.5 MB read and written,
// ~2 µs; at large-GI (n=33, m=577, 8 slots, f32) the scan's ~2mn flops per
// pivot over the pivots a run takes, ~11 µs.  The kernel is far from either:
// per pivot a lane runs a few dependent chains through shared memory (the
// scan, P⁻¹aₚ, the Gram step, the x update), so it is bound by latency, and
// a launch lasts as long as its slowest lanes (31 pivots at large-GI against
// a mean of 3.7).  The design answers with residency and sharing: A is read
// from device memory once per block instead of once per lane, and 32 lanes
// are in flight per SM at the headline shapes (2 blocks of 16 warps, 64
// registers a thread, some spill) and 16 at large-GI (one block of 16 warps
// in 202 KB of shared memory, 128 registers), against 2 in the one-block-per-
// lane design (206–211 registers).  The tensor cores are not used for the
// scan: each lane pivots on its own private x, so the products are
// matrix-vector, not matrix-matrix, and TF32 would move the f32 scan's argmax.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 16;     // ops/_build.py::MAX_WARPS
// layouts, as ops/_build.py::LAYOUT_CODE numbers them
constexpr int kResident = 0, kGlobal = 1, kSplit = 2;
// geometries of the resident layout: the lanes of a controller a block (P⁻¹
// and A once a block), the same with P⁻¹ a lane in its warp's slice (an A
// map), and per-lane blocks (every lane its own P⁻¹ and A in its warp's area)
constexpr int kShared = 0, kLaneP = 1, kOwn = 2;
constexpr int kSmemPerSM = 228 * 1024;   // shared memory of one SM
constexpr int kSmemPerBlock = 1024;      // reserved by the runtime per block
constexpr unsigned kFull = 0xffffffffu;
constexpr double kBig = 1e18;     // ops.qp._BIG: bounds beyond are infinite
constexpr double kTiny = 1e-30;

// jnp.maximum / jnp.minimum: NaN propagates
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) { return (isnan(a) || a > b) ? a : b; }
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) { return (isnan(a) || a < b) ? a : b; }

// (a, ia) ranks before (b, ib) for an argmax: NaN first, then larger, then
// the lower index
template <typename T>
__device__ __forceinline__ bool before_max(T a, int ia, T b, int ib) {
  if (isnan(a)) return !isnan(b) || ia < ib;
  if (isnan(b)) return false;
  return a > b || (a == b && ia < ib);
}

// the same for an argmin
template <typename T>
__device__ __forceinline__ bool before_min(T a, int ia, T b, int ib) {
  if (isnan(a)) return !isnan(b) || ia < ib;
  if (isnan(b)) return false;
  return a < b || (a == b && ia < ib);
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

// A's rows in shared memory start on 16 bytes: n rounded up to 4 floats or 2
// doubles, so the scan reads a row and x four floats or two doubles at a time
template <typename TD>
__host__ __device__ constexpr int row_stride(int n) {
  return (n + int(16 / sizeof(TD)) - 1) / int(16 / sizeof(TD)) * int(16 / sizeof(TD));
}

// Shared memory of the block, in the order of ops/gi_kernel.py::smem_bytes
// and split_bytes: the controller's part (P⁻¹ unless P⁻¹ comes a lane, A's
// first `rows` rows, the m row norms; rows = m in the resident layout),
// then one slice per warp, which holds l and u in the resident layout only
// and, first, the lane's P⁻¹ where P⁻¹ comes a lane (`pw`) in the resident
// layout.  A per-lane block (OWN, ops/gi_kernel.py::own_bytes) is one area
// a warp: its lane's controller part (P⁻¹, A, the row norms) and its slice.
// The global layout's workspace (ops/gi_kernel.py::workspace_bytes): the row
// norms of each block, then one slice without l and u per lane.
template <typename TD, typename TS>
__host__ __device__ size_t ctrl_bytes(int n, int rows, int m, bool pw) {
  return (pw ? 0 : align16(sizeof(TS) * n * n)) +
         sizeof(TD) * (size_t)rows * row_stride<TD>(n) + align16(sizeof(TD) * m);
}
template <typename TD, typename TS>
__host__ __device__ size_t warp_bytes(int n, int m, int ns, bool lu, bool pw) {
  return (pw ? align16(sizeof(TS) * n * n) : 0) +
         align16(sizeof(TS) * (ns * ns + 5 * n + 6 * ns)) +
         align16(sizeof(TD) * (row_stride<TD>(n) + (lu ? 2 * (size_t)m : 0) + ns * n)) +
         align16(sizeof(int) * 3 * ns);
}
template <typename TD, typename TS>
__host__ __device__ size_t own_bytes(int n, int m, int ns) {
  return ctrl_bytes<TD, TS>(n, m, m, false) + warp_bytes<TD, TS>(n, m, ns, true, false);
}

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

// A's m rows of n (unpadded, where `src` lies) into rows lda apart, as
// asynchronous copies of whole 16- or 8-byte pieces of a row where the rows
// allow it, else an element at a time; (row, piece) advance by the warp's
// stride with no division in the loop
template <typename TD>
__device__ __forceinline__ void copy_rows_async(TD* dst, int lda, const TD* src, int m, int n,
                                                int lane) {
  const int row_b = n * (int)sizeof(TD);
  const uintptr_t base = reinterpret_cast<uintptr_t>(src);
  const int w = ((row_b | (int)(base & 15)) & 15) == 0 ? 16
                : ((row_b | (int)(base & 7)) & 7) == 0 ? 8 : (int)sizeof(TD);
  const int per = row_b / w;              // pieces a row
  const int step_r = 32 / per, step_p = 32 % per;
  int r = lane / per, k = lane - r * per;
  const char* g = reinterpret_cast<const char*>(src);
  char* d = reinterpret_cast<char*>(dst);
  while (r < m) {
    __pipeline_memcpy_async(d + ((size_t)r * lda * sizeof(TD) + (size_t)k * w),
                            g + ((size_t)r * row_b + (size_t)k * w), w);
    r += step_r;
    k += step_p;
    if (k >= per) {
      k -= per;
      ++r;
    }
  }
}

// A's rows as a lane reads them: rows [0, nres) at `res`, lda apart, the
// others row-major where A lies (`glob`, n apart) for the single-row reads;
// the scan reads rows [nres, m) from `cm`, a column-major copy of them
// (mr = m − nres apart).  Resident: A in shared memory, nres = m; global:
// res = glob, lda = n, nres = m.
template <typename TD>
struct RowsOf {
  const TD* res;
  int lda, nres;
  const TD* glob;
  int n;
  const TD* cm;
  int mr;
  __device__ __forceinline__ const TD* row(int r) const {
    return r < nres ? res + (size_t)r * lda : glob + (size_t)r * n;
  }
};

// aᵢ·x of R rows at once in the data type: each row one thread's sum in j
// order (the same multiply-adds, in the same order, as one row and one
// element at a time), the rows' chains interleaved so that a thread has R
// independent multiply-adds in flight; with VEC (rows on 16 bytes) 16 bytes
// of each row and of x are read at a time, else one element
template <int R, bool VEC, typename TD>
__device__ __forceinline__ void rows_dot(const TD* __restrict__ A, int lda, const int* r,
                                         const TD* x, int n, TD* ax) {
  const TD* a[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    a[k] = A + (size_t)r[k] * lda;
    ax[k] = TD(0);
  }
  int j = 0;
  if constexpr (VEC && sizeof(TD) == 4) {
    for (; j + 4 <= n; j += 4) {
      const float4 x4 = *reinterpret_cast<const float4*>(x + j);
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float4 a4 = *reinterpret_cast<const float4*>(a[k] + j);
        ax[k] += a4.x * x4.x;
        ax[k] += a4.y * x4.y;
        ax[k] += a4.z * x4.z;
        ax[k] += a4.w * x4.w;
      }
    }
  } else if constexpr (VEC) {
    for (; j + 2 <= n; j += 2) {
      const double2 x2 = *reinterpret_cast<const double2*>(x + j);
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const double2 a2 = *reinterpret_cast<const double2*>(a[k] + j);
        ax[k] += a2.x * x2.x;
        ax[k] += a2.y * x2.y;
      }
    }
  }
  for (; j < n; ++j) {
    const TD xj = x[j];
#pragma unroll
    for (int k = 0; k < R; ++k) ax[k] += a[k][j] * xj;
  }
}

// aᵢ·x of R rows of a column-major table (`cm`, ld apart; row r[k] − lo):
// each row one thread's sum in j order, as rows_dot; at each j the 32
// threads of a warp read neighbouring rows
template <int R, typename TD>
__device__ __forceinline__ void cols_dot(const TD* __restrict__ cm, int ld, int lo, const int* r,
                                         const TD* x, int n, TD* ax) {
#pragma unroll
  for (int k = 0; k < R; ++k) ax[k] = TD(0);
  for (int j = 0; j < n; ++j) {
    const TD xj = x[j];
    const TD* c = cm + (size_t)j * ld - lo;
#pragma unroll
    for (int k = 0; k < R; ++k) ax[k] += c[r[k]] * xj;
  }
}

// The violation scan (the work of kmv) over the rows lo + lane, lo + lane +
// 32, … < hi, R at a time (from `A`, lda apart, or with CM from the
// column-major `A`, lda = its leading dimension, row i at i − lo): each
// thread's best (scaled violation, row, aᵢ·x), NaN first, ties to the lower
// row.  Past hi a row index is clamped to hi − 1, whose repeat cannot change
// the argmax.  The lane's vectors are not __restrict__: in the global layout
// they lie in device memory that the kernel writes, and must not be read
// through the non-coherent cache.
template <int R, bool VEC, bool CM, typename TD>
__device__ __forceinline__ void scan_rows(const TD* __restrict__ A, int lda, int lo, int hi,
                                          const TD* sxd, const TD* sl, const TD* su,
                                          const TD* srn, TD xnorm, int n, int lane, TD& best,
                                          int& best_i, TD& best_ax) {
  const TD inf_d = static_cast<TD>(INFINITY);
  const TD big = static_cast<TD>(kBig);
  for (int i0 = lo + lane; i0 < hi; i0 += 32 * R) {
    int r[R];
    TD ax[R];
#pragma unroll
    for (int k = 0; k < R; ++k) r[k] = min(i0 + 32 * k, hi - 1);
    if constexpr (CM)
      cols_dot<R>(A, lda, lo, r, sxd, n, ax);
    else
      rows_dot<R, VEC>(A, lda, r, sxd, n, ax);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = r[k];
      const TD vl = sl[i] > -big ? sl[i] - ax[k] : -inf_d;
      const TD vu = su[i] < big ? ax[k] - su[i] : -inf_d;
      const TD scale = nan_max(srn[i] * xnorm, TD(1));
      const TD v = nan_max(vl, vu) / scale;
      if (before_max(v, i, best, best_i)) { best = v; best_i = i; best_ax = ax[k]; }
    }
  }
}

// the scan over rows [lo, hi), four rows a thread at once above 64 rows
template <bool VEC, bool CM, typename TD>
__device__ __forceinline__ void scan_range(const TD* __restrict__ A, int lda, int lo, int hi,
                                           const TD* sxd, const TD* sl, const TD* su,
                                           const TD* srn, TD xnorm, int n, int lane, TD& best,
                                           int& best_i, TD& best_ax) {
  const int rows = hi - lo;
  if (rows > 64)
    scan_rows<4, VEC, CM>(A, lda, lo, hi, sxd, sl, su, srn, xnorm, n, lane, best, best_i,
                          best_ax);
  else if (rows > 32)
    scan_rows<2, VEC, CM>(A, lda, lo, hi, sxd, sl, su, srn, xnorm, n, lane, best, best_i,
                          best_ax);
  else if (rows > 0)
    scan_rows<1, VEC, CM>(A, lda, lo, hi, sxd, sl, su, srn, xnorm, n, lane, best, best_i,
                          best_ax);
}

// out(k, Σ_{j<len} f(k, j)) for every k < rows: a thread per k, each sum in
// j order.  Above 32 outputs a thread runs k and k + 32 in one pass, so that
// the two chains overlap (the second index clamped, its sum then dropped).
template <typename T, typename F, typename O>
__device__ __forceinline__ void per_row(int lane, int rows, int len, F f, O out) {
  if (rows <= 32) {
    if (lane < rows) {
      T s = T(0);
#pragma unroll 4
      for (int j = 0; j < len; ++j) s += f(lane, j);
      out(lane, s);
    }
    return;
  }
  for (int k0 = lane; k0 < rows; k0 += 64) {
    const int k1 = min(k0 + 32, rows - 1);
    T s0 = T(0), s1 = T(0);
#pragma unroll 4
    for (int j = 0; j < len; ++j) {
      s0 += f(k0, j);
      s1 += f(k1, j);
    }
    out(k0, s0);
    if (k0 + 32 < rows) out(k1, s1);
  }
}

// One lane's whole solve, run by one warp, in the slice ``wsm`` (shared
// memory, or the lane's slice of the workspace in the global layout) with
// A's rows read through ``A``.  Every thread of the warp returns with the
// same (it, done && feas) and the lane's state written back.  The warp may
// have issued asynchronous copies of the lane's P⁻¹ (LATE: x_un waits for
// them) and of its A (OWN: the warp then computes the row norms into
// ``srn``) without a commit: the lane's loads are one group, one wait.
template <typename TD, typename TS, int LAYOUT, bool OWN, bool LATE>
__device__ void solve_lane(int b, unsigned char* wsm, const RowsOf<TD> A,
                           TD* srn, const TS* __restrict__ sP,
                           const TD* __restrict__ q, const TD* __restrict__ l,
                           const TD* __restrict__ u, int32_t* __restrict__ idx_g,
                           int32_t* __restrict__ side_g, uint8_t* __restrict__ vmask_g,
                           TS* __restrict__ Ginv_g, const int32_t* __restrict__ widx_g,
                           const int32_t* __restrict__ wside_g, const int32_t* __restrict__ wcnt_g,
                           const int32_t* __restrict__ max_it_g, TS* __restrict__ x_out,
                           TS* __restrict__ lam_out, int32_t* __restrict__ it_out,
                           uint8_t* __restrict__ conv_out, int n, int m, int ns, int warm,
                           double tol) {
  constexpr bool WS = LAYOUT == kGlobal;   // the slice lies in the workspace
  constexpr bool LU = LAYOUT == kResident; // l and u copied into the slice
  const int lane = threadIdx.x & 31;
  // row r of A: one place in the resident and global layouts, two in the split one
  auto row = [&](int r) -> const TD* {
    return LAYOUT == kSplit ? A.row(r) : A.res + (size_t)r * A.lda;
  };
  // ---- the warp's slice -------------------------------------------------------
  TS* sG = reinterpret_cast<TS*>(wsm);       // ns*ns Ginv
  TS* sx = sG + ns * ns;                     // n    x
  TS* sxun = sx + n;                         // n    unconstrained minimum
  TS* sarow = sxun + n;                      // n    pivot row, slot type
  TS* scol = sarow + n;                      // n    P⁻¹ a_p
  TS* stmp = scol + n;                       // n    Aactᵀ(·) scratch
  TS* slam = stmp + n;                       // ns   λ
  TS* sg = slam + ns;                        // ns   g
  TS* sr = sg + ns;                          // ns   r
  TS* sck = sr + ns;                         // ns   a row of Ginv
  TS* sdv = sck + ns;                        // ns   KKT right-hand side (warm)
  TS* slw = sdv + ns;                        // ns   KKT multipliers (warm)
  const int ldx = row_stride<TD>(n);
  TD* sxd = reinterpret_cast<TD*>(wsm + align16(sizeof(TS) * (ns * ns + 5 * n + 6 * ns)));
  TD* sl_ = sxd + ldx;                       // m    (sxd: x in the data type), LU only
  TD* sAact = sl_ + (LU ? 2 * m : 0);        // ns*n slot table, data type
  const TD* sl = LU ? sl_ : l + (size_t)b * m;       // l and u of the lane
  const TD* su = LU ? sl_ + m : u + (size_t)b * m;
  int* sidx = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(sxd) +
                                     align16(sizeof(TD) * (ldx + (LU ? 2 * m : 0) + ns * n)));
  int* sside = sidx + ns;                    // ns
  int* svm = sside + ns;                     // ns

  const TS eps = static_cast<TS>(tol);
  const TD eps_d = static_cast<TD>(tol);
  const TS tiny = static_cast<TS>(kTiny);
  const TS inf = static_cast<TS>(INFINITY);
  const TD inf_d = static_cast<TD>(INFINITY);
  const TD big = static_cast<TD>(kBig);
  // P⁻¹ a_r into scol and a_r into sarow, in the slot type
  auto pivot_col = [&](int r) {
    const TD* ar = row(r);
    per_row<TS>(lane, n, n, [&](int k, int j) { return sP[k * n + j] * static_cast<TS>(ar[j]); },
                [&](int k, TS s) {
                  scol[k] = s;
                  sarow[k] = static_cast<TS>(ar[k]);
                });
  };

  // ---- load the lane ---------------------------------------------------------
  if constexpr (LU) {
    copy_async(sl_, l + (size_t)b * m, m, lane, 32);
    copy_async(sl_ + m, u + (size_t)b * m, m, lane, 32);
  }
  copy_in<WS>(sG, Ginv_g + (size_t)b * ns * ns, ns * ns, lane, 32);
  __pipeline_commit();
  for (int s = lane; s < ns; s += 32) {
    sidx[s] = idx_g[(size_t)b * ns + s];
    sside[s] = side_g[(size_t)b * ns + s];
    svm[s] = vmask_g[(size_t)b * ns + s] != 0;
    slam[s] = TS(0);
  }
  const TD* qb = q + (size_t)b * n;
  auto unconstrained = [&]() {
    per_row<TS>(lane, n, n, [&](int k, int j) { return sP[k * n + j] * static_cast<TS>(qb[j]); },
                [&](int k, TS s) {
                  sxun[k] = -s;
                  sx[k] = -s;
                });
  };
  if constexpr (!LATE) unconstrained();
  __pipeline_wait_prior(0);
  __syncwarp();
  if constexpr (OWN) {
    // the row norms of the lane's own A: a thread a row, each sum in j order
    for (int i = lane; i < m; i += 32) {
      const TD* a = A.res + (size_t)i * A.lda;
      TD s2 = TD(0);
      for (int j = 0; j < n; ++j) s2 += a[j] * a[j];
      srn[i] = sqrt(s2);
    }
  }
  if constexpr (LATE) unconstrained();
  for (int e = lane; e < ns * n; e += 32) {
    const int s = e / n, j = e - s * n;
    sAact[e] = svm[s] ? row(sidx[s])[j] : TD(0);
  }
  __syncwarp();

  // the lane's scalar carry, the same in every thread of the warp
  int it = 0, wpos = 0;
  const int wcnt = wcnt_g[b];
  const int max_it = max_it_g[b];
  int done = !(warm || wcnt > 0);

  // ---- warm loop: insert one pending warm row, or KKT jump + wrong-sign drop --
  while (!done && it < max_it) {
    const int inserting = wpos < wcnt;
    const int wsel = min(wpos, ns - 1);
    const int cand = widx_g[(size_t)b * ns + wsel];
    const int cside = wside_g[(size_t)b * ns + wsel];
    pivot_col(cand);
    for (int s = lane; s < ns; s += 32) {
      TS ax = TS(0);
#pragma unroll 4
      for (int j = 0; j < n; ++j) ax += static_cast<TS>(sAact[s * n + j]) * sxun[j];
      const TS bnd = static_cast<TS>(sside[s] > 0 ? su[sidx[s]] : sl[sidx[s]]);
      const TS sgn = svm[s] ? static_cast<TS>(sside[s]) : TS(0);
      sdv[s] = svm[s] ? sgn * (ax - bnd) : TS(0);
    }
    __syncwarp();
    const TS cspf = static_cast<TS>(cside);
    for (int s = lane; s < ns; s += 32) {
      TS d = TS(0);
#pragma unroll 4
      for (int j = 0; j < n; ++j) d += static_cast<TS>(sAact[s * n + j]) * scol[j];
      const TS sgn = svm[s] ? static_cast<TS>(sside[s]) : TS(0);
      sg[s] = svm[s] ? d * sgn * cspf : TS(0);
    }
    __syncwarp();
    for (int s = lane; s < ns; s += 32) {
      TS rr = TS(0), lw = TS(0);
#pragma unroll 4
      for (int t = 0; t < ns; ++t) {
        rr += sG[s * ns + t] * sg[t];
        lw += sG[s * ns + t] * sdv[t];
      }
      sr[s] = svm[s] ? rr : TS(0);
      slw[s] = lw;
    }
    __syncwarp();
    // the decisions, in every thread
    TS gamma = TS(0), gr = TS(0);
#pragma unroll 4
    for (int k = 0; k < n; ++k) gamma += sarow[k] * scol[k];
#pragma unroll 4
    for (int s = 0; s < ns; ++s) gr += sg[s] * sr[s];
    const TS sc = gamma - gr;
    int app = 0, free_ = 0;
    for (int s = ns - 1; s >= 0; --s)
      if (!svm[s]) { app = s; free_ = 1; }
    const int ins_ok = inserting && (sc > eps * (gamma > TS(1) ? gamma : TS(1))) && free_;
    int k_w = 0;
    TS best = svm[0] ? slw[0] : inf;
    for (int s = 1; s < ns; ++s) {
      const TS v = svm[s] ? slw[s] : inf;
      if (before_min(v, s, best, k_w)) { best = v; k_w = s; }
    }
    const int negw = best < -eps;
    const int kkt = !inserting;
    const int adopt = kkt && !negw;
    const int wdrop = kkt && negw;
    const TS c1 = sc > tiny ? sc : tiny;   // jnp.maximum(sc, tiny)
    const TS pivw = sG[k_w * ns + k_w] > tiny ? sG[k_w * ns + k_w] : tiny;
    const int mode = ins_ok ? 1 : (wdrop ? 2 : (adopt ? 3 : 0));
    wpos += inserting;
    it += 1;
    done = done || adopt;
    if (mode == 2) {
      for (int t = lane; t < ns; t += 32) sck[t] = sG[k_w * ns + t];
    } else if (mode == 3) {
      per_row<TS>(lane, n, ns, [&](int j, int t) {
        const TS sgn = svm[t] ? static_cast<TS>(sside[t]) : TS(0);
        return static_cast<TS>(sAact[t * n + j]) * (sgn * slw[t]);
      }, [&](int j, TS s) { stmp[j] = s; });
    }
    __syncwarp();
    if (mode == 1) {            // bordering insert of the warm row
      for (int e = lane; e < ns * ns; e += 32) {
        const int i = e / ns, j = e - i * ns;
        const TS wi = sr[i] - (i == app ? TS(1) : TS(0));
        const TS wj = sr[j] - (j == app ? TS(1) : TS(0));
        sG[e] = sG[e] + wi * wj / c1 - ((i == app && j == app) ? TS(1) : TS(0));
      }
      for (int j = lane; j < n; j += 32) sAact[app * n + j] = row(cand)[j];
      if (lane == 0) {
        sidx[app] = cand;
        sside[app] = cside;
        svm[app] = 1;
      }
    } else if (mode == 2) {     // drop the most negative multiplier's slot
      for (int e = lane; e < ns * ns; e += 32) {
        const int i = e / ns, j = e - i * ns;
        sG[e] = sG[e] - sck[i] * sck[j] / pivw + ((i == k_w && j == k_w) ? TS(1) : TS(0));
      }
      if (lane == 0) svm[k_w] = 0;
    } else if (mode == 3) {     // adopt the KKT point of the current set
      per_row<TS>(lane, n, n, [&](int k, int j) { return sP[k * n + j] * stmp[j]; },
                  [&](int k, TS s) { sx[k] = sxun[k] - s; });
      for (int s = lane; s < ns; s += 32)
        slam[s] = svm[s] ? (slw[s] > TS(0) ? slw[s] : TS(0)) : TS(0);
    }
    __syncwarp();
  }

  // ---- main loop: violation scan + fused select and pivot step ---------------
  int p = -1, sp = 0, zrun = 0, d1 = -1, d2 = -1, vstall = 0, restarted = 0, feas = 1;
  TS slack = TS(0), lam_p = TS(0);
  done = 0;
  while (!done && it < max_it) {
    // -- scan (the work of kmv): aᵢ·x_d, scaled violation, warp argmax --
    for (int k = lane; k < n; k += 32) sxd[k] = static_cast<TD>(sx[k]);
    __syncwarp();
    TD xs2 = TD(0);
#pragma unroll 4
    for (int j = 0; j < n; ++j) xs2 += sxd[j] * sxd[j];
    const TD xnorm = sqrt(xs2);
    TD best = -inf_d, best_ax = TD(0);
    int best_i = 0x7fffffff;
    scan_range<!WS, false>(A.res, A.lda, 0, A.nres, sxd, sl, su, srn, xnorm, n, lane, best,
                           best_i, best_ax);
    if constexpr (LAYOUT == kSplit)
      scan_range<false, true>(A.cm, A.mr, A.nres, m, sxd, sl, su, srn, xnorm, n, lane, best,
                              best_i, best_ax);
    for (int off = 16; off > 0; off >>= 1) {
      const TD ov = __shfl_xor_sync(kFull, best, off);
      const int oi = __shfl_xor_sync(kFull, best_i, off);
      const TD oa = __shfl_xor_sync(kFull, best_ax, off);
      if (before_max(ov, oi, best, best_i)) { best = ov; best_i = oi; best_ax = oa; }
    }
    // -- select (every thread holds the winner) --
    const int j = best_i;
    const TD vlj = sl[j] > -big ? sl[j] - best_ax : -inf_d;
    const TD vuj = su[j] < big ? best_ax - su[j] : -inf_d;
    const int opt = best <= eps_d;
    const int j_side = vuj >= vlj ? 1 : -1;
    const int cont = p >= 0;
    const int fresh = !cont && !opt;
    const int stepping = cont || fresh;
    const int pe = cont ? p : j;
    const int sp_ = cont ? sp : j_side;
    const TD vj = nan_max(vlj, vuj);
    const TS slack_ = cont ? slack : static_cast<TS>(nan_max(vj, TD(0)));
    const TS lam_p_ = cont ? lam_p : TS(0);
    const TS spf = static_cast<TS>(sp_);
    // -- Gram work for the pivot row (slot type) --
    pivot_col(pe);
    __syncwarp();
    for (int s = lane; s < ns; s += 32) {
      TS d = TS(0);
#pragma unroll 4
      for (int jj = 0; jj < n; ++jj) d += static_cast<TS>(sAact[s * n + jj]) * scol[jj];
      const TS sgn = svm[s] ? static_cast<TS>(sside[s]) : TS(0);
      sg[s] = svm[s] ? d * sgn * spf : TS(0);
    }
    __syncwarp();
    for (int s = lane; s < ns; s += 32) {
      TS rr = TS(0);
#pragma unroll 4
      for (int t = 0; t < ns; ++t) rr += sG[s * ns + t] * sg[t];
      sr[s] = svm[s] ? rr : TS(0);
    }
    __syncwarp();
    // -- step lengths and every decision (every thread) --
    TS gamma = TS(0), gr = TS(0);
#pragma unroll 4
    for (int k = 0; k < n; ++k) gamma += sarow[k] * scol[k];
#pragma unroll 4
    for (int s = 0; s < ns; ++s) gr += sg[s] * sr[s];
    const TS sc = gamma - gr;            // Schur complement = −sp·aᵀz
    const TS t2 = sc > eps ? slack_ / (sc > tiny ? sc : tiny) : inf;
    int k_b = 0;
    TS t1 = inf;
    for (int s = 0; s < ns; ++s) {
      const TS ratio = (svm[s] && sr[s] > eps) ? slam[s] / (sr[s] > eps ? sr[s] : eps) : inf;
      if (s == 0 || before_min(ratio, s, t1, k_b)) { t1 = ratio; k_b = s; }
    }
    TS t = nan_min(t1, t2);
    const int infeas_raw = stepping && !isfinite(t);
    if (!isfinite(t)) t = TS(0);
    int app = 0, free_ = 0;
    for (int s = ns - 1; s >= 0; --s)
      if (!svm[s]) { app = s; free_ = 1; }
    const int fin2 = isfinite(t2);
    const int full = (t2 <= t1) && fin2 && free_;
    const int do_add = stepping && full && !infeas_raw;
    const int do_drop = stepping && !full && (t1 <= t2) && !infeas_raw && isfinite(t1);
    const int overflow_raw = stepping && !free_ && fin2 && (t2 <= t1) && !infeas_raw;
    const int zero_run = (stepping && t <= tiny) ? zrun + 1 : 0;
    const int rehit = fresh && (j == d1 || j == d2);
    const int vst = rehit ? vstall + 1 : (fresh ? 0 : vstall);
    const int restart = !restarted && (zero_run > ns + 2 || vst >= 4 || infeas_raw || overflow_raw);
    const int infeasible = infeas_raw && restarted;
    const int overflow = overflow_raw && restarted;
    const TS piv = sG[k_b * ns + k_b] > tiny ? sG[k_b * ns + k_b] : tiny;
    const TS lam_p_new = lam_p_ + t;
    const TS slack_new0 = slack_ - t * sc;
    const TS slack_new = slack_new0 > TS(0) ? slack_new0 : TS(0);
    const TS c1 = do_add ? TS(1) / (sc > tiny ? sc : tiny) : (do_drop ? TS(-1) / piv : TS(0));
    const TS c2 = do_add ? TS(-1) : (do_drop ? TS(1) : TS(0));
    const int upd_x = stepping && !infeas_raw && !overflow_raw;
    const int keep_step = stepping && !overflow_raw;
    // the scalar carry (d2 before d1: it takes the old d1)
    const int idx_kb = sidx[k_b];
    p = do_drop ? pe : -1;
    sp = do_drop ? sp_ : 0;
    slack = do_drop ? slack_new : TS(0);
    lam_p = do_drop ? lam_p_new : TS(0);
    zrun = zero_run;
    d2 = do_drop ? d1 : d2;
    d1 = do_drop ? idx_kb : d1;
    vstall = vst;
    it += 1;
    done = done || infeasible || overflow || (!cont && opt);
    feas = feas && !infeasible && !overflow;
    if (restart) {            // the cold restart overrides all but `it`
      p = -1;
      sp = 0;
      slack = TS(0);
      lam_p = TS(0);
      zrun = 0;
      d1 = -1;
      d2 = -1;
      vstall = 0;
    }
    restarted = restarted || restart;
    for (int s = lane; s < ns; s += 32) sck[s] = sG[k_b * ns + s];
    per_row<TS>(lane, n, ns, [&](int jj, int tt) {
      const TS sgn = svm[tt] ? static_cast<TS>(sside[tt]) : TS(0);
      return static_cast<TS>(sAact[tt * n + jj]) * (sr[tt] * sgn);
    }, [&](int jj, TS s) { stmp[jj] = s; });
    __syncwarp();
    if (restart) {
      for (int k = lane; k < n; k += 32) sx[k] = sxun[k];
      for (int e = lane; e < ns * ns; e += 32) sG[e] = (e / ns == e % ns) ? TS(1) : TS(0);
      for (int e = lane; e < ns * n; e += 32) sAact[e] = TD(0);
      for (int s = lane; s < ns; s += 32) {
        slam[s] = TS(0);
        sidx[s] = 0;
        sside[s] = 0;
        svm[s] = 0;
      }
    } else {
      if (upd_x)
        per_row<TS>(lane, n, n, [&](int k, int jj) { return sP[k * n + jj] * stmp[jj]; },
                    [&](int k, TS s) { sx[k] = sx[k] + t * (s - spf * scol[k]); });
      // unified rank-one update: Ginv + c1·aaᵀ + c2·bbᵀ
      for (int e = lane; e < ns * ns; e += 32) {
        const int i = e / ns, jj = e - i * ns;
        const TS ai = do_add ? sr[i] - (i == app ? TS(1) : TS(0)) : sck[i];
        const TS aj = do_add ? sr[jj] - (jj == app ? TS(1) : TS(0)) : sck[jj];
        const TS bi = (i == (do_add ? app : k_b)) ? TS(1) : TS(0);
        const TS bj = (jj == (do_add ? app : k_b)) ? TS(1) : TS(0);
        sG[e] = sG[e] + c1 * (ai * aj) + c2 * (bi * bj);
      }
      if (do_add)
        for (int jj = lane; jj < n; jj += 32) sAact[app * n + jj] = row(pe)[jj];
      // multipliers and slot bits, one thread per slot (reads before writes)
      for (int s = lane; s < ns; s += 32) {
        const TS lo = slam[s] - t * sr[s];
        const TS lam_step = svm[s] ? (lo > TS(0) ? lo : TS(0)) : slam[s];
        if (do_add) {
          slam[s] = s == app ? lam_p_new : lam_step;
          if (s == app) {
            svm[s] = 1;
            sidx[s] = pe;
            sside[s] = sp_;
          }
        } else if (do_drop) {
          slam[s] = lam_step * (TS(1) - (s == k_b ? TS(1) : TS(0)));
          if (s == k_b) svm[s] = 0;
        } else if (keep_step) {
          slam[s] = lam_step;
        }
      }
    }
    __syncwarp();
  }

  // ---- write back ---------------------------------------------------------------
  for (int k = lane; k < n; k += 32) x_out[(size_t)b * n + k] = sx[k];
  for (int s = lane; s < ns; s += 32) {
    lam_out[(size_t)b * ns + s] = slam[s];
    idx_g[(size_t)b * ns + s] = sidx[s];
    side_g[(size_t)b * ns + s] = sside[s];
    vmask_g[(size_t)b * ns + s] = static_cast<uint8_t>(svm[s] != 0);
  }
  for (int e = lane; e < ns * ns; e += 32) Ginv_g[(size_t)b * ns * ns + e] = sG[e];
  if (lane == 0) {
    it_out[b] = it;
    conv_out[b] = static_cast<uint8_t>(done && feas);
  }
  __syncwarp();   // the slice is reused by the warp's next lane
}

// MINB blocks of kMaxWarps warps fit an SM's registers: 2 (64 registers a
// thread) where two blocks' shared memory fits an SM, else 1 (128; always in
// the global and split layouts).  ``ws`` is the global layout's workspace;
// ``At`` the split layout's column-major copy of A's rows [rows, m) of each
// controller (n × (m − rows)).  ``pmap`` (nullptr: the block's controller)
// is P⁻¹'s lane map where P⁻¹ and A come through different maps: the
// resident layout (MODE kLaneP) copies a lane's P⁻¹ into its warp's slice,
// the others read it where it lies.  MODE kOwn (resident only): the per-lane
// geometry, where every lane is its own controller — no controller part for
// the block, each warp copies its lane's A (through ``amap``) and P⁻¹
// (through ``pmap``) in the same group as the lane's other loads, waits once
// and computes the lane's row norms itself; no block barrier after the lane
// counter.  The split and global layouts take MODE kShared and ``pmap`` at
// run time.
template <typename TD, typename TS, int MINB, int LAYOUT, int MODE>
__global__ void __launch_bounds__(32 * kMaxWarps, MINB)
gi_solve_kernel(const TS* __restrict__ Pinv, const TD* __restrict__ A,
                const TD* __restrict__ At, int rows,
                const int32_t* __restrict__ table, const int32_t* __restrict__ block_ctrl,
                const int32_t* __restrict__ pmap, const int32_t* __restrict__ amap,
                int width, const TD* __restrict__ q, const TD* __restrict__ l,
                const TD* __restrict__ u, int32_t* __restrict__ idx_g,
                int32_t* __restrict__ side_g, uint8_t* __restrict__ vmask_g,
                TS* __restrict__ Ginv_g, const int32_t* __restrict__ widx_g,
                const int32_t* __restrict__ wside_g, const int32_t* __restrict__ wcnt_g,
                const int32_t* __restrict__ max_it_g, TS* __restrict__ x_out,
                TS* __restrict__ lam_out, int32_t* __restrict__ it_out,
                uint8_t* __restrict__ conv_out, unsigned char* ws, int n, int m,
                int ns, int warm, double tol) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int32_t* lanes = table + (size_t)blockIdx.x * width;
  constexpr bool GLOBAL = LAYOUT == kGlobal;
  constexpr bool OWN = MODE == kOwn;
  // P⁻¹ a lane, copied into the warp's slice (resident) or read in place
  constexpr bool P_SLICE = MODE == kLaneP;
  const bool pw = P_SLICE || (LAYOUT != kResident && pmap != nullptr);
  const size_t slice = warp_bytes<TD, TS>(n, m, ns, LAYOUT == kResident, P_SLICE);
  const int lda = row_stride<TD>(n);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int next_slot;
  const TS* sP = nullptr;  // n*n P⁻¹
  RowsOf<TD> rows_of{};    // A's rows
  TD* srn = nullptr;       // m row norms
  unsigned char* wsm;      // the warp's slice (on chip), the lanes' slices (global)
  if constexpr (OWN) {
    // ---- per-lane blocks: each warp's area, nothing shared but the counter ----
    wsm = smem_raw + (size_t)warp * own_bytes<TD, TS>(n, m, ns);
    if (tid == 0) next_slot = nt >> 5;
    __syncthreads();
  } else if constexpr (GLOBAL) {
    const int c = block_ctrl[blockIdx.x];
    const TD* Ac = A + (size_t)c * m * n;
    // ---- the controller's tables where they lie; the block's row norms ------
    sP = Pinv + (size_t)c * n * n;
    rows_of = {Ac, n, m, Ac, n, nullptr, 0};
    srn = reinterpret_cast<TD*>(ws + (size_t)blockIdx.x * align16(sizeof(TD) * m));
    wsm = ws + (size_t)gridDim.x * align16(sizeof(TD) * m);
    if (tid == 0) next_slot = nt >> 5;
  } else {
    // ---- the controller's part, once per block: A's first `nres` rows ----------
    const int c = block_ctrl[blockIdx.x];
    const TD* Ac = A + (size_t)c * m * n;
    const int nres = LAYOUT == kSplit ? rows : m;
    TS* P_s = reinterpret_cast<TS*>(smem_raw);
    TD* A_s = reinterpret_cast<TD*>(smem_raw + (pw ? 0 : align16(sizeof(TS) * n * n)));
    for (int e = tid; e < nres * n; e += nt) {
      const int i = e / n, j = e - i * n;
      __pipeline_memcpy_async(A_s + (size_t)i * lda + j, Ac + e, sizeof(TD));
    }
    if (!pw) copy_async(P_s, Pinv + (size_t)c * n * n, n * n, tid, nt);
    __pipeline_commit();
    if (tid == 0) next_slot = nt >> 5;
    __pipeline_wait_prior(0);
    __syncthreads();
    sP = pw ? nullptr : P_s;
    rows_of = {A_s, lda, nres, Ac, n, At + (size_t)c * n * (m - nres), m - nres};
    srn = A_s + (size_t)nres * lda;
    wsm = smem_raw + ctrl_bytes<TD, TS>(n, nres, m, pw) + warp * slice;
  }
  for (int i = tid; i < m && !OWN; i += nt) {
    TD s2 = TD(0);
    if (LAYOUT != kSplit || i < rows_of.nres) {
      const TD* a = rows_of.res + (size_t)i * rows_of.lda;
      for (int j = 0; j < n; ++j) s2 += a[j] * a[j];
    } else {
      const TD* a = rows_of.cm + (i - rows_of.nres);
      for (int j = 0; j < n; ++j) s2 += a[(size_t)j * rows_of.mr] * a[(size_t)j * rows_of.mr];
    }
    srn[i] = sqrt(s2);
  }
  if (!OWN) __syncthreads();

  // ---- each warp solves lanes until the block's list is used up ----------------
  int slot = warp;
  while (slot < width) {
    const int b = lanes[slot];
    if (b < 0) break;        // −1 pads the end of the list
    const TS* sPl = sP;
    RowsOf<TD> rl = rows_of;
    TD* srnl = srn;
    unsigned char* wl = GLOBAL ? wsm + (size_t)b * slice : wsm;
    if constexpr (OWN) {
      // the lane's own P⁻¹ and A into the warp's area (not yet committed)
      TS* P_w = reinterpret_cast<TS*>(wsm);
      TD* A_w = reinterpret_cast<TD*>(wsm + align16(sizeof(TS) * n * n));
      const TD* Ag = A + (size_t)amap[b] * m * n;
      copy_bytes_async(P_w, Pinv + (size_t)pmap[b] * n * n, sizeof(TS) * n * n, lane, 32);
      copy_rows_async(A_w, lda, Ag, m, n, lane);
      sPl = P_w;
      rl = {A_w, lda, m, Ag, n, nullptr, 0};
      srnl = A_w + (size_t)m * lda;
      wl = wsm + ctrl_bytes<TD, TS>(n, m, m, false);
    } else if constexpr (P_SLICE) {
      copy_bytes_async(wsm, Pinv + (size_t)pmap[b] * n * n, sizeof(TS) * n * n, lane, 32);
      sPl = reinterpret_cast<const TS*>(wsm);
      wl = wsm + align16(sizeof(TS) * n * n);
    } else if (pw) {
      sPl = Pinv + (size_t)pmap[b] * n * n;
    }
    solve_lane<TD, TS, LAYOUT, OWN, OWN || P_SLICE>(
        b, wl, rl, srnl, sPl, q, l, u, idx_g, side_g, vmask_g, Ginv_g, widx_g, wside_g, wcnt_g,
        max_it_g, x_out, lam_out, it_out, conv_out, n, m, ns, warm, tol);
    int nxt = 0;
    if (lane == 0) nxt = atomicAdd(&next_slot, 1);
    slot = __shfl_sync(kFull, nxt, 0);
  }
}

inline bool two_blocks(int smem_bytes) { return 2 * (smem_bytes + kSmemPerBlock) <= kSmemPerSM; }

// the instantiation a launch of this layout, geometry (`mode`: kShared,
// kLaneP, kOwn; the resident layout's) and shared memory takes
template <typename TD, typename TS, int MODE>
auto resident_for(int smem_bytes) {
  return two_blocks(smem_bytes) ? gi_solve_kernel<TD, TS, 2, kResident, MODE>
                                : gi_solve_kernel<TD, TS, 1, kResident, MODE>;
}
template <typename TD, typename TS>
auto kernel_for(int layout, int smem_bytes, int mode) {
  return layout == kGlobal  ? gi_solve_kernel<TD, TS, 1, kGlobal, kShared>
         : layout == kSplit ? gi_solve_kernel<TD, TS, 1, kSplit, kShared>
         : mode == kOwn     ? resident_for<TD, TS, kOwn>(smem_bytes)
         : mode == kLaneP   ? resident_for<TD, TS, kLaneP>(smem_bytes)
                            : resident_for<TD, TS, kShared>(smem_bytes);
}

template <typename TD, typename TS>
int launch(const void* Pinv, const void* A, const void* At, int rows, const void* table,
           const void* block_ctrl, const void* pmap, const void* amap, int own,
           const void* q, const void* l, const void* u, void* idx, void* side, void* vmask,
           void* Ginv, const void* widx, const void* wside, const void* wcnt,
           const void* max_it, void* x, void* lam, void* it, void* conv, void* ws, int n_blocks,
           int width, int warps, int n, int m, int ns, int warm, int smem_bytes, int layout,
           double tol, void* stream) {
  if (n_blocks <= 0) return 0;
  if (warps <= 0 || warps > kMaxWarps || width < 1) return (int)cudaErrorInvalidValue;
  if (ns < 1 || ns > n) return (int)cudaErrorInvalidValue;
  if (layout < kResident || layout > kSplit) return (int)cudaErrorInvalidValue;
  if (layout == kSplit && (rows < 0 || rows > m || (rows < m && At == nullptr)))
    return (int)cudaErrorInvalidValue;
  // the per-lane geometry: resident only, both lane maps given
  if (own && (layout != kResident || pmap == nullptr || amap == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!own && block_ctrl == nullptr) return (int)cudaErrorInvalidValue;
  const bool pw = !own && pmap != nullptr;
  const size_t need =
      layout == kGlobal  ? 0
      : own              ? warps * own_bytes<TD, TS>(n, m, ns)
      : layout == kSplit ? ctrl_bytes<TD, TS>(n, rows, m, pw) +
                               warps * warp_bytes<TD, TS>(n, m, ns, false, false)
                         : ctrl_bytes<TD, TS>(n, m, m, pw) +
                               warps * warp_bytes<TD, TS>(n, m, ns, true, pw);
  if ((size_t)smem_bytes != need || (layout == kGlobal && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int mode = own ? kOwn : (layout == kResident && pw ? kLaneP : kShared);
  auto kern = kernel_for<TD, TS>(layout, smem_bytes, mode);
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<n_blocks, 32 * warps, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TS*>(Pinv), static_cast<const TD*>(A), static_cast<const TD*>(At),
      rows, static_cast<const int32_t*>(table), static_cast<const int32_t*>(block_ctrl),
      static_cast<const int32_t*>(pmap), static_cast<const int32_t*>(amap), width,
      static_cast<const TD*>(q), static_cast<const TD*>(l), static_cast<const TD*>(u),
      static_cast<int32_t*>(idx), static_cast<int32_t*>(side), static_cast<uint8_t*>(vmask),
      static_cast<TS*>(Ginv), static_cast<const int32_t*>(widx),
      static_cast<const int32_t*>(wside), static_cast<const int32_t*>(wcnt),
      static_cast<const int32_t*>(max_it), static_cast<TS*>(x), static_cast<TS*>(lam),
      static_cast<int32_t*>(it), static_cast<uint8_t*>(conv), static_cast<unsigned char*>(ws),
      n, m, ns, warm, tol);
  return (int)cudaGetLastError();
}

}  // namespace

#define MPC_GI_ENTRY(NAME, TD, TS)                                                            \
  extern "C" int NAME(const void* Pinv, const void* A, const void* At, int rows,              \
                      const void* table, const void* block_ctrl, const void* pmap,            \
                      const void* amap, int own, const void* q, const void* l, const void* u, \
                      void* idx, void* side, void* vmask, void* Ginv, const void* widx,       \
                      const void* wside, const void* wcnt, const void* max_it, void* x,       \
                      void* lam, void* it, void* conv, void* ws, int n_blocks, int width,     \
                      int warps, int n, int m, int ns, int warm, int smem_bytes, int layout,  \
                      double tol, void* stream) {                                             \
    return launch<TD, TS>(Pinv, A, At, rows, table, block_ctrl, pmap, amap, own, q, l, u,     \
                          idx, side, vmask, Ginv, widx, wside, wcnt, max_it, x, lam, it,      \
                          conv, ws, n_blocks, width, warps, n, m, ns, warm, smem_bytes,       \
                          layout, tol, stream);                                               \
  }

MPC_GI_ENTRY(mpc_gi_solve_f32_f64, float, double)
MPC_GI_ENTRY(mpc_gi_solve_f32_f32, float, float)
MPC_GI_ENTRY(mpc_gi_solve_f64_f64, double, double)

// Blocks of `warps` warps and `smem_bytes` of shared memory resident on one
// SM (the runtime's occupancy calculator) in a layout (0: resident, 1:
// global, 2: split) and geometry (`mode`: 0 a controller's lanes a block, 1
// the same with P⁻¹ a lane, 2 per-lane blocks); variant 0 = (f32 data, f64
// slots), 1 = (f32, f32), 2 = (f64, f64).  Returns −1 on an error.
extern "C" int mpc_gi_blocks_per_sm(int variant, int layout, int warps, int smem_bytes,
                                    int mode) {
  const void* fn =
      variant == 0   ? (const void*)kernel_for<float, double>(layout, smem_bytes, mode)
      : variant == 1 ? (const void*)kernel_for<float, float>(layout, smem_bytes, mode)
                     : (const void*)kernel_for<double, double>(layout, smem_bytes, mode);
  // as a launch does: raise the kernel's shared-memory limit above the default
  // 48 KB only (a lower setting would refuse a later, larger launch)
  if (smem_bytes > 48 * 1024 &&
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes) !=
          cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, 32 * warps, smem_bytes) !=
      cudaSuccess)
    return -1;
  return blocks;
}
