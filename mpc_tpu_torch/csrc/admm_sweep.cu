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
// A second layout, "global", takes QPs whose block would not fit the SM's
// shared memory (ops/admm_kernel.py::launch_geometry picks it when one
// lane's block of the variant exceeds the opt-in budget).  It is the same
// two kernels (the template parameter GLOBAL): A is read where it lies in
// device memory, and what a block keeps after A in shared memory (its lanes'
// l, u, ρ, z, y, Minv or x, q, rhs, x̃, and the Aᵀv partial sums) lies in
// the block's own slice of a workspace the wrapper allocates, in the same
// order.  Every sum keeps its order, so the two layouts return the same bits.
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
constexpr int kGroupThreads = 256;
constexpr int kMaxParts = 16;  // row classes of the grouped Aᵀv split, at most

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

// shared memory, in the order of ops/admm_kernel.py::smem_bytes; the global
// layout's workspace holds each block's part after A (workspace_bytes)
template <typename T>
__host__ __device__ size_t warp_slice(int n, int m) {
  return align16(sizeof(T) * (5 * (size_t)m + n * n + 2 * n + (32 / n) * n));
}
template <typename T>
__host__ __device__ size_t group_lane(int n, int m) {
  return align16(sizeof(T) * (6 * (size_t)m + 4 * n));
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

// ---- one warp per lane (n ≤ 32) ------------------------------------------------
template <typename T, bool GLOBAL>
__global__ void __launch_bounds__(32 * kMaxWarps, kWarpMinBlocks)
admm_warp_kernel(const T* __restrict__ Minvs, const T* __restrict__ A,
                 const int32_t* __restrict__ table, const int32_t* __restrict__ block_ctrl,
                 int width, const int32_t* __restrict__ rung, const T* __restrict__ q,
                 const T* __restrict__ l, const T* __restrict__ u, const T* __restrict__ rhovs,
                 T* __restrict__ x, T* __restrict__ z, T* __restrict__ y,
                 const uint8_t* __restrict__ active, unsigned char* ws, int n, int m, int n_lad,
                 int iters, T sigma, T alpha) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c = block_ctrl[blockIdx.x];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t slice = warp_slice<T>(n, m);
  const T* sA;                                                  // m*n
  unsigned char* wsm;
  if constexpr (GLOBAL) {
    sA = A + (size_t)c * m * n;
    wsm = ws + ((size_t)blockIdx.x * (blockDim.x >> 5) + warp) * slice;
  } else {
    T* A_s = reinterpret_cast<T*>(smem_raw);
    copy_async(A_s, A + (size_t)c * m * n, m * n, tid, blockDim.x);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    sA = A_s;
    wsm = smem_raw + align16(sizeof(T) * (size_t)m * n) + warp * slice;
  }
  T* sl = reinterpret_cast<T*>(wsm);   // m
  T* su = sl + m;                      // m
  T* srho = su + m;                    // m
  T* sz = srho + m;                    // m
  T* sy = sz + m;                      // m
  T* sM = sy + m;                      // n*n  the lane's Minv
  T* srhs = sM + n * n;                // n
  T* sxt = srhs + n;                   // n    x̃
  T* spart = sxt + n;                  // (32/n)*n partial sums of Aᵀv

  const int b = warp < width ? table[(size_t)blockIdx.x * width + warp] : -1;
  if (b < 0 || !active[b]) return;
  const size_t bn = (size_t)b * n, bm = (size_t)b * m;
  const size_t rg = (size_t)c * n_lad + rung[b];
  copy_in<GLOBAL>(sl, l + bm, m, lane, 32);
  copy_in<GLOBAL>(su, u + bm, m, lane, 32);
  copy_in<GLOBAL>(srho, rhovs + rg * m, m, lane, 32);
  copy_in<GLOBAL>(sz, z + bm, m, lane, 32);
  copy_in<GLOBAL>(sy, y + bm, m, lane, 32);
  copy_in<GLOBAL>(sM, Minvs + rg * n * n, n * n, lane, 32);
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
      spart[pp * n + pj] = acc;
    }
    __syncwarp();
    if (lane < n) {
      T s = T(0);
      for (int p = 0; p < parts; ++p) s += spart[p * n + lane];
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
    __syncwarp();
  }
  if (lane < n) x[bn + lane] = xj;
  for (int i = lane; i < m; i += 32) {
    z[bm + i] = sz[i];
    y[bm + i] = sy[i];
  }
}

// ---- the block's active lanes in step (n > 32, or a small batch) -------------
// W lane slices (the table's width): the block's active lanes fill the
// first nact, and the products run over all W with no per-lane test in the
// inner loops; a slice past nact computes on whatever it holds and is never
// read back.
template <typename T, int W, bool GLOBAL>
__global__ void __launch_bounds__(kGroupThreads)
admm_group_kernel(const T* __restrict__ Minvs, const T* __restrict__ A,
                  const int32_t* __restrict__ table, const int32_t* __restrict__ block_ctrl,
                  int width, const int32_t* __restrict__ rung, const T* __restrict__ q,
                  const T* __restrict__ l, const T* __restrict__ u, const T* __restrict__ rhovs,
                  T* __restrict__ x, T* __restrict__ z, T* __restrict__ y,
                  const uint8_t* __restrict__ active, unsigned char* ws, int n, int m,
                  int n_lad, int iters, T sigma, T alpha) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int c = block_ctrl[blockIdx.x];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_lane[W];
  __shared__ int s_nact;
  const size_t lane_bytes = group_lane<T>(n, m);
  T* const A_s = reinterpret_cast<T*>(smem_raw);
  const T* sA = GLOBAL ? A + (size_t)c * m * n : A_s;          // m*n
  unsigned char* lanes0 =
      GLOBAL ? ws + (size_t)blockIdx.x * (W * lane_bytes + group_part<T>(n, W))
             : smem_raw + align16(sizeof(T) * (size_t)m * n);
  T* spart = reinterpret_cast<T*>(lanes0 + W * lane_bytes);     // parts*W*n
  // lane w's slice: l, u, ρ, z, y, v = ρ∘z − y (m each), then x, q, rhs, x̃ (n each)
  T* S[W];
#pragma unroll
  for (int w = 0; w < W; ++w) S[w] = reinterpret_cast<T*>(lanes0 + w * lane_bytes);

  if (tid == 0) {
    int k = 0;
    for (int s = 0; s < width; ++s) {
      const int b = table[(size_t)blockIdx.x * width + s];
      if (b >= 0 && active[b]) s_lane[k++] = b;
    }
    s_nact = k;
  }
  __syncthreads();
  const int nact = s_nact;
  if (nact == 0) return;
  if constexpr (!GLOBAL) copy_async(A_s, A + (size_t)c * m * n, m * n, tid, nt);
  for (int w = 0; w < nact; ++w) {
    const size_t b = s_lane[w];
    const size_t rg = (size_t)c * n_lad + rung[b];
    copy_in<GLOBAL>(S[w], l + b * m, m, tid, nt);
    copy_in<GLOBAL>(S[w] + m, u + b * m, m, tid, nt);
    copy_in<GLOBAL>(S[w] + 2 * m, rhovs + rg * m, m, tid, nt);
    copy_in<GLOBAL>(S[w] + 3 * m, z + b * m, m, tid, nt);
    copy_in<GLOBAL>(S[w] + 4 * m, y + b * m, m, tid, nt);
    copy_in<GLOBAL>(S[w] + 6 * m, x + b * n, n, tid, nt);
    copy_in<GLOBAL>(S[w] + 6 * m + n, q + b * n, n, tid, nt);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int e = tid; e < nact * m; e += nt) {
    T* L = S[e / m];
    const int i = e % m;
    L[5 * m + i] = L[2 * m + i] * L[3 * m + i] - L[4 * m + i];
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
        for (int w = 0; w < W; ++w) acc[w] += a * S[w][5 * m + i];
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
      L[6 * m + 2 * n + j] = sigma * L[6 * m + j] - L[6 * m + n + j] + s;
    }
    __syncthreads();
    // x̃ = Minv rhs, each lane with its rung's Minv (read through L1)
    for (int e = tid; e < nact * n; e += nt) {
      const int w = e / n, j = e % n;
      T* L = S[w];
      const T* M = Minvs + ((size_t)c * n_lad + rung[s_lane[w]]) * n * n + (size_t)j * n;
      T s = T(0);
#pragma unroll 4
      for (int k = 0; k < n; ++k) s += __ldg(M + k) * L[6 * m + 2 * n + k];
      L[6 * m + 3 * n + j] = s;
      L[6 * m + j] = alpha * s + one_m_alpha * L[6 * m + j];
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
        for (int w = 0; w < W; ++w) acc[w] += a * S[w][6 * m + 3 * n + j];
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        T* L = S[w];
        const T rho = L[2 * m + i], yo = L[4 * m + i];
        const T zp = alpha * acc[w] + one_m_alpha * L[3 * m + i];
        const T zn = clip(zp + yo / rho, L[i], L[m + i]);
        const T yn = yo + rho * (zp - zn);
        L[4 * m + i] = yn;
        L[3 * m + i] = zn;
        L[5 * m + i] = rho * zn - yn;
      }
    }
    __syncthreads();
  }
  for (int w = 0; w < nact; ++w) {
    const size_t b = s_lane[w];
    for (int j = tid; j < n; j += nt) x[b * n + j] = S[w][6 * m + j];
    for (int i = tid; i < m; i += nt) {
      z[b * m + i] = S[w][3 * m + i];
      y[b * m + i] = S[w][4 * m + i];
    }
  }
}

// the instantiation a launch of this variant, table width and layout takes
template <typename T>
const void* kernel_for(int grouped, int width, int global) {
  if (!grouped) return global ? (const void*)admm_warp_kernel<T, true>
                              : (const void*)admm_warp_kernel<T, false>;
  if (width <= 1) return global ? (const void*)admm_group_kernel<T, 1, true>
                                : (const void*)admm_group_kernel<T, 1, false>;
  return global ? (const void*)admm_group_kernel<T, 2, true>
                : (const void*)admm_group_kernel<T, 2, false>;
}

template <typename T>
int launch(const void* Minvs, const void* A, const void* table, const void* block_ctrl,
           const void* rung, const void* q, const void* l, const void* u, const void* rhovs,
           void* x, void* z, void* y, const void* active, void* ws, int n_blocks, int width,
           int warps, int grouped, int n, int m, int n_lad, int iters, int smem_bytes,
           int global, double sigma, double alpha, void* stream) {
  if (n_blocks <= 0 || iters <= 0) return 0;
  if (n < 1 || m < 1 || n_lad < 1 || width < 1) return (int)cudaErrorInvalidValue;
  if (!grouped && n > 32) return (int)cudaErrorInvalidValue;
  const bool by_warp = !grouped;
  size_t need;
  int threads;
  if (by_warp) {
    if (warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
    need = align16(sizeof(T) * (size_t)m * n) + warps * warp_slice<T>(n, m);
    threads = 32 * warps;
  } else {
    if (width > kGroup) return (int)cudaErrorInvalidValue;
    need = align16(sizeof(T) * (size_t)m * n) + width * group_lane<T>(n, m) +
           group_part<T>(n, width);
    threads = kGroupThreads;
  }
  if (global) need = 0;
  if ((size_t)smem_bytes != need || (global && ws == nullptr)) return (int)cudaErrorInvalidValue;
  const void* fn = kernel_for<T>(grouped, width, global);
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  using Kern = void (*)(const T*, const T*, const int32_t*, const int32_t*, int, const int32_t*,
                        const T*, const T*, const T*, const T*, T*, T*, T*, const uint8_t*,
                        unsigned char*, int, int, int, int, T, T);
  auto kern = reinterpret_cast<Kern>(const_cast<void*>(fn));
  kern<<<n_blocks, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Minvs), static_cast<const T*>(A),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(block_ctrl), width,
      static_cast<const int32_t*>(rung), static_cast<const T*>(q), static_cast<const T*>(l),
      static_cast<const T*>(u), static_cast<const T*>(rhovs), static_cast<T*>(x),
      static_cast<T*>(z), static_cast<T*>(y), static_cast<const uint8_t*>(active),
      static_cast<unsigned char*>(ws), n, m, n_lad, iters, static_cast<T>(sigma),
      static_cast<T>(alpha));
  return (int)cudaGetLastError();
}

}  // namespace

#define MPC_ADMM_ENTRY(NAME, T)                                                               \
  extern "C" int NAME(const void* Minvs, const void* A, const void* table,                    \
                      const void* block_ctrl, const void* rung, const void* q, const void* l, \
                      const void* u, const void* rhovs, void* x, void* z, void* y,            \
                      const void* active, void* ws, int n_blocks, int width, int warps,       \
                      int grouped, int n, int m, int n_lad, int iters, int smem_bytes,        \
                      int global, double sigma, double alpha, void* stream) {                 \
    return launch<T>(Minvs, A, table, block_ctrl, rung, q, l, u, rhovs, x, z, y, active, ws,  \
                     n_blocks, width, warps, grouped, n, m, n_lad, iters, smem_bytes, global, \
                     sigma, alpha, stream);                                                   \
  }

MPC_ADMM_ENTRY(mpc_admm_sweep_f32, float)
MPC_ADMM_ENTRY(mpc_admm_sweep_f64, double)

// Blocks of `threads` threads and `smem_bytes` of shared memory resident on
// one SM (the runtime's occupancy calculator) for a variant, a table `width`
// and a layout (`global` 0: resident, 1: global): one warp a lane, or
// (`grouped`) the lanes in step.  Returns −1 on an error.
extern "C" int mpc_admm_blocks_per_sm(int f64, int global, int grouped, int width, int threads,
                                      int smem_bytes) {
  const void* fn = f64 ? kernel_for<double>(grouped, width, global)
                       : kernel_for<float>(grouped, width, global);
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
