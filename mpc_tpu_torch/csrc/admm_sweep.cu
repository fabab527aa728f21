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
// Layout: one thread block per lane.  The lane's A (read through lane_ctrl
// from the n_d distinct controllers, so every replica of a controller reads
// the same rows out of L2), its Minv, q, l, u, ρ and the iterates x, z, y go
// into dynamic shared memory once, all `iters` sweeps run there, and x, z, y
// are written back once.  Threads stride over the m constraint rows for A·x̃,
// the projection and the dual update; Aᵀ(ρ∘z − y) is a per-column warp-shuffle
// reduction over the rows followed by a sum over the block's warps.
//
// What bounds it: per sweep a lane does ~2mn + n² multiply-adds, 4mn + 2n²
// flops (2,070 at the 2x2 Hp=10 headline, n=5, m=101), behind four block
// barriers, and reads A twice from shared memory, so a sweep is a
// few microseconds of dependent shared-memory latency, not bandwidth or FLOPs.
// The design answers that with many independent lanes in flight (B blocks of
// at most 256 threads, small enough that several share an SM) and with device
// memory touched only at the start and the end of a launch.  Lanes whose
// `active` flag is 0 return at once and leave x, z, y untouched: that is the
// lockstep freeze of the reference's vmapped while_loop.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Upper bound on warps per block (ops/_build.py::MAX_WARPS); the host picks
// at most 256 threads.  The host-side working-set formula
// (ops/admm_kernel.py::smem_bytes) uses it too.
constexpr int kMaxWarps = 8;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__device__ __forceinline__ T clip(T v, T lo, T hi) {
  // NaN passes through, as in jnp.clip / torch.clamp
  return v < lo ? lo : (v > hi ? hi : v);
}

template <typename T>
__global__ void admm_sweep_kernel(const T* __restrict__ Minv, const T* __restrict__ A,
                                  const int32_t* __restrict__ lane_ctrl,
                                  const T* __restrict__ q, const T* __restrict__ l,
                                  const T* __restrict__ u, const T* __restrict__ rho,
                                  T* __restrict__ x, T* __restrict__ z, T* __restrict__ y,
                                  const uint8_t* __restrict__ active, int n, int m,
                                  int iters, T sigma, T alpha) {
  const int b = blockIdx.x;
  if (!active[b]) return;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sA = reinterpret_cast<T*>(smem_raw);  // m*n, row-major
  T* sM = sA + (size_t)m * n;              // n*n, row-major
  T* sq = sM + (size_t)n * n;              // n
  T* sx = sq + n;                          // n
  T* srhs = sx + n;                        // n
  T* sxt = srhs + n;                       // n
  T* sl = sxt + n;                         // m
  T* su = sl + m;                          // m
  T* srho = su + m;                        // m
  T* sz = srho + m;                        // m
  T* sy = sz + m;                          // m
  T* sred = sy + m;                        // kMaxWarps*n

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = nt >> 5;
  const size_t bn = (size_t)b * n;
  const size_t bm = (size_t)b * m;

  const T* Ab = A + (size_t)lane_ctrl[b] * m * n;
  for (int i = tid; i < m * n; i += nt) sA[i] = Ab[i];
  const T* Mb = Minv + (size_t)b * n * n;
  for (int i = tid; i < n * n; i += nt) sM[i] = Mb[i];
  for (int j = tid; j < n; j += nt) {
    sq[j] = q[bn + j];
    sx[j] = x[bn + j];
  }
  for (int i = tid; i < m; i += nt) {
    sl[i] = l[bm + i];
    su[i] = u[bm + i];
    srho[i] = rho[bm + i];
    sz[i] = z[bm + i];
    sy[i] = y[bm + i];
  }
  __syncthreads();

  const T one_m_alpha = T(1) - alpha;
  for (int it = 0; it < iters; ++it) {
    // Aᵀ(ρ∘z − y): this thread's rows, then the warp, per column
    for (int j = 0; j < n; ++j) {
      T acc = T(0);
      for (int i = tid; i < m; i += nt) acc += sA[(size_t)i * n + j] * (srho[i] * sz[i] - sy[i]);
      acc = warp_sum(acc);
      if (lane == 0) sred[warp * n + j] = acc;
    }
    __syncthreads();
    for (int j = tid; j < n; j += nt) {
      T s = T(0);
      for (int w = 0; w < nwarps; ++w) s += sred[w * n + j];
      srhs[j] = sigma * sx[j] - sq[j] + s;
    }
    __syncthreads();
    for (int j = tid; j < n; j += nt) {
      T s = T(0);
      for (int k = 0; k < n; ++k) s += sM[(size_t)j * n + k] * srhs[k];
      sxt[j] = s;
      sx[j] = alpha * s + one_m_alpha * sx[j];
    }
    __syncthreads();
    for (int i = tid; i < m; i += nt) {
      T zt = T(0);
      for (int j = 0; j < n; ++j) zt += sA[(size_t)i * n + j] * sxt[j];
      const T zp = alpha * zt + one_m_alpha * sz[i];
      const T zn = clip(zp + sy[i] / srho[i], sl[i], su[i]);
      sy[i] = sy[i] + srho[i] * (zp - zn);
      sz[i] = zn;
    }
    __syncthreads();
  }

  for (int j = tid; j < n; j += nt) x[bn + j] = sx[j];
  for (int i = tid; i < m; i += nt) {
    z[bm + i] = sz[i];
    y[bm + i] = sy[i];
  }
}

template <typename T>
int launch(const void* Minv, const void* A, const void* lane_ctrl, const void* q,
           const void* l, const void* u, const void* rho, void* x, void* z, void* y,
           const void* active, int B, int n, int m, int iters, int threads,
           int smem_bytes, double sigma, double alpha, void* stream) {
  if (B <= 0 || iters <= 0) return 0;
  if (threads <= 0 || threads % 32 != 0 || threads > 32 * kMaxWarps) return (int)cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(admm_sweep_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  admm_sweep_kernel<T><<<B, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Minv), static_cast<const T*>(A),
      static_cast<const int32_t*>(lane_ctrl), static_cast<const T*>(q),
      static_cast<const T*>(l), static_cast<const T*>(u), static_cast<const T*>(rho),
      static_cast<T*>(x), static_cast<T*>(z), static_cast<T*>(y),
      static_cast<const uint8_t*>(active), n, m, iters, static_cast<T>(sigma),
      static_cast<T>(alpha));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mpc_admm_sweep_f32(const void* Minv, const void* A, const void* lane_ctrl,
                                  const void* q, const void* l, const void* u,
                                  const void* rho, void* x, void* z, void* y,
                                  const void* active, int B, int n, int m, int iters,
                                  int threads, int smem_bytes, double sigma, double alpha,
                                  void* stream) {
  return launch<float>(Minv, A, lane_ctrl, q, l, u, rho, x, z, y, active, B, n, m, iters,
                       threads, smem_bytes, sigma, alpha, stream);
}

extern "C" int mpc_admm_sweep_f64(const void* Minv, const void* A, const void* lane_ctrl,
                                  const void* q, const void* l, const void* u,
                                  const void* rho, void* x, void* z, void* y,
                                  const void* active, int B, int n, int m, int iters,
                                  int threads, int smem_bytes, double sigma, double alpha,
                                  void* stream) {
  return launch<double>(Minv, A, lane_ctrl, q, l, u, rho, x, z, y, active, B, n, m, iters,
                        threads, smem_bytes, sigma, alpha, stream);
}
