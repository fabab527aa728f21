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
// Layout: one thread block per lane (blockIdx.x = lane), which runs that
// lane's whole solve and exits on its own `done` or iteration cap: no lockstep
// tail and no host synchronisation per pivot.  lane_ctrl[lane] picks the
// controller whose A (data type) and P⁻¹ (slot type) are loaded once into
// dynamic shared memory, beside l, u, the row norms (computed in-block), Ginv,
// x, λ, the slot table Aact and the slot-space scratch.  Mixed precision is the
// reference's (qp_active.py:187-204): the scan, its scale, v[j] and eps_d are
// in the data type TD; x, λ, P⁻¹, Ginv and every pivot decision are in the slot
// type TS (float64 on Hopper is native, so the f64 slot space of the TPU design
// needs no emulation here).
//
// Per main-loop iteration: threads stride over the m rows for aᵢ·x_d, the
// scaled violation and a block-wide argmax (warp shuffles, then one value per
// warp in shared memory, ties to the lower row); the (n, n) and (ns, ns)
// matvecs go with threads over output rows; the ns² rank-one update with
// threads over entries.  The scalar decisions (t1, t2, do_add, do_drop,
// restart, ...) are taken by thread 0, which holds the loop's scalar state in
// registers and broadcasts through shared memory, with __syncthreads() between
// phases.  Every argmax/argmin breaks ties toward the lower index, and NaN
// counts as the extreme, as jnp.argmax/argmin do.
//
// What bounds it on this card: at headline shapes (n=5, m=101, ns=5) the
// per-iteration latency of ~9 barriers in one small block, not bytes or FLOPs;
// at large shapes (n=33, m=577, ns=8) the scan's m·n reads of A from shared
// memory (19k per iteration).  The design answers with many independent lanes
// in flight (B blocks of ≤ 256 threads; ~90 KB of shared memory at the large
// shape, so two blocks share an SM), device memory touched only at the start
// and the end of a launch, and per-lane exits so a slow lane never holds a
// fast one.  A TMA/wgmma redesign is left to later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;      // ops/_build.py::MAX_WARPS
constexpr int kSlotScalars = 8;   // ops/gi_kernel.py::_SLOT_SCALARS
constexpr int kIntScalars = 16;   // ops/gi_kernel.py::_INT_SCALARS
constexpr double kBig = 1e18;     // ops.qp._BIG: bounds beyond are infinite
constexpr double kTiny = 1e-30;

// slot-type scalar cells
enum { F_SPF, F_T, F_C1, F_C2, F_LAMPN, F_PIV };
// int scalar cells
enum { I_LIVE, I_INS, I_CAND, I_CSIDE, I_MODE, I_APP, I_KW, I_P, I_KB, I_FLAGS };
// I_FLAGS bits of a main-loop iteration
enum { B_ADD = 1, B_DROP = 2, B_RESTART = 4, B_UPDX = 8, B_KEEPSTEP = 16 };

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

template <typename TD, typename TS>
__global__ void __launch_bounds__(32 * kMaxWarps)
gi_solve_kernel(const TS* __restrict__ Pinv, const TD* __restrict__ A,
                const int32_t* __restrict__ lane_ctrl, const TD* __restrict__ q,
                const TD* __restrict__ l, const TD* __restrict__ u,
                int32_t* __restrict__ idx_g, int32_t* __restrict__ side_g,
                uint8_t* __restrict__ vmask_g, TS* __restrict__ Ginv_g,
                const int32_t* __restrict__ widx_g, const int32_t* __restrict__ wside_g,
                const int32_t* __restrict__ wcnt_g, const int32_t* __restrict__ max_it_g,
                TS* __restrict__ x_out, TS* __restrict__ lam_out,
                int32_t* __restrict__ it_out, uint8_t* __restrict__ conv_out,
                int n, int m, int ns, int warm, double tol) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;

  // ---- shared memory, in the order of ops/gi_kernel.py::smem_bytes ----------
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TS* sP = reinterpret_cast<TS*>(smem_raw);  // n*n  P⁻¹
  TS* sG = sP + n * n;                       // ns*ns Ginv
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
  TS* fs = slw + ns;                         // kSlotScalars
  TD* sA = reinterpret_cast<TD*>(fs + kSlotScalars);  // m*n A
  TD* sl = sA + m * n;                       // m
  TD* su = sl + m;                           // m
  TD* srn = su + m;                          // m    row norms
  TD* sAx = srn + m;                         // m    A·x_d of the last scan
  TD* sAact = sAx + m;                       // ns*n slot table, data type
  TD* redv = sAact + ns * n;                 // kMaxWarps
  int* sidx = reinterpret_cast<int*>(redv + kMaxWarps);  // ns
  int* sside = sidx + ns;                    // ns
  int* svm = sside + ns;                     // ns
  int* redi = svm + ns;                      // kMaxWarps
  int* is = redi + kMaxWarps;                // kIntScalars

  const TS eps = static_cast<TS>(tol);
  const TD eps_d = static_cast<TD>(tol);
  const TS tiny = static_cast<TS>(kTiny);
  const TS inf = static_cast<TS>(INFINITY);
  const TD inf_d = static_cast<TD>(INFINITY);
  const TD big = static_cast<TD>(kBig);

  // ---- load the lane ---------------------------------------------------------
  const int c = lane_ctrl[b];
  const TD* Ab = A + (size_t)c * m * n;
  const TS* Pb = Pinv + (size_t)c * n * n;
  for (int e = tid; e < m * n; e += nt) sA[e] = Ab[e];
  for (int e = tid; e < n * n; e += nt) sP[e] = Pb[e];
  for (int i = tid; i < m; i += nt) {
    sl[i] = l[(size_t)b * m + i];
    su[i] = u[(size_t)b * m + i];
  }
  for (int e = tid; e < ns * ns; e += nt) sG[e] = Ginv_g[(size_t)b * ns * ns + e];
  for (int s = tid; s < ns; s += nt) {
    sidx[s] = idx_g[(size_t)b * ns + s];
    sside[s] = side_g[(size_t)b * ns + s];
    svm[s] = vmask_g[(size_t)b * ns + s] != 0;
    slam[s] = TS(0);
  }
  __syncthreads();
  for (int i = tid; i < m; i += nt) {
    TD s2 = TD(0);
    for (int j = 0; j < n; ++j) s2 += sA[i * n + j] * sA[i * n + j];
    srn[i] = sqrt(s2);
  }
  for (int k = tid; k < n; k += nt) {
    TS s = TS(0);
    for (int j = 0; j < n; ++j) s += sP[k * n + j] * static_cast<TS>(q[(size_t)b * n + j]);
    sxun[k] = -s;
    sx[k] = -s;
  }
  for (int e = tid; e < ns * n; e += nt) {
    const int s = e / n, j = e - s * n;
    sAact[e] = svm[s] ? sA[sidx[s] * n + j] : TD(0);
  }

  // thread 0's loop state (the reference's scalar carry)
  int it = 0, done = 0, wpos = 0, inserting = 0;
  const int wcnt = wcnt_g[b];
  const int max_it = max_it_g[b];
  if (tid == 0) {
    done = !(warm || wcnt > 0);
    is[I_LIVE] = !done && it < max_it;
  }
  __syncthreads();

  // ---- warm loop: insert one pending warm row, or KKT jump + wrong-sign drop --
  while (is[I_LIVE]) {
    if (tid == 0) {
      inserting = wpos < wcnt;
      const int wsel = min(wpos, ns - 1);
      is[I_CAND] = widx_g[(size_t)b * ns + wsel];
      is[I_CSIDE] = wside_g[(size_t)b * ns + wsel];
    }
    __syncthreads();
    const int cand = is[I_CAND];
    for (int k = tid; k < n; k += nt) {
      TS s = TS(0);
      for (int j = 0; j < n; ++j) s += sP[k * n + j] * static_cast<TS>(sA[cand * n + j]);
      scol[k] = s;
      sarow[k] = static_cast<TS>(sA[cand * n + k]);
    }
    for (int s = tid; s < ns; s += nt) {
      TS ax = TS(0);
      for (int j = 0; j < n; ++j) ax += static_cast<TS>(sAact[s * n + j]) * sxun[j];
      const TS bnd = static_cast<TS>(sside[s] > 0 ? su[sidx[s]] : sl[sidx[s]]);
      const TS sgn = svm[s] ? static_cast<TS>(sside[s]) : TS(0);
      sdv[s] = svm[s] ? sgn * (ax - bnd) : TS(0);
    }
    __syncthreads();
    const TS cspf = static_cast<TS>(is[I_CSIDE]);
    for (int s = tid; s < ns; s += nt) {
      TS d = TS(0);
      for (int j = 0; j < n; ++j) d += static_cast<TS>(sAact[s * n + j]) * scol[j];
      const TS sgn = svm[s] ? static_cast<TS>(sside[s]) : TS(0);
      sg[s] = svm[s] ? d * sgn * cspf : TS(0);
    }
    __syncthreads();
    for (int s = tid; s < ns; s += nt) {
      TS rr = TS(0), lw = TS(0);
      for (int t = 0; t < ns; ++t) {
        rr += sG[s * ns + t] * sg[t];
        lw += sG[s * ns + t] * sdv[t];
      }
      sr[s] = svm[s] ? rr : TS(0);
      slw[s] = lw;
    }
    __syncthreads();
    if (tid == 0) {
      TS gamma = TS(0), gr = TS(0);
      for (int k = 0; k < n; ++k) gamma += sarow[k] * scol[k];
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
      fs[F_C1] = sc > tiny ? sc : tiny;   // jnp.maximum(sc, tiny)
      fs[F_PIV] = sG[k_w * ns + k_w] > tiny ? sG[k_w * ns + k_w] : tiny;
      is[I_MODE] = ins_ok ? 1 : (wdrop ? 2 : (adopt ? 3 : 0));
      is[I_APP] = app;
      is[I_KW] = k_w;
      wpos += inserting;
      it += 1;
      done = done || adopt;
      is[I_LIVE] = !done && it < max_it;
    }
    __syncthreads();
    const int mode = is[I_MODE];
    const int k_w = is[I_KW];
    if (mode == 2) {
      for (int t = tid; t < ns; t += nt) sck[t] = sG[k_w * ns + t];
    } else if (mode == 3) {
      for (int j = tid; j < n; j += nt) {
        TS s = TS(0);
        for (int t = 0; t < ns; ++t) {
          const TS sgn = svm[t] ? static_cast<TS>(sside[t]) : TS(0);
          s += static_cast<TS>(sAact[t * n + j]) * (sgn * slw[t]);
        }
        stmp[j] = s;
      }
    }
    __syncthreads();
    if (mode == 1) {            // bordering insert of the warm row
      const int app = is[I_APP];
      const TS d = fs[F_C1];
      for (int e = tid; e < ns * ns; e += nt) {
        const int i = e / ns, j = e - i * ns;
        const TS wi = sr[i] - (i == app ? TS(1) : TS(0));
        const TS wj = sr[j] - (j == app ? TS(1) : TS(0));
        sG[e] = sG[e] + wi * wj / d - ((i == app && j == app) ? TS(1) : TS(0));
      }
      for (int j = tid; j < n; j += nt) sAact[app * n + j] = sA[cand * n + j];
      if (tid == 0) {
        sidx[app] = cand;
        sside[app] = is[I_CSIDE];
        svm[app] = 1;
      }
    } else if (mode == 2) {     // drop the most negative multiplier's slot
      const TS piv = fs[F_PIV];
      for (int e = tid; e < ns * ns; e += nt) {
        const int i = e / ns, j = e - i * ns;
        sG[e] = sG[e] - sck[i] * sck[j] / piv + ((i == k_w && j == k_w) ? TS(1) : TS(0));
      }
      if (tid == 0) svm[k_w] = 0;
    } else if (mode == 3) {     // adopt the KKT point of the current set
      for (int k = tid; k < n; k += nt) {
        TS s = TS(0);
        for (int j = 0; j < n; ++j) s += sP[k * n + j] * stmp[j];
        sx[k] = sxun[k] - s;
      }
      for (int s = tid; s < ns; s += nt)
        slam[s] = svm[s] ? (slw[s] > TS(0) ? slw[s] : TS(0)) : TS(0);
    }
    __syncthreads();
  }

  // ---- main loop: violation scan + fused select and pivot step ---------------
  int p = -1, sp = 0, zrun = 0, d1 = -1, d2 = -1, vstall = 0, restarted = 0, feas = 1;
  TS slack = TS(0), lam_p = TS(0);
  __syncthreads();  // every thread has read the warm loop's last I_LIVE
  if (tid == 0) {
    done = 0;
    is[I_LIVE] = it < max_it;
  }
  __syncthreads();
  while (is[I_LIVE]) {
    // -- scan (the work of kmv): aᵢ·x_d, scaled violation, block argmax --
    TD xs2 = TD(0);
    for (int j = 0; j < n; ++j) {
      const TD xd = static_cast<TD>(sx[j]);
      xs2 += xd * xd;
    }
    const TD xnorm = sqrt(xs2);
    TD best = -inf_d;
    int best_i = 0x7fffffff;
    for (int i = tid; i < m; i += nt) {
      TD ax = TD(0);
      for (int j = 0; j < n; ++j) ax += sA[i * n + j] * static_cast<TD>(sx[j]);
      sAx[i] = ax;
      const TD vl = sl[i] > -big ? sl[i] - ax : -inf_d;
      const TD vu = su[i] < big ? ax - su[i] : -inf_d;
      const TD scale = nan_max(srn[i] * xnorm, TD(1));
      const TD v = nan_max(vl, vu) / scale;
      if (before_max(v, i, best, best_i)) { best = v; best_i = i; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const TD ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
      if (before_max(ov, oi, best, best_i)) { best = ov; best_i = oi; }
    }
    if (lane == 0) {
      redv[warp] = best;
      redi[warp] = best_i;
    }
    __syncthreads();
    // -- select (thread 0) --
    int j = 0, opt = 0, cont = 0, fresh = 0, stepping = 0, sp_ = 0;
    TS slack_ = TS(0), lam_p_ = TS(0);
    if (tid == 0) {
      TD bv = redv[0];
      int bi = redi[0];
      for (int w = 1; w < nwarps; ++w)
        if (before_max(redv[w], redi[w], bv, bi)) { bv = redv[w]; bi = redi[w]; }
      j = bi;
      const TD ax = sAx[j];
      const TD vl = sl[j] > -big ? sl[j] - ax : -inf_d;
      const TD vu = su[j] < big ? ax - su[j] : -inf_d;
      opt = bv <= eps_d;
      const int j_side = vu >= vl ? 1 : -1;
      cont = p >= 0;
      fresh = !cont && !opt;
      stepping = cont || fresh;
      is[I_P] = cont ? p : j;
      sp_ = cont ? sp : j_side;
      const TD vj = nan_max(vl, vu);
      slack_ = cont ? slack : static_cast<TS>(nan_max(vj, TD(0)));
      lam_p_ = cont ? lam_p : TS(0);
      fs[F_SPF] = static_cast<TS>(sp_);
    }
    __syncthreads();
    // -- Gram work for the pivot row (slot type) --
    const int pe = is[I_P];
    for (int k = tid; k < n; k += nt) {
      TS s = TS(0);
      for (int jj = 0; jj < n; ++jj) s += sP[k * n + jj] * static_cast<TS>(sA[pe * n + jj]);
      scol[k] = s;
      sarow[k] = static_cast<TS>(sA[pe * n + k]);
    }
    __syncthreads();
    const TS spf = fs[F_SPF];
    for (int s = tid; s < ns; s += nt) {
      TS d = TS(0);
      for (int jj = 0; jj < n; ++jj) d += static_cast<TS>(sAact[s * n + jj]) * scol[jj];
      const TS sgn = svm[s] ? static_cast<TS>(sside[s]) : TS(0);
      sg[s] = svm[s] ? d * sgn * spf : TS(0);
    }
    __syncthreads();
    for (int s = tid; s < ns; s += nt) {
      TS rr = TS(0);
      for (int t = 0; t < ns; ++t) rr += sG[s * ns + t] * sg[t];
      sr[s] = svm[s] ? rr : TS(0);
    }
    __syncthreads();
    // -- step lengths and every decision (thread 0) --
    if (tid == 0) {
      TS gamma = TS(0), gr = TS(0);
      for (int k = 0; k < n; ++k) gamma += sarow[k] * scol[k];
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
      fs[F_T] = t;
      fs[F_C1] = do_add ? TS(1) / (sc > tiny ? sc : tiny) : (do_drop ? TS(-1) / piv : TS(0));
      fs[F_C2] = do_add ? TS(-1) : (do_drop ? TS(1) : TS(0));
      fs[F_LAMPN] = lam_p_new;
      is[I_KB] = k_b;
      is[I_APP] = app;
      is[I_FLAGS] = (do_add ? B_ADD : 0) | (do_drop ? B_DROP : 0) | (restart ? B_RESTART : 0) |
                    (stepping && !infeas_raw && !overflow_raw ? B_UPDX : 0) |
                    (stepping && !overflow_raw ? B_KEEPSTEP : 0);
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
      is[I_CSIDE] = sp_;
      is[I_LIVE] = !done && it < max_it;
    }
    __syncthreads();
    const int flags = is[I_FLAGS];
    const int k_b = is[I_KB];
    for (int t = tid; t < ns; t += nt) sck[t] = sG[k_b * ns + t];
    for (int jj = tid; jj < n; jj += nt) {
      TS s = TS(0);
      for (int t = 0; t < ns; ++t) {
        const TS sgn = svm[t] ? static_cast<TS>(sside[t]) : TS(0);
        s += static_cast<TS>(sAact[t * n + jj]) * (sr[t] * sgn);
      }
      stmp[jj] = s;
    }
    __syncthreads();
    if (flags & B_RESTART) {
      for (int k = tid; k < n; k += nt) sx[k] = sxun[k];
      for (int e = tid; e < ns * ns; e += nt) sG[e] = (e / ns == e % ns) ? TS(1) : TS(0);
      for (int e = tid; e < ns * n; e += nt) sAact[e] = TD(0);
      for (int s = tid; s < ns; s += nt) {
        slam[s] = TS(0);
        sidx[s] = 0;
        sside[s] = 0;
        svm[s] = 0;
      }
    } else {
      const TS t = fs[F_T];
      const int add = flags & B_ADD, drop = flags & B_DROP;
      const int app = is[I_APP];
      if (flags & B_UPDX) {
        for (int k = tid; k < n; k += nt) {
          TS s = TS(0);
          for (int jj = 0; jj < n; ++jj) s += sP[k * n + jj] * stmp[jj];
          sx[k] = sx[k] + t * (s - spf * scol[k]);
        }
      }
      // unified rank-one update: Ginv + c1·aaᵀ + c2·bbᵀ
      const TS c1 = fs[F_C1], c2 = fs[F_C2];
      for (int e = tid; e < ns * ns; e += nt) {
        const int i = e / ns, jj = e - i * ns;
        const TS ai = add ? sr[i] - (i == app ? TS(1) : TS(0)) : sck[i];
        const TS aj = add ? sr[jj] - (jj == app ? TS(1) : TS(0)) : sck[jj];
        const TS bi = (i == (add ? app : k_b)) ? TS(1) : TS(0);
        const TS bj = (jj == (add ? app : k_b)) ? TS(1) : TS(0);
        sG[e] = sG[e] + c1 * (ai * aj) + c2 * (bi * bj);
      }
      if (add)
        for (int jj = tid; jj < n; jj += nt) sAact[app * n + jj] = sA[pe * n + jj];
      // multipliers and slot bits, one thread per slot (reads before writes)
      const TS lam_p_new = fs[F_LAMPN];
      for (int s = tid; s < ns; s += nt) {
        const TS lo = slam[s] - t * sr[s];
        const TS lam_step = svm[s] ? (lo > TS(0) ? lo : TS(0)) : slam[s];
        if (add) {
          slam[s] = s == app ? lam_p_new : lam_step;
          if (s == app) {
            svm[s] = 1;
            sidx[s] = pe;
            sside[s] = is[I_CSIDE];
          }
        } else if (drop) {
          slam[s] = lam_step * (TS(1) - (s == k_b ? TS(1) : TS(0)));
          if (s == k_b) svm[s] = 0;
        } else if (flags & B_KEEPSTEP) {
          slam[s] = lam_step;
        }
      }
    }
    __syncthreads();
  }

  // ---- write back ---------------------------------------------------------------
  for (int k = tid; k < n; k += nt) x_out[(size_t)b * n + k] = sx[k];
  for (int s = tid; s < ns; s += nt) {
    lam_out[(size_t)b * ns + s] = slam[s];
    idx_g[(size_t)b * ns + s] = sidx[s];
    side_g[(size_t)b * ns + s] = sside[s];
    vmask_g[(size_t)b * ns + s] = static_cast<uint8_t>(svm[s] != 0);
  }
  for (int e = tid; e < ns * ns; e += nt) Ginv_g[(size_t)b * ns * ns + e] = sG[e];
  if (tid == 0) {
    it_out[b] = it;
    conv_out[b] = static_cast<uint8_t>(done && feas);
  }
}

template <typename TD, typename TS>
int launch(const void* Pinv, const void* A, const void* lane_ctrl, const void* q, const void* l,
           const void* u, void* idx, void* side, void* vmask, void* Ginv, const void* widx,
           const void* wside, const void* wcnt, const void* max_it, void* x, void* lam, void* it,
           void* conv, int B, int n, int m, int ns, int warm, int threads, int smem_bytes,
           double tol, void* stream) {
  if (B <= 0) return 0;
  if (threads <= 0 || threads % 32 != 0 || threads > 32 * kMaxWarps) return (int)cudaErrorInvalidValue;
  if (ns < 1 || ns > n) return (int)cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(gi_solve_kernel<TD, TS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  gi_solve_kernel<TD, TS><<<B, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TS*>(Pinv), static_cast<const TD*>(A),
      static_cast<const int32_t*>(lane_ctrl), static_cast<const TD*>(q),
      static_cast<const TD*>(l), static_cast<const TD*>(u), static_cast<int32_t*>(idx),
      static_cast<int32_t*>(side), static_cast<uint8_t*>(vmask), static_cast<TS*>(Ginv),
      static_cast<const int32_t*>(widx), static_cast<const int32_t*>(wside),
      static_cast<const int32_t*>(wcnt), static_cast<const int32_t*>(max_it),
      static_cast<TS*>(x), static_cast<TS*>(lam), static_cast<int32_t*>(it),
      static_cast<uint8_t*>(conv), n, m, ns, warm, tol);
  return (int)cudaGetLastError();
}

}  // namespace

#define MPC_GI_ENTRY(NAME, TD, TS)                                                          \
  extern "C" int NAME(const void* Pinv, const void* A, const void* lane_ctrl, const void* q, \
                      const void* l, const void* u, void* idx, void* side, void* vmask,      \
                      void* Ginv, const void* widx, const void* wside, const void* wcnt,     \
                      const void* max_it, void* x, void* lam, void* it, void* conv, int B,   \
                      int n, int m, int ns, int warm, int threads, int smem_bytes,           \
                      double tol, void* stream) {                                            \
    return launch<TD, TS>(Pinv, A, lane_ctrl, q, l, u, idx, side, vmask, Ginv, widx, wside, \
                          wcnt, max_it, x, lam, it, conv, B, n, m, ns, warm, threads,        \
                          smem_bytes, tol, stream);                                         \
  }

MPC_GI_ENTRY(mpc_gi_solve_f32_f64, float, double)
MPC_GI_ENTRY(mpc_gi_solve_f32_f32, float, float)
MPC_GI_ENTRY(mpc_gi_solve_f64_f64, double, double)
