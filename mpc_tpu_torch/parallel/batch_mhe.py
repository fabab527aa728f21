"""Batched MovingHorizonEstimator: many estimation problems in lockstep
(counterpart of ``mpc_tpu/parallel/batch_mhe.py``).

The measurement/input/state windows live ON THE DEVICE; a serving step
uploads only ``(ym, u_prev, d)`` and the host-built shared matrices of the
period, in one copy.  The window count ``Nk`` is the same for every lane,
so the host keeps it and the shift/insert bookkeeping is plain slot copies
(never an arithmetic blend: empty Y0m slots are NaN, and NaN·0 = NaN).

* LinModel + SingleShooting (MultipleShooting condenses exactly), no custom
  constraints: the window QP's H̃ depends only on the SHARED (mask_w, invP̄)
  — one host NumPy f64 build per step serves every lane — and the
  constraint matrix is CONSTANT (construct-time prediction matrices,
  ``estimators/mhe_fast.py``).  Per-lane work is the (q, l, u) assembly and
  ONE GI solve over the fleet, every lane reading the one shared H̃⁻¹ and A
  (``lane_ctrl`` all zeros), warm-started from the previous step's
  slot-shifted duals.
* A NaN measurement in a window (diagonal invR): the same solve with a
  per-lane H̃ and H̃⁻¹ (a Sherman–Morrison downdate per lane) while any
  window may hold the NaN.  The GI solve reads them through the identity
  lane map and the one shared A through its A map (``a_ctrl`` all zeros).
* Otherwise (``solver="general"``, NonLinModel, a non-diagonal invR with a
  NaN): the template's general window solver over the lane axis.  A
  NonLinModel fleet advances each lane's arrival covariance on the device
  with the EKF-linearized covestim law.

The arrival-covariance recursion of a LinModel fleet is data-independent
and stays on the host (NumPy f64).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch
from torch.func import jacrev, vmap

from ..estimators import mhe_fast
from ..estimators.kalman import kf_correct
from ..estimators.mhe import MovingHorizonEstimator, upload
from ..models import LinModel
from ..ops.gi_kernel import gi_solve
from ..ops.admm_kernel import admm_sweep
from ..ops.qp import solve_qp
from ..ops.qp_active import solve_qp_active
from ..utils.lanes import identity_lanes
from ..utils.small_linalg import inv_spd_small
from .mesh import LaneShards


def _nan_any(a):
    """Whether ``a`` (NumPy or tensor) holds a NaN; a tensor costs one
    host sync."""
    return bool(torch.isnan(a).any()) if torch.is_tensor(a) else bool(np.isnan(a).any())


class BatchedMHE:
    """Lockstep batch of one MHE problem over many measurement streams.

    ``step(ym, u_prev)`` advances every stream's window and solves.
    ``direct=True`` (filter form) only.  Time-varying (capital-form) bounds
    are honored once the window is FULL; during the fill phase the fleet
    does not END-align per-slot bounds (the reference's documented
    behaviour; the single-stream estimator implements trunc_bounds).

    ``solver``: ``"auto"`` (default) uses the construct-time-matrix + GI
    fast path when applicable (LinModel, SingleShooting or
    MultipleShooting, nc == 0) and the per-lane NaN variant or the general
    solver for NaN steps; ``"general"`` forces the general solver.

    ``gi_max_active``: slot-buffer cap of the GI fast path (see
    :func:`mpc_tpu_torch.ops.qp_active.solve_qp_active`); lanes whose true
    active set overflows the cap report ``converged=False`` in ``last_ok``.
    Default: full size.

    **NaN semantics (fleet approximation, as the reference)**: the per-lane
    V-row masking of NaN measurements is exact.  The ARRIVAL covariance of
    a LinModel fleet is fleet-shared and advanced by the data-independent
    host recursion, which keeps the arrival correction when a NaN leaves
    the window (the single-stream estimator skips it).

    ``gi_chunks`` is validated as the reference validates it (``batch %
    gi_chunks == 0``) and changes nothing: the reference splits its GI solve
    into lane ranges so that each range's lockstep pivot loop exits at its
    own slowest lane, but the GI kernel runs every lane on its own warp and
    has no lockstep tail, so the fleet runs one solve; it is refused with a
    mesh, as in the reference.  ``mesh`` (``parallel/mesh.py``) shards the
    streams: a sub-fleet a shard holds its lanes' windows and runs their
    window and solve on its device, while the host arrival recursion and
    the H̃ build stay here, once for the fleet; the fleet then lives on
    ``mesh[0]``.

    ``dtype`` is the data dtype (float64 by default; ``torch.float32`` is
    the reference's f32 fleet, with float64 GI slots and H̃⁻¹).  The fleet
    lives on the template's device.  ``gi`` and ``sweep`` are the per-lane
    GI solve and the ADMM sweep its QPs run (checks swap in the plain
    versions).
    """

    def __init__(self, template: MovingHorizonEstimator, batch: int,
                 mesh=None, dtype=None, solver: str = "auto",
                 gi_max_active: int | None = None, gi_chunks: int = 1):
        if not template.direct:
            raise ValueError("BatchedMHE supports the direct (p=0) form")
        if solver not in ("auto", "general"):
            raise ValueError("solver must be 'auto' or 'general'")
        if int(gi_chunks) < 1:
            raise ValueError("gi_chunks must be ≥ 1")
        if int(gi_chunks) > 1 and (mesh is not None or int(batch) % int(gi_chunks)):
            raise ValueError("gi_chunks requires a single-device fleet "
                             "with batch % gi_chunks == 0")
        self.t = t = template
        self.B = B = int(batch)
        self.dtype = torch.float64 if dtype is None else dtype
        if self.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
        self.mesh = None if mesh is None else LaneShards(mesh, B)
        self.device = dev = t.device if mesh is None else self.mesh.home
        self.gi, self.sweep = gi_solve, admm_sweep
        self._configure(solver, gi_max_active)
        if self.mesh is None:
            self._place(B, dev)
            self._subs = [self]
        else:
            # one sub-fleet a shard, holding its lanes' windows and solving
            # them on its device; the host mirror below stays here, once
            self._subs = [self._sub(self.mesh.size, d) for d in self.mesh.devices]
        # host mirrors of the data-independent parts (LinModel covestim);
        # a NonLinModel fleet keeps a per-lane P̄ on the device instead
        self.Nk = 0
        self.P_arr = t.P0_hat.copy()
        self.invP_arr = np.linalg.inv(self.P_arr)
        self._nan_guard = 0       # steps until NaN-touched windows drain
        ce = t.covestim
        if self._lin:
            self._P_correct = lambda P: _kf_P_correct(P, ce.Cm_hat, ce.R_hat)
            self._P_predict = lambda P: ce.A_hat @ P @ ce.A_hat.T + ce.Q_hat
        self.last_ok = torch.ones(B, dtype=torch.bool, device=dev)
        self.last_pivots = torch.zeros((), dtype=torch.int32, device=dev)
        self.last_iters = torch.zeros(2, dtype=torch.int32, device=dev)

    def _configure(self, solver, gi_max_active):
        """The fleet's routes and the host-side construct-time matrices."""
        t = self.t
        self._solver = solver
        self._lin = isinstance(t.model, LinModel)
        # MS windows ride the SAME fast path: for a LinModel the defect
        # equalities are linear, so condensing X̂ out is exact — the fleet
        # carries the SS-form decisions [ϵ; x̂arr; Ŵ] and the MS layout is
        # reconstructed only for the general-solver fallback
        self._fast = solver == "auto" and self._lin and t.nc == 0
        self._ms_cond = bool(self._fast and t.is_ms)
        self._gi_cap = gi_max_active
        self._nan_fast_ok = False
        if self._fast:
            self._mats = mhe_fast.build_pred_mats(t)
            # NaN-tolerant fast variant: with a DIAGONAL invR, a NaN element
            # removes exactly one scalar V row from that lane's window QP — a
            # low-rank downdate of the shared H̃
            invR_np = np.asarray(t.invR, float)
            self._nan_fast_ok = bool(np.allclose(invR_np, np.diag(np.diag(invR_np))))

    def _sub(self, B, dev):
        """A sub-fleet of ``B`` lanes on ``dev`` (one shard of a mesh)."""
        sub = object.__new__(BatchedMHE)
        sub.t, sub.B, sub.dtype, sub.device = self.t, B, self.dtype, dev
        sub.mesh, sub.gi, sub.sweep = None, self.gi, self.sweep
        sub._configure(self._solver, self._gi_cap)
        sub._place(B, dev)
        return sub

    def _place(self, B, dev):
        """The lanes' windows and the solver constants on ``dev``."""
        t, dt = self.t, self.dtype
        He, nym, nx = t.He, t.nym, t.nx_hat
        nu, nd = t.model.nu, t.model.nd
        z = lambda *s: torch.zeros(s, dtype=dt, device=dev)
        # ---- device-resident per-stream window state ----------------------
        self._state = dict(
            Y0m=torch.full((B, He, nym), float("nan"), dtype=dt, device=dev),
            U0=z(B, He, nu), D0=z(B, He + 1, nd), X0_old=z(B, He, nx),
            # condensed SS-form decisions for fast MS fleets (X̂ exactly
            # eliminated); the full t.nZt layout otherwise
            Z=z(B, (t.n_eps + nx + He * nx) if self._ms_cond else t.nZt),
            x0_hat=z(B, nx), pending_u0=z(B, nu))
        # ---- step-invariant solver constants (uploaded once) --------------
        consts = dict(
            invQ=t.invQ, invR=t.invR, fop_m_xop=t.fop_hat - t.xop_hat,
            Xmin=t.X_min, Xmax=t.X_max, Wmin=t.W_min, Wmax=t.W_max,
            Vmin=t.V_min, Vmax=t.V_max, C_xmin=t.C_xmin, C_xmax=t.C_xmax,
            C_wmin=t.C_wmin, C_wmax=t.C_wmax, C_vmin=t.C_vmin, C_vmax=t.C_vmax,
            yop_m=t.model.yop[np.asarray(t.i_ym, int)], uop=t.model.uop,
            dop=t.model.dop, xop_hat=t.xop_hat)
        if self._fast:
            mats = self._mats
            A_rows = mhe_fast.build_rows(mats, t.C_xmin, t.C_xmax, t.C_wmin,
                                         t.C_wmax, t.C_vmin, t.C_vmax)
            self._m_rows = A_rows.shape[0]
            consts.update(A_rows=A_rows, Su=mats["Su"], Sd=mats["Sd"], s1=mats["s1"],
                          Gy=mats["Gy"], Gx=mats["Gx"], Cm=mats["Cm"], Ddm=mats["Ddm"])
            self._state["y_warm"] = z(B, self._m_rows)
            self._asm = mhe_fast.make_assembler(mats)
            if self._nan_fast_ok:
                self._ddn = mhe_fast.make_nan_downdate(mats)
                self._r_diag = torch.as_tensor(2.0 * np.diag(np.asarray(t.invR, float)),
                                               dtype=torch.float64, device=dev)
        self._c = upload(consts, dt, dev)
        # the lane maps, one tensor each for the fleet's life (the kernels'
        # lane grouping is cached per map): every lane reads controller 0
        # (the shared H̃⁻¹ and A), or its own
        self._lc0 = torch.zeros(B, dtype=torch.int32, device=dev)
        self._lane = identity_lanes(B, dev)
        if not self._lin:
            # per-lane in-graph arrival covariance: the reference advances
            # P̄ with the covestim at each stream's own arrival state
            # (mhe/execute.jl:729-779); here the EKF-linearized law (exactly
            # the covestim=ExtendedKalmanFilter recursion incl. its per-lane
            # NaN skip; a UKF covestim is approximated by it)
            ce = t.covestim
            self._ce = upload(dict(Q=ce.Q_hat, R=ce.R_hat), dt, dev)
            f_hat, h_hat = t.tensor_fns(dt, dev)
            i_ym = torch.as_tensor(list(t.i_ym), device=dev)
            h_m = lambda x, d: h_hat(x, d)[i_ym]
            self._h_m, self._jh = vmap(h_m), vmap(jacrev(h_m))
            self._jf = vmap(jacrev(f_hat))
            self._state["P_arr"] = upload(dict(P=t.P0_hat), dt, dev)["P"].repeat(B, 1, 1)

    @property
    def state(self):
        """The lanes' device state dict (the lane axis first; gathered on
        ``mesh[0]`` for a sharded fleet)."""
        if self.mesh is None:
            return self._state
        return {k: self.mesh.gather([sub._state[k] for sub in self._subs])
                for k in self._subs[0]._state}

    @state.setter
    def state(self, st):
        if self.mesh is None:
            self._state = st
            return
        parts = {k: self.mesh.split(v) for k, v in st.items()}
        for i, sub in enumerate(self._subs):
            sub._state = {k: parts[k][i] for k in st}

    # ------------------------------------------------------------------
    def _shift_insert(self, st, ym, u_prev, d, has_u, Nk_prev):
        """Window shift + insert on the device (the reference's
        add_data_windows!, mhe/execute.jl:497-547)."""
        t, c = self.t, self._c
        He, nx, ne = t.He, t.nx_hat, t.n_eps
        y0m, d0 = ym - c["yop_m"], d - c["dop"]
        pend = u_prev - c["uop"] if has_u else st["pending_u0"]
        moving = Nk_prev + 1 > He
        x0_old = st["x0_hat"]
        Y0m, U0, D0, X0o, Z = (st[k] for k in ("Y0m", "U0", "D0", "X0_old", "Z"))
        if moving:
            sh = lambda a: torch.cat([a[:, 1:], a[:, -1:]], 1)
            Y0m, U0, D0, X0o = sh(Y0m), sh(U0), sh(D0), sh(X0o)
            if He > 1:
                # warm start shift: the X̂ block (full-MS layout only) then
                # the Ŵ block (mhe/transcription.jl:936-1075)
                ms_full = t.is_ms and not self._ms_cond
                wo = ne + nx + (He * nx if ms_full else 0)
                Z = Z.clone()
                if ms_full:
                    xo = ne + nx
                    Z[:, xo:xo + (He - 1) * nx] = Z[:, xo + nx:xo + He * nx].clone()
                Z[:, wo:wo + (He - 1) * nx] = Z[:, wo + nx:].clone()
                Z[:, wo + (He - 1) * nx:] = 0.0
            Nk = Nk_prev
        else:
            Y0m, U0, D0, X0o = Y0m.clone(), U0.clone(), D0.clone(), X0o.clone()
            Nk = Nk_prev + 1
        i = Nk - 1
        Y0m[:, i], X0o[:, i], U0[:, i] = y0m, x0_old, pend
        # measured disturbance goes to slot i+1 of the He+1-slot D0 window
        D0[:, i + 1] = d0
        x_arr = X0o[:, 0]
        if moving:
            Z = Z.clone()
            Z[:, ne:ne + nx] = x_arr
        mask_w = (torch.arange(He, device=ym.device) < Nk).to(ym.dtype)
        return Y0m, U0, D0, X0o, Z, pend, x_arr, Nk, mask_w, moving

    def _advance_fast(self, st, ym, u_prev, d, has_u, invP, Nk_prev, Pq, Pinv, nan):
        """The fast path (``nan``: the per-lane H̃-downdate variant)."""
        t, c = self.t, self._c
        He, nx = t.He, t.nx_hat
        (Y0m, U0, D0, X0o, Z, pend, x_arr, Nk, mask_w,
         moving) = self._shift_insert(st, ym, u_prev, d, has_u, Nk_prev)
        y0 = mhe_fast.shift_warm_duals(self._mats, st["y_warm"], moving)
        Y0m_nn = torch.nan_to_num(Y0m)
        if not nan:
            q, l, u, cx, _ = self._asm(c, U0, D0, Y0m_nn, x_arr, mask_w, invP)
            # every lane reads the shared H̃⁻¹ and A
            sol = solve_qp_active(Pq[None], q, c["A_rows"][None], l, u, y0=y0,
                                  lane_ctrl=self._lc0, cache=dict(gic_Pinv=Pinv[None]),
                                  max_active=self._gi_cap, solve=self.gi)
        else:
            finite = torch.isfinite(Y0m)
            mask_v = mask_w[None, :, None] * finite.to(mask_w.dtype)     # (B, He, nym)
            w_nan = (self._r_diag * ((mask_w[None, :, None] > 0) & ~finite)
                     ).reshape(self.B, -1)
            Pq_l, Pinv_l = self._ddn(Pq, Pinv, w_nan)
            q, l, u, cx, _ = self._asm(c, U0, D0, Y0m_nn, x_arr, mask_w, invP, mask_v=mask_v)
            # per-lane H̃ and H̃⁻¹ through the identity map; the shared A
            # through the A map, as the reference's vmap closes over A_rows
            sol = solve_qp_active(Pq_l, q, c["A_rows"][None], l, u, y0=y0,
                                  lane_ctrl=self._lane, a_ctrl=self._lc0,
                                  cache=dict(gic_Pinv=Pinv_l), max_active=self._gi_cap,
                                  solve=self.gi)
        x_s, y_s, conv, its = sol.x, sol.y, sol.converged, sol.iters
        # failed lanes (slot-cap overflow / pivot-cap exhaustion) must NOT
        # contaminate persistent state: keep the shifted warm-start Z and
        # cold-start their duals next step
        okl = conv[:, None]
        Zt = torch.where(okl, x_s, Z)
        Xf = Zt @ c["Gx"].T + cx
        x_new = Xf.reshape(-1, He, nx)[:, min(max(Nk - 1, 0), He - 1)]
        new_st = dict(st, Y0m=Y0m, U0=U0, D0=D0, X0_old=X0o, Z=Zt, x0_hat=x_new,
                      pending_u0=pend, y_warm=torch.where(okl, y_s, 0.0))
        return new_st, x_new + c["xop_hat"], conv, its.max()

    def _params(self, Y0m, U0, D0, mask_w, x_arr, invP):
        """The template solver's params over the lanes."""
        c = self._c
        p = {k: c[k] for k in ("invQ", "invR", "fop_m_xop", "Xmin", "Xmax", "Wmin", "Wmax",
                               "Vmin", "Vmax", "C_xmin", "C_xmax", "C_wmin", "C_wmax",
                               "C_vmin", "C_vmax")}
        mask_v = (mask_w[None, :, None] > 0) & torch.isfinite(Y0m)
        p.update(U=U0, D=D0, Y0m=torch.nan_to_num(Y0m), mask_w=mask_w, mask_v=mask_v,
                 x_arr_prior=x_arr, invP=invP.expand(self.B, -1, -1))
        return p

    def _solve_general(self, p, Z, Nk):
        return self.t._solve_fn(p, Z, self._lane, Nk,
                                solve_gi=partial(solve_qp_active, solve=self.gi),
                                solve_admm=partial(solve_qp, sweep=self.sweep))

    def _advance(self, st, ym, u_prev, d, has_u, invP, Nk_prev):
        """General backend: the template's window solver over the lanes."""
        t, c = self.t, self._c
        ne, nx, He = t.n_eps, t.nx_hat, t.He
        (Y0m, U0, D0, X0o, Z, pend, x_arr, Nk, mask_w,
         moving) = self._shift_insert(st, ym, u_prev, d, has_u, Nk_prev)
        if self._ms_cond:
            # fast-MS fleet falling back to the general solver: the state
            # carries the CONDENSED [ϵ; x̂arr; Ŵ] decisions — reinsert the
            # exactly-eliminated X̂ block from the rollout (Gx·Z + c_x) and
            # condense back after the solve
            cx = (U0.reshape(self.B, -1) @ c["Su"].T
                  + D0[:, :-1].reshape(self.B, -1) @ c["Sd"].T + c["s1"])
            Z = torch.cat([Z[:, :ne + nx], Z @ c["Gx"].T + cx, Z[:, ne + nx:]], 1)
        Zt, x_new, _, _, _, ok, its = self._solve_general(
            self._params(Y0m, U0, D0, mask_w, x_arr, invP), Z, Nk)
        if self._ms_cond:
            Zt = torch.cat([Zt[:, :ne + nx], Zt[:, ne + nx + He * nx:]], 1)
        new_st = dict(st, Y0m=Y0m, U0=U0, D0=D0, X0_old=X0o, Z=Zt, x0_hat=x_new,
                      pending_u0=pend)
        return new_st, x_new + c["xop_hat"], ok, its

    def _advance_nl(self, st, ym, u_prev, d, has_u, Nk_prev):
        """NonLinModel fleet: window bookkeeping, the per-lane EKF-linearized
        arrival covariance and the GN window solve."""
        t, c = self.t, self._c
        (Y0m, U0, D0, X0o, Z, pend, x_arr, Nk, mask_w,
         moving) = self._shift_insert(st, ym, u_prev, d, has_u, Nk_prev)
        P1 = st["P_arr"]
        if moving:
            d0 = D0[:, 0]
            _, P1 = kf_correct(x_arr, P1, self._h_m(x_arr, d0), Y0m[:, 0],
                               self._jh(x_arr, d0), self._ce["R"])
        Zt, x_new, _, _, _, ok, its = self._solve_general(
            self._params(Y0m, U0, D0, mask_w, x_arr, inv_spd_small(P1)), Z, Nk)
        if Nk >= t.He:
            F = self._jf(x_arr, U0[:, 0], D0[:, 0])
            Pn = F @ P1 @ F.mT + self._ce["Q"]
            P1 = 0.5 * (Pn + Pn.mT)
        new_st = dict(st, Y0m=Y0m, U0=U0, D0=D0, X0_old=X0o, Z=Zt, x0_hat=x_new,
                      pending_u0=pend, P_arr=P1)
        return new_st, x_new + c["xop_hat"], ok, its

    # ------------------------------------------------------------------
    def _host_period(self, moving, use_fast):
        """The host mirror of one period of a LinModel fleet: P̄ corrected
        at a moving window (before the solve uses invP̄), the shared H̃ and
        H̃⁻¹ of the fast path, the window count and the predict once the
        window is full.  Returns ``(invP, Pq, Pinv)`` of the period."""
        t = self.t
        if moving:
            self.P_arr = self._P_correct(self.P_arr)
            self.invP_arr = np.linalg.inv(self.P_arr)
        invP = self.invP_arr
        Pq = Pinv = None
        if use_fast:
            Nk_next = t.He if moving else self.Nk + 1
            mask_w = (np.arange(t.He) < Nk_next).astype(float)
            Pq, Pinv = mhe_fast.build_step_qp(self._mats, mask_w, invP, t.invQ,
                                              t.invR, t.Cwt)
        if not moving:
            self.Nk += 1
        # update_cov! predict once the window is full (updatestate cadence)
        if self.Nk == t.He:
            self.P_arr = self._P_predict(self.P_arr)
            self.invP_arr = np.linalg.inv(self.P_arr)
        return invP, Pq, Pinv

    def _inputs(self, ym, u_prev, d, lead=()):
        """(ym, u_prev, d) on the device in the data dtype, zeros for the
        missing ones; host arrays in one upload."""
        t, dt, dev = self.t, self.dtype, self.device
        shp = lambda n: lead + (self.B, n)
        host = {}
        out = {}
        for k, a, n in (("ym", ym, t.nym), ("u", u_prev, t.model.nu), ("d", d, t.model.nd)):
            if a is None:
                out[k] = torch.zeros(shp(n), dtype=dt, device=dev)
            elif torch.is_tensor(a):
                out[k] = a.to(device=dev, dtype=dt)
            else:
                host[k] = np.asarray(a, float).reshape(shp(n))
        if host:
            out.update(upload(host, dt, dev))
        return out["ym"], out["u"], out["d"]

    def _run(self, ym, u, d, has_u, route, Nk_prev, invP=None, Pq=None, Pinv=None):
        """One period of this (sub-)fleet's lanes on its device by ``route``
        ("fast", "nan", "gen", "nl") from the window count ``Nk_prev``:
        ``(x̂, converged, GI pivots or None, GN iterations or None)``."""
        piv = its = None
        if route in ("fast", "nan"):
            self._state, x_abs, ok, piv = self._advance_fast(
                self._state, ym, u, d, has_u, invP, Nk_prev, Pq, Pinv, route == "nan")
        elif route == "gen":
            st = {k: v for k, v in self._state.items() if k != "y_warm"}
            new_st, x_abs, ok, its = self._advance(st, ym, u, d, has_u, invP, Nk_prev)
            if self._fast:
                # a general step invalidates the fast path's dual warm start
                new_st["y_warm"] = torch.zeros_like(self._state["y_warm"])
            self._state = new_st
        else:
            self._state, x_abs, ok, its = self._advance_nl(self._state, ym, u, d, has_u,
                                                           Nk_prev)
        return x_abs, ok, piv, its

    def _inputs_split(self, ym, u_prev, d, lead=()):
        """Per sub-fleet ``(ym, u_prev, d)`` on its device (``_inputs``):
        host arrays are sliced on the lane axis and each shard uploads its
        slice, tensors go through the mesh's split."""
        if self.mesh is None:
            return [self._inputs(ym, u_prev, d, lead)]
        k, dim = self.mesh.k, len(lead)
        sp = lambda a: [None] * k if a is None else self.mesh.split(
            a if torch.is_tensor(a) else np.asarray(a, float).reshape(lead + (self.B, -1)), dim)
        return [sub._inputs(*x, lead) for sub, *x in zip(self._subs, sp(ym), sp(u_prev), sp(d))]

    def _period(self, ins, has_u, route, Nk_prev, mats):
        """One period of every lane: ``ins`` and ``mats`` (invP, Pq, Pinv
        on the device in the solve's dtypes) per sub-fleet; returns x̂ on
        the fleet's device and sets ``last_ok``, ``last_pivots`` (fast
        path) or ``last_iters`` (general path)."""
        outs = []
        for sub, x, m in zip(self._subs, ins, mats):
            sub.gi, sub.sweep = self.gi, self.sweep
            outs.append(sub._run(*x, has_u, route, Nk_prev, *m))
        cat = (lambda a: a[0]) if self.mesh is None else self.mesh.gather
        x_abs, ok = cat([o[0] for o in outs]), cat([o[1] for o in outs])
        if outs[0][2] is not None:
            self.last_pivots = (outs[0][2] if self.mesh is None else
                                torch.stack([o[2].to(self.device) for o in outs]).max())
        if outs[0][3] is not None:
            its = cat([o[3] for o in outs])
            self.last_iters = torch.stack([its.max(), its.sum() // self.B])
        self.last_ok = ok
        return x_abs

    def _host_mats(self, arrays, dt, use_fast):
        """The period's host matrices (``invP``, and ``Pq``, ``Pinv`` on the
        fast path; float64, any leading axes) uploaded once per device:
        ``[(invP, Pq, Pinv)]`` per sub-fleet, invP and Pq in ``dt``."""
        def put(dev):
            m = upload(arrays, torch.float64, dev)
            return (m["invP"].to(dt), m["Pq"].to(dt) if use_fast else None,
                    m.get("Pinv"))
        return [put(self.device)] if self.mesh is None else self.mesh.per_device(put)

    def step(self, ym, u_prev=None, d=None):
        """Append measurements for every stream and solve in lockstep.
        ``u_prev`` is the input applied at the previous step (B, nu); ``d``
        the current measured disturbances (B, nd) when the model has them
        (window slot i+1, mirroring add_data_windows!).  Inputs are NumPy
        arrays or tensors (a tensor ``ym`` costs one host sync for the NaN
        routing).  Returns the absolute state estimates (B, nx̂) on the
        device; ``last_ok`` holds the per-lane converged flags,
        ``last_pivots`` the most GI pivots of a lane on the fast path and
        ``last_iters`` [max, sum // B] of the lanes' Gauss–Newton
        iterations on the general path."""
        t = self.t
        has_u = u_prev is not None
        moving = (self.Nk + 1) > t.He
        ins = self._inputs_split(ym, u_prev, d)
        if not self._lin:
            x = self._period(ins, has_u, "nl", self.Nk, [()] * len(ins))
            if not moving:
                self.Nk += 1
            return x
        # NaN measurements change per-lane V-row weights → the per-lane
        # H̃-downdate fast variant while any window may hold a NaN (diag
        # invR), else the general solver until the NaNs drain (He MOVING
        # steps — a NaN inserted during the fill phase only starts
        # shifting out once the window moves)
        if _nan_any(ym):
            self._nan_guard = t.He
        elif self._nan_guard and moving:
            self._nan_guard -= 1
        nan_live = self._nan_guard > 0
        use_fast = self._fast and (not nan_live or self._nan_fast_ok)
        Nk_prev = self.Nk
        invP, Pq, Pinv = self._host_period(moving, use_fast)
        mats = self._host_mats(dict(invP=invP, **({"Pq": Pq, "Pinv": Pinv} if use_fast
                                                  else {})), self.dtype, use_fast)
        route = ("nan" if nan_live else "fast") if use_fast else "gen"
        return self._period(ins, has_u, route, Nk_prev, mats)

    def multistep(self, ym_seq, u_prev_seq=None, d_seq=None):
        """K estimation periods with ONE upload (serving mode): ``ym_seq``
        (K, B, nym); ``u_prev_seq`` optional (K, B, nu) — the input applied
        before each period; ``d_seq`` optional (K, B, nd).  Returns the
        stacked absolute estimates (K, B, nx̂) on the device; the same as K
        successive ``step`` calls.

        The host-side per-period data — the data-independent
        arrival-covariance recursion, the window counts and (fast path) the
        shared H̃ and its inverse — is built for all K periods first and
        shipped with the inputs.  A NaN anywhere in the sequence routes the
        WHOLE dispatch through the per-lane-H̃ NaN variant (diag invR) or
        the general solver (the reference's routing)."""
        t = self.t
        K = len(ym_seq)
        has_u = u_prev_seq is not None
        ins = self._inputs_split(ym_seq, u_prev_seq, d_seq, lead=(K,))
        at = lambda k: [tuple(a[k] for a in x) for x in ins]
        if not self._lin:
            X = []
            for k in range(K):
                moving = (self.Nk + 1) > t.He
                X.append(self._period(at(k), has_u, "nl", self.Nk, [()] * len(ins)))
                if not moving:
                    self.Nk += 1
            return torch.stack(X)
        seq_nan = _nan_any(ym_seq)
        nan_live = seq_nan or self._nan_guard > 0
        use_fast = self._fast and (not nan_live or self._nan_fast_ok)
        route = ("nan" if nan_live else "fast") if use_fast else "gen"
        # ---- host mirror: K-period recursion (data-independent) ----------
        host, Nk_prevs, movings, last_nan_k = [], [], [], -1
        ym_host = ym_seq.cpu().numpy() if torch.is_tensor(ym_seq) else np.asarray(ym_seq)
        for k in range(K):
            moving = (self.Nk + 1) > t.He
            movings.append(moving)
            Nk_prevs.append(self.Nk)
            host.append(self._host_period(moving, use_fast))
            if seq_nan and np.isnan(ym_host[k]).any():
                last_nan_k = k
        # NaN drain accounting: guard = He minus the MOVING periods since
        # the last NaN insertion (NaNs only shift out of a moving window)
        if last_nan_k >= 0:
            self._nan_guard = max(0, t.He - sum(movings[last_nan_k + 1:]))
        elif self._nan_guard:
            self._nan_guard = max(0, self._nan_guard - sum(movings))
        arrays = {"invP": np.stack([h[0] for h in host])}
        if use_fast:
            arrays.update(Pq=np.stack([h[1] for h in host]), Pinv=np.stack([h[2] for h in host]))
        mats = self._host_mats(arrays, self.dtype, use_fast)
        X = []
        for k in range(K):
            mk = [tuple(None if a is None else a[k] for a in m) for m in mats]
            X.append(self._period(at(k), has_u, route, Nk_prevs[k], mk))
        return torch.stack(X)


def _kf_P_correct(P, Cm, R):
    PCt = P @ Cm.T
    M = Cm @ PCt + R
    K = np.linalg.solve(M.T, PCt.T).T
    Pc = (np.eye(P.shape[0]) - K @ Cm) @ P
    return 0.5 * (Pc + Pc.T)
