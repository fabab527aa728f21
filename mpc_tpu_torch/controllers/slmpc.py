"""SLMPC — successive-linearization adaptive MPC (counterpart of
``mpc_tpu/controllers/slmpc.py``).

Each control period is one step over a leading lane axis, on the device:

    EKF correction with the output Jacobian at the prior estimate
      → ``torch.func.jacfwd`` linearization of the discretized f and of h
        at the corrected estimate (``vmap`` over the lanes)
      → augmented matrices (the integrator blocks are static structure)
      → condensed prediction matrices from the Â-power products
      → H̃/q̃ and constraint rows → uncached QP (Goldfarb–Idnani or ADMM,
        both through the hand-written kernels on the GPU)
      → receding input → EKF prediction with the fresh Jacobians

Every lane has its own linearization point, so every lane has its own QP:
P and A are per lane (n_d = B).  A single controller
(``moveinput_closed``) is the one-lane case of the same step; a fleet
(``make_fleet_step``) runs B lanes in one step.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..estimators.construct import init_estimstoch
from ..estimators.kalman import _default_P0, _default_sigmas, kf_correct, kf_predict
from ..models import NonLinModel
from ..ops.qp import solve_qp
from ..ops.qp_active import solve_qp_active
from ..utils.config import BIG, as_device, resolve_device
from ..utils.lanes import identity_lanes, mtv, mv
from ..utils.trace import ROOT, keep_max, span, synced
from .base import PredictiveController
from .construct import ControllerWeights
from .linmpc import _clipinf
from .transcription import move_blocking

STATE_KEYS = ("x_hat", "P_hat", "lastu", "Z", "ydual")
BOUND_KEYS = ("umin", "umax", "dumin", "dumax", "ymin", "ymax")


class SLMPC(PredictiveController):
    """Successive-linearization MPC on a NonLinModel with EKF feedback.

    The step runs on ``device`` (the GPU unless the caller asks for
    another) in ``dtype`` (float64 unless ``torch.float32``); construct-time
    math is host NumPy float64.  ``qp_solver="active_set"`` solves with
    Goldfarb–Idnani (float32 data keeps float64 slots, the reference's
    mixed mode), ``"admm"`` with the in-solve Ruiz scaling and ρ ladder.
    """

    def __init__(self, model: NonLinModel, Hp=10, Hc=2,
                 Mwt=None, Nwt=None, Lwt=None, Cwt=1e5,
                 i_ym=None, nint_u=0, nint_ym=None,
                 sigmaQ=None, sigmaR=None, sigmaQint_u=None, sigmaQint_ym=None,
                 sigmaP_0=None, sigmaPint_u_0=None, sigmaPint_ym_0=None,
                 qp_solver="admm", dtype=None, device=None):
        if not isinstance(model, NonLinModel):
            raise TypeError("SLMPC requires a NonLinModel (use LinMPC otherwise)")
        if qp_solver not in ("admm", "active_set"):
            raise ValueError("qp_solver must be 'admm' or 'active_set'")
        self.dtype = torch.float64 if dtype is None else dtype
        if self.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
        self.device = resolve_device(device)
        self.qp_solver = qp_solver
        self.model = model
        nb = move_blocking(Hp, Hc)
        if any(n != 1 for n in nb[:-1]):
            raise ValueError("SLMPC supports the default move-blocking pattern")
        self.Hp, self.Hc = int(Hp), len(nb)
        nu, ny, nx = model.nu, model.ny, model.nx
        # estimator structure (integrator augmentation, default 1/ym)
        i_ym = list(range(ny)) if i_ym is None else list(i_ym)
        if nint_ym is None:
            nint_ym = [1] * len(i_ym)
        As, Cs_u, Cs_y, nint_u, nint_ym = init_estimstoch(model, i_ym,
                                                          nint_u, nint_ym)
        self.i_ym = i_ym
        self.As, self.Cs_u, self.Cs_y = As, Cs_u, Cs_y
        self.nxs = As.shape[0]
        self.nx_hat = nx + self.nxs
        self.Q_hat, self.R_hat = _default_sigmas(model, i_ym, nint_u, nint_ym, sigmaQ,
                                                 sigmaR, sigmaQint_u, sigmaQint_ym)
        self.P0_hat = _default_P0(model, nint_u, nint_ym, sigmaP_0,
                                  sigmaPint_u_0, sigmaPint_ym_0)
        self.weights = ControllerWeights(nu, ny, self.Hp, self.Hc, Mwt, Nwt,
                                         Lwt, Cwt=Cwt)
        self.n_eps = self.weights.n_eps
        self.nZt = nu * self.Hc + self.n_eps
        self.n_rows = 2 * nu * self.Hp + 2 * nu * self.Hc + 2 * ny * self.Hp + self.n_eps
        # bounds (absolute; converted per period with fresh op points)
        self.umin = np.full(nu, -BIG)
        self.umax = np.full(nu, BIG)
        self.dumin = np.full(nu, -BIG)
        self.dumax = np.full(nu, BIG)
        self.ymin = np.full(ny, -BIG)
        self.ymax = np.full(ny, BIG)
        # runtime state of the single controller (unbatched tensors)
        self.state = self.state_from_arrays(dict(
            x_hat=np.zeros(self.nx_hat), P_hat=self.P0_hat, lastu=model.uop,
            Z=np.zeros(self.nZt), ydual=np.zeros(self.n_rows)))
        self._lane = torch.zeros(1, dtype=torch.int32, device=self.device)
        self._step = self._make_step()
        self._steps_on = {}          # the step on other devices (mesh shards)
        self._bounds_cache = None

    def state_from_arrays(self, state):
        """A state dict of arrays (the reference's ``state`` or
        ``fleet_state(B)``, or this controller's own) as tensors on this
        controller's device and dtype."""
        if set(state) != set(STATE_KEYS):
            raise KeyError(f"state keys must be {STATE_KEYS}, got {sorted(state)}")
        return {k: torch.as_tensor(np.array(v), dtype=self.dtype, device=self.device)
                for k, v in state.items()}

    def setconstraint(self, umin=None, umax=None, dumin=None, dumax=None,
                      ymin=None, ymax=None):
        for name, v in (("umin", umin), ("umax", umax), ("dumin", dumin),
                        ("dumax", dumax), ("ymin", ymin), ("ymax", ymax)):
            if v is not None:
                getattr(self, name)[:] = _clipinf(np.asarray(v, float))
        self._bounds_cache = None  # uploaded again at the next step
        return self

    # -- state access (SLMPC owns its fused estimator, so the base class's
    #    estimator-forwarding methods do not apply) --
    def _xop_hat(self):
        return np.concatenate([np.asarray(self.model.xop, float), np.zeros(self.nxs)])

    def setstate(self, x_hat, P_hat=None):
        """Set the absolute augmented state estimate (and optionally P̂)."""
        x_hat = np.asarray(x_hat, float).ravel()
        if x_hat.shape != (self.nx_hat,):
            raise ValueError(f"x̂ size must be {self.nx_hat}")
        st = dict(self.state)
        t = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)
        st["x_hat"] = t(x_hat - self._xop_hat())
        if P_hat is not None:
            P_hat = np.asarray(P_hat, float)
            if P_hat.shape != (self.nx_hat, self.nx_hat):
                raise ValueError("P̂ shape mismatch")
            st["P_hat"] = t(P_hat)
        self.state = st
        return self

    def getstate(self):
        """Absolute augmented state estimate."""
        return self.state["x_hat"].cpu().numpy() + self._xop_hat()

    def preparestate(self, *args, **kwargs):
        raise NotImplementedError(
            "SLMPC fuses estimation and control in one step: drive it with "
            "moveinput_closed(ym, ry, d)")

    updatestate = initstate = preparestate

    # ------------------------------------------------------------------
    def _make_step(self, dev=None):
        """The period over a leading lane axis:
        ``step(st, ym, ry, d, bounds, lane_ctrl) -> (u, converged, st)``.
        ``st``, ``ym``, ``ry`` and ``d`` have the lane axis, ``bounds`` not;
        ``lane_ctrl`` is the (B,) lane map 0..B−1 the caller keeps (the
        kernels' lane grouping is cached per tensor)."""
        model = self.model
        nu, ny, nd, nx = model.nu, model.ny, model.nd, model.nx
        nxs, nx_hat = self.nxs, self.nx_hat
        Hp, Hc, n_eps, nZt = self.Hp, self.Hc, self.n_eps, self.nZt
        use_as = self.qp_solver == "active_set"
        fd, hh, p_mod = model._fd, model._h_user, model.p
        dt, dev = self.dtype, self.device if dev is None else dev
        ja = lambda a: torch.as_tensor(np.asarray(a, float), dtype=dt, device=dev)
        As, Cs_u, Cs_y = ja(self.As), ja(self.Cs_u), ja(self.Cs_y)
        i_ym = list(self.i_ym)
        M_Hp = ja(self.weights.M_Hp)
        Q_hat, R_hat = ja(self.Q_hat), ja(self.R_hat)
        uop, dop, yop = ja(model.uop), ja(model.dop), ja(model.yop)
        yopm = ja(np.asarray(model.yop)[i_ym])
        fop_m_xop_d = ja(model.fop - model.xop)
        eye = torch.eye(nx_hat, dtype=dt, device=dev)
        # the per-sample functions, batched over the lanes
        f1 = lambda x, u, d: fd(x, u, d, p_mod)
        h1 = lambda x, d: hh(x, d, p_mod)
        vf = vmap(f1)
        # the Jacobians with the value at the point (one evaluation each);
        # forward-mode tangents of 0-dim float32 intermediates can come out
        # in float64 (x[0] * 1.0), so the Jacobians are cast to the step's type
        both = lambda fn: (lambda *a: (fn(*a),) * 2)
        vjh = vmap(jacfwd(both(h1), has_aux=True))
        vjf = vmap(jacfwd(both(f1), argnums=(0, 1), has_aux=True))

        def jac_h(x, d):
            C, y = vjh(x, d)
            return C.to(dt), y

        def jac_f(x, u, d):
            (A, Bu), fx = vjf(x, u, d)
            return A.to(dt), Bu.to(dt), fx
        # static structure (default move blocking [1, …, 1, Hp−Hc+1])
        Pu = np.zeros((Hp * nu, Hc * nu))
        for i in range(Hp):
            for j in range(min(i + 1, Hc)):
                Pu[i * nu:(i + 1) * nu, j * nu:(j + 1) * nu] = np.eye(nu)
        Pu = np.hstack([Pu, np.zeros((Hp * nu, n_eps))])
        PDu = np.eye(Hc * nu, nZt)
        if n_eps:
            PDu = np.vstack([PDu, np.eye(1, nZt, nZt - 1)])
        # the constant terms of H̃ (construct.jl:811-845)
        H_du = ja(PDu.T @ self.weights.Nt_Hc @ PDu)
        H_u = ja(Pu.T @ self.weights.L_Hp @ Pu)
        Pu_t, L_Hp = ja(Pu), ja(self.weights.L_Hp)
        H_reg = 1e-9 * torch.eye(nZt, dtype=dt, device=dev)
        # E block (stage i, move j) = ĈS(i−j)B̂u for i ≥ j: a gather over the
        # stack of ĈS(k)B̂u
        lag = np.arange(Hp)[:, None] - np.arange(Hc)[None, :]
        lag_idx = torch.as_tensor(np.clip(lag, 0, Hp), device=dev)
        lag_ok = torch.as_tensor(lag >= 0, device=dev)[None, :, :, None, None]
        # the constant rows: U (±Pu), ΔU (±PDu) and the slack row
        A_const = torch.cat([-Pu_t, Pu_t, -ja(np.eye(Hc * nu, nZt)),
                             ja(np.eye(Hc * nu, nZt))])
        eps_col = lambda B, s: torch.full((B, Hp * ny, n_eps), s, dtype=dt, device=dev)
        A_eps = ja(np.eye(1, nZt, nZt - 1))
        big = 2e18

        def shift(Z):
            B = Z.shape[0]
            return torch.cat([Z[:, nu:Hc * nu], Z.new_zeros(B, nu), Z[:, Hc * nu:]], 1)

        def predmat(Ah, Buh, Ch):
            """Condensed E, K and the f-affine term's Bc from the Â-power
            products (controller/transcription.jl:115-194)."""
            B = Ah.shape[0]
            pows = [eye.expand(B, nx_hat, nx_hat)]
            for _ in range(Hp):
                pows.append(pows[-1] @ Ah)
            Apows = torch.stack(pows, 1)                             # Â^0..Â^Hp
            S = torch.cumsum(Apows, 1)                               # S(m)=ΣÂ^ℓ
            CSB = torch.einsum("box,bkxy,byu->bkou", Ch, S, Buh)     # ĈS(k)B̂u
            CA = torch.einsum("box,bkxy->bkoy", Ch, Apows)           # ĈÂ^k
            K = CA[:, 1:Hp + 1].reshape(B, Hp * ny, nx_hat)
            E_blocks = torch.where(lag_ok, CSB[:, lag_idx], 0.0)     # (B, Hp, Hc, ny, nu)
            E = E_blocks.permute(0, 1, 3, 2, 4).reshape(B, Hp * ny, Hc * nu)
            Bc = torch.einsum("box,bkxy->bkoy", Ch, S[:, :Hp]).reshape(B, Hp * ny, nx_hat)
            return E, K, Bc

        def rows(E, F, Yop, lastu, bd):
            """Constraint rows (U, ΔU, Ŷ and the slack) and their bounds."""
            B = E.shape[0]
            Et = torch.cat([E, eps_col(B, -1.0)], -1) if n_eps else E
            Etm = torch.cat([E, eps_col(B, 1.0)], -1) if n_eps else E
            A_rows = torch.cat([A_const.expand(B, -1, -1), -Etm, Et]
                               + ([A_eps.expand(B, 1, nZt)] if n_eps else []), 1)
            lastu_t = lastu.repeat(1, Hp)
            clip = lambda v: torch.clamp(v, -big, big)
            u_vec = torch.cat([
                clip(-(bd["umin"].repeat(Hp) - lastu_t)),
                clip(bd["umax"].repeat(Hp) - lastu_t),
                clip(-bd["dumin"].repeat(Hc)).expand(B, -1),
                clip(bd["dumax"].repeat(Hc)).expand(B, -1),
                clip(-(bd["ymin"].repeat(Hp) - Yop) + F),
                clip(bd["ymax"].repeat(Hp) - Yop - F),
            ] + ([F.new_full((B, 1), big)] if n_eps else []), 1)
            l_vec = torch.cat([F.new_full((B, u_vec.shape[1] - n_eps), -big)]
                              + ([F.new_zeros(B, 1)] if n_eps else []), 1)
            return A_rows, l_vec, u_vec

        def step(st, ym, ry, d, bd, lane_ctrl):
            x_hat, P_hat, lastu = st["x_hat"], st["P_hat"], st["lastu"]
            B = x_hat.shape[0]
            # op-point convention: x_hat is the DEVIATION augmented state
            # (x0 = x - xop; sim_model.jl:50-125), lastu/ym/d are absolute
            d0 = d - dop if nd else d
            u0_last = lastu - uop
            xd, xs = x_hat[:, :nx], x_hat[:, nx:]
            with span("estimator.correct"):
                # the EKF's correction: h-Jacobian at the prior estimate (the
                # previous model, as in the reference SL pattern)
                Cs_y_b = Cs_y.expand(B, ny, nxs)
                C1, y1 = jac_h(xd, d0)
                # indexing by the host list i_ym uploads it: a host sync each
                Chm = synced(torch.cat([C1, Cs_y_b], -1)[:, i_ym, :])
                y_pred_m = synced((y1 + xs @ Cs_y.mT)[:, i_ym]) + yopm
                xc, Pc = kf_correct(x_hat, P_hat, y_pred_m, ym, Chm, R_hat)
                xcd = xc[:, :nx]
            with span("linearize"):
                # re-linearize at the corrected estimate (Jacobians of the
                # deviation dynamics; d is pinned over Hp, so no Bd/Dd)
                A, Bu, fx = jac_f(xcd, u0_last, d0)
                C, yx = jac_h(xcd, d0)
                Ah = torch.cat([torch.cat([A, Bu @ Cs_u], -1),
                                torch.cat([A.new_zeros(B, nxs, nx), As.expand(B, nxs, nxs)],
                                          -1)], -2)
                Buh = torch.cat([Bu, Bu.new_zeros(B, nxs, nu)], -2)
                Ch = torch.cat([C, Cs_y_b], -1)
            with span("qp.build"):
                E, K, Bc = predmat(Ah, Buh, Ch)
                # deviation around the linearization point [xcd; 0]: only the
                # stochastic substate is displaced
                x0c = torch.cat([xcd.new_zeros(B, nx), xc[:, nx:]], 1)
                f_aff = torch.cat([fx + fop_m_xop_d - xcd, xcd.new_zeros(B, nxs)], 1)
                F = mv(K, x0c) + mv(Bc, f_aff)
                Yop = (yx + yop).repeat(1, Hp)  # absolute outputs at the op point
                # u deviation: op point = lastu; input target = uop (R̂u = Uop)
                Cy = F + Yop - ry.repeat(1, Hp)
                Cu = (lastu - uop).repeat(1, Hp)
                Et = torch.cat([E, E.new_zeros(B, Hp * ny, n_eps)], -1)
                q = 2.0 * (mtv(Et, mv(M_Hp, Cy)) + mtv(Pu_t, mv(L_Hp, Cu)))
                H = 2.0 * (Et.mT @ M_Hp @ Et + H_du + H_u)
                H = 0.5 * (H + H.mT) + H_reg
                A_rows, l, u = rows(E, F, Yop, lastu, bd)
                Zs = shift(st["Z"])
            with span("qp.solve"):
                if use_as:
                    # exact GI dual active set, warm-started from the previous
                    # period's duals; P⁻¹ per lane in the solve
                    sol = solve_qp_active(H, q, A_rows, l, u, y0=st["ydual"],
                                          lane_ctrl=lane_ctrl)
                    keep_max("gi_pivots_max", sol.iters)
                else:
                    sol = solve_qp(H, q, A_rows, l, u, x0=Zs, y0=st["ydual"],
                                   max_iter=1000)
            Z = torch.where(sol.converged[:, None], sol.x, Zs)
            u_new = torch.clamp(Z[:, :nu] + lastu, bd["umin"], bd["umax"])
            with span("estimator.predict"):
                # the EKF's prediction (exact augmented deviation dynamics)
                u0_dist = (u_new - uop) + xc[:, nx:] @ Cs_u.mT
                xn_raw = torch.cat([vf(xcd, u0_dist, d0) + fop_m_xop_d,
                                    xc[:, nx:] @ As.mT], 1)
                xn, Pn = kf_predict(xn_raw, Pc, Ah, Q_hat, 0.0)
            new_st = dict(x_hat=xn, P_hat=Pn, lastu=u_new, Z=Z, ydual=sol.y)
            return u_new, sol.converged, new_st

        return step

    # ------------------------------------------------------------------
    def bounds(self):
        """The bounds as tensors on the device, uploaded again only after
        ``setconstraint``."""
        if self._bounds_cache is None:
            self._bounds_cache = {
                k: torch.as_tensor(getattr(self, k), dtype=self.dtype, device=self.device)
                for k in BOUND_KEYS}
        return self._bounds_cache

    def moveinput_closed(self, ym, ry, d=None):
        """One full control period: EKF correct → linearize → QP → predict.
        Returns the applied u (NumPy) and whether the QP converged."""
        ins = [np.asarray(a, float).ravel()
               for a in (ym, ry, np.zeros(0) if d is None else d)]
        with span(ROOT, self.device):
            # one upload for the period's inputs
            flat = synced(torch.as_tensor(np.concatenate(ins), dtype=self.dtype).to(self.device))
            ym_t, ry_t, d_t = (t[None] for t in flat.split([a.size for a in ins]))
            st = {k: v[None] for k, v in self.state.items()}
            u, conv, st = self._step(st, ym_t, ry_t, d_t, self.bounds(), self._lane)
            self.state = {k: v[0] for k, v in st.items()}
            return synced(u[0].cpu()).numpy(), synced(bool(conv[0]))

    def _step_on(self, dev):
        """``_step`` with its constants on ``dev`` (made once a device)."""
        dev = as_device(dev)
        if dev == as_device(self.device):
            return self._step
        if dev not in self._steps_on:
            self._steps_on[dev] = self._make_step(dev)
        return self._steps_on[dev]

    # ------------------------------------------------------------------
    def fleet_state(self, B):
        """The controller state repeated over a fleet of B lanes."""
        return {k: v[None].repeat(B, *[1] * v.dim()) for k, v in self.state.items()}

    def make_fleet_step(self, B, chunk=256):
        """Fleet step over B lanes, each with its own linearization and QP:
        ``step(states, ym, ry, d, bounds) -> (u, converged, states)`` with
        the lane axis B on every argument except ``bounds``.

        ``chunk`` keeps the reference's contract: it is clamped to B, and B
        must be a multiple of it (``ValueError``).  All B lanes then go
        through ONE solve: the reference chunks its lockstep solve to bound
        each chunk's slowest lane, while the per-lane kernels here let each
        lane exit on its own, so a chunk changes no answer."""
        chunk = min(int(chunk), int(B))
        if B % chunk:
            raise ValueError(f"B ({B}) must be a multiple of chunk ({chunk})")
        lane_ctrl = identity_lanes(B, self.device)
        step = self._step

        def fleet_step(st, ym, ry, d, bounds):
            with span(ROOT, lane_ctrl.device):
                return step(st, ym, ry, d, bounds, lane_ctrl)
        return fleet_step
