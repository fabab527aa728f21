"""Fleets of pendulums under successive-linearization MPC.

The world: each lane is the upstream's damped pendulum
θ'' = −g/L·sin θ − K/m·θ' + u/(mL²), one RK4 step a period on the device
in float64, from rest, its angle measured in degrees with Gaussian noise.
The port: one ``mpc_tpu_torch.SLMPC`` whose ``make_fleet_step(B)`` steps
every lane (each lane its own linearization and QP).  The reference
(``Reference``): the same controller rebuilt in plain PyTorch — an
extended Kalman filter with an integrating output disturbance, the
Jacobians of its own RK4 step at the corrected estimate, the condensed QP
built by simulating the linearized model — run in float64 over the
recorded measurements of a subset of lanes, with its own estimate,
covariance and last input, solving each QP exactly (``qp_ref``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import jacfwd, vmap

from .. import qp_ref, roofline
from ..precision import FLOAT64
from ..traffic import Traffic
from . import graphed


def pendulum(cfg):
    """(f, h) of one sample in plain torch: the published model."""
    g, L, K, m = (cfg["params"][k] for k in ("g", "L", "K", "m"))

    def f(x, u):
        return torch.stack([x[1], -g / L * torch.sin(x[0]) - K / m * x[1] + u[0] / (m * L ** 2)])

    def h(x):
        return x[:1] * (180 / math.pi)
    return f, h


def pendulum_jac(cfg):
    """``df(x, u) -> (f, ∂f/∂[x, u])`` over a lane axis: the model and its
    Jacobian written out, (L, 2) and (L, 2, 3)."""
    g, L, K, m = (cfg["params"][k] for k in ("g", "L", "K", "m"))

    def df(x, u):
        f = torch.stack([x[:, 1], -g / L * torch.sin(x[:, 0]) - K / m * x[:, 1]
                         + u[:, 0] / (m * L ** 2)], -1)
        J = torch.zeros(x.shape[0], 2, 3, dtype=x.dtype, device=x.device)
        J[:, 0, 1].fill_(1.0)
        J[:, 1, 0] = -g / L * torch.cos(x[:, 0])
        J[:, 1, 1].fill_(-K / m)
        J[:, 1, 2].fill_(1.0 / (m * L ** 2))
        return f, J
    return df


def rk4_jac(df, Ts, mm=torch.matmul):
    """One RK4 step over a lane axis and its Jacobian with respect to
    [x, u], by propagating the tangents through the four stages."""
    def step(x, u):
        n = x.shape[1]
        T0 = torch.zeros(x.shape[0], n, n + u.shape[1], dtype=x.dtype, device=x.device)
        T0[:, :, :n] = torch.eye(n, dtype=x.dtype, device=x.device)
        k1, J1 = df(x, u)
        d1 = mm(J1[:, :, :n], T0) + J1 * _u_mask(J1, n)
        k2, J2 = df(x + 0.5 * Ts * k1, u)
        d2 = mm(J2[:, :, :n], (T0 + 0.5 * Ts * d1)) + J2 * _u_mask(J2, n)
        k3, J3 = df(x + 0.5 * Ts * k2, u)
        d3 = mm(J3[:, :, :n], (T0 + 0.5 * Ts * d2)) + J3 * _u_mask(J3, n)
        k4, J4 = df(x + Ts * k3, u)
        d4 = mm(J4[:, :, :n], (T0 + Ts * d3)) + J4 * _u_mask(J4, n)
        xn = x + (Ts / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        return xn, T0 + (Ts / 6.0) * (d1 + 2 * d2 + 2 * d3 + d4)
    return step


def _u_mask(J, n):
    """Keeps the input columns of a Jacobian (the direct effect of u)."""
    k = J.shape[-1]
    return (torch.arange(k, device=J.device) >= n).to(J.dtype)


def rk4(f, Ts):
    def fd(x, u):
        k1 = f(x, u)
        k2 = f(x + 0.5 * Ts * k1, u)
        k3 = f(x + 0.5 * Ts * k2, u)
        k4 = f(x + Ts * k3, u)
        return x + (Ts / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return fd


class World:
    """The lanes' true pendulums on the device (float64)."""

    def __init__(self, cfg, B, traffic, seed, device, dtype):
        f, h = pendulum(cfg)
        self.fd, self.h = vmap(rk4(f, cfg["Ts"])), vmap(h)
        self.x = torch.tensor(cfg["x0"], dtype=torch.float64, device=device).repeat(B, 1)
        self.traffic, self.dtype, self.B = traffic, dtype, B
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed) % (1 << 63))

    def measure(self, k):
        noise = torch.randn(self.B, 1, generator=self.gen, dtype=torch.float64,
                            device=self.x.device) * self.traffic.noise_sd
        ry, d = self.traffic.setpoints(k)
        return (self.h(self.x) + noise).to(self.dtype), ry, d

    def advance(self, u):
        self.x = self.fd(self.x, u.to(torch.float64))


class Cell:
    """The port's SLMPC fleet step in closed loop with the world."""

    def __init__(self, cfg, cell, traffic_spec, seed, device):
        import mpc_tpu_torch as mt
        self.cfg, self.cell = cfg, cell
        dtype = getattr(torch, cfg["dtype"])
        self.B = int(cell["lanes"])
        p = cfg["params"]
        par = (p["g"], p["L"], p["K"], p["m"])

        def f(x, u, d, p):
            return torch.stack([x[1], -p[0] / p[1] * torch.sin(x[0]) - p[2] / p[3] * x[1]
                                + u[0] / (p[3] * p[1] ** 2)])

        def h(x, d, p):
            return torch.stack([x[0] * 180 / torch.pi])
        model = mt.NonLinModel(f, h, cfg["Ts"], 1, 2, 1, p=par,
                               solver=mt.RungeKutta(4), device=device)
        self.ctrl = mt.SLMPC(model, Hp=cfg["Hp"], Hc=cfg["Hc"], Mwt=cfg["Mwt"], Nwt=cfg["Nwt"],
                             Cwt=cfg["Cwt"], sigmaQ=cfg["sigmaQ"], sigmaR=cfg["sigmaR"],
                             nint_ym=cfg["nint_ym"], sigmaQint_ym=cfg["sigmaQint_ym"],
                             qp_solver=cfg["qp_solver"], dtype=dtype, device=device)
        self.ctrl.setconstraint(umin=cfg["umin"], umax=cfg["umax"])
        self.fleet_step = self.ctrl.make_fleet_step(self.B)
        self.state = self.ctrl.fleet_state(self.B)
        self.bounds = self.ctrl.bounds()
        self.traffic = Traffic(traffic_spec, self.B, device, dtype)
        self.world = World(cfg, self.B, self.traffic, seed, device, dtype)
        rng = np.random.default_rng([int(seed) % (1 << 63), 1])
        lanes = np.sort(rng.choice(self.B, int(cell["check_lanes"]), replace=False))
        self.check_lanes = torch.as_tensor(lanes, device=device)
        self.kernel = "gi_solve" if cfg["qp_solver"] == "active_set" else "admm_sweep"
        self.d0 = torch.zeros(self.B, 0, dtype=dtype, device=device)

    def measure(self, k):
        return self.world.measure(k)

    def step(self, ym, ry, d):
        """The timed entry: ``(u, n_conv)``, both on the device."""
        u, conv, self.state = self.fleet_step(self.state, ym, ry, self.d0, self.bounds)
        return u, conv.sum()

    def advance(self, u):
        self.world.advance(u)

    def counters(self):
        """The SLMPC step reports no QP iterations."""
        return {}

    def reference(self, device, ar=FLOAT64):
        return Reference(self.cfg, device, ar)

    def bound_s(self, ref, pivots, launches):
        """A period's GI launches, each over every lane (n_d = B: each lane
        its own P⁻¹ and A); the step reports no pivots, so the bound is the
        bytes'."""
        return launches * roofline.gi_bound_s(lanes=self.B, n=ref.n, m=ref.m, slots=ref.n,
                                              n_p=self.B, n_a=self.B, data_size=4, slot_size=8,
                                              pivots=0)[0]

    def free(self):
        del self.state, self.fleet_step, self.ctrl, self.world


class Reference:
    """The plain SLMPC of the recorded lanes, in the arithmetic ``ar``
    (float64; TF32 for the control)."""

    def __init__(self, cfg, device, ar=FLOAT64):
        dtype, self.ar = ar.dtype, ar
        f, h = pendulum(cfg)
        self.step = rk4_jac(pendulum_jac(cfg), cfg["Ts"], ar.mm)
        # h is linear in x: its Jacobian is one constant row
        self.C = jacfwd(h)(torch.zeros(2, dtype=dtype)).to(device)     # (1, 2)
        self.vh = lambda x: ar.mm(x, self.C.T)
        t = lambda v: torch.as_tensor(np.asarray(v, float), dtype=dtype, device=device)
        self.Hp, self.Hc = int(cfg["Hp"]), int(cfg["Hc"])
        self.M, self.N = float(cfg["Mwt"][0]), float(cfg["Nwt"][0])
        # Cwt null (the upstream's Inf): hard constraints, no slack variable
        self.Cwt = None if cfg["Cwt"] is None else float(cfg["Cwt"])
        slack = 0 if self.Cwt is None else 1
        self.umin, self.umax = t(cfg["umin"]), t(cfg["umax"])
        nx = 2
        self.Q = torch.diag(t(np.r_[cfg["sigmaQ"], cfg["sigmaQint_ym"]]) ** 2)
        self.R = torch.diag(t(cfg["sigmaR"]) ** 2)
        self.P0 = torch.diag(t(np.r_[np.full(nx, 1.0 / nx), 1.0]) ** 2)
        self.n, self.m = self.Hc + slack, 2 * self.Hp + slack
        self.dtype, self.device = dtype, device
        # the rows: U0 = Pu ΔU ≤ umax − u(k−1), −Pu ΔU ≤ u(k−1) − umin, and
        # with a slack −ϵ ≤ 0 (move j applies from step j on)
        Pu = np.hstack([np.tril(np.ones((self.Hp, self.Hc))), np.zeros((self.Hp, slack))])
        self.G = t(np.vstack([Pu, -Pu, np.eye(slack, self.n, self.n - 1) * -1.0]))

    def run(self, ym, ry, d):
        L, dev, dt = ym.shape[1], ym.device, self.dtype
        st = dict(x=torch.zeros(L, 3, dtype=dt, device=dev),
                  P=self.P0.expand(L, 3, 3).clone(),
                  lastu=torch.zeros(L, 1, dtype=dt, device=dev))
        return graphed.run(self.period, st, [ym, ry])

    def condensed(self, Ah, Bh, Ch, dx, faff, yx):
        """``(E, F)``: the outputs over Hp of the linearized model
        δx(j+1) = Â δx(j) + B̂u δu(j) + f_aff, ŷ = Ĉ δx + y(x̂c), from
        δx(0) = ``dx`` with δu = 0 (F, (L, Hp)) and their response to each
        move (E, (L, Hp, Hc)), by simulating it."""
        mv = self.ar.mv
        resp = [torch.zeros_like(dx) for _ in range(self.Hc)]
        F, E = [], []
        for j in range(self.Hp):
            dx = mv(Ah, dx) + faff
            F.append(mv(Ch, dx) + yx)
            row = []
            for i in range(self.Hc):
                resp[i] = mv(Ah, resp[i]) + (Bh[:, :, 0] if j >= i else 0.0)
                row.append(mv(Ch, resp[i]))
            E.append(torch.cat(row, -1))
        return torch.stack(E, 1), torch.cat(F, -1)

    def period(self, st, inputs):
        dt = self.dtype
        ym, ry = (t.to(dt) for t in inputs)
        x, P, lastu = st["x"], st["P"], st["lastu"]
        L = x.shape[0]
        mm, mv = self.ar.mm, self.ar.mv
        # EKF correction with the output Jacobian at the prior estimate
        xd, xs = x[:, :2], x[:, 2:]
        one = torch.ones(L, 1, 1, dtype=dt, device=x.device)
        C = torch.cat([self.C.expand(L, 1, 2), one], -1)                 # (L, 1, 3)
        v = ym - self.vh(xd) - xs
        PCt = mm(P, C.transpose(1, 2))
        S = mm(C, PCt) + self.R
        Kg = PCt / S
        xc = x + mv(Kg, v)
        Pc = mm(torch.eye(3, dtype=dt, device=x.device) - mm(Kg, C), P)
        Pc = 0.5 * (Pc + Pc.transpose(1, 2))
        xcd = xc[:, :2]
        # linearization of the RK4 step at the corrected estimate, last input
        fx, J = self.step(xcd, lastu)
        A, Bu = J[:, :, :2], J[:, :, 2:]
        Ah = torch.zeros(L, 3, 3, dtype=dt, device=x.device)
        Ah[:, :2, :2] = A
        Ah[:, 2, 2].fill_(1.0)
        Bh = torch.cat([Bu, torch.zeros(L, 1, 1, dtype=dt, device=x.device)], 1)
        Ch = C
        yx = self.vh(xcd)
        # condensed predictions of the model linearized at (x̂c, u(k−1))
        faff = torch.cat([fx - xcd, torch.zeros(L, 1, dtype=dt, device=x.device)], 1)
        dx = torch.cat([torch.zeros_like(xcd), xc[:, 2:]], 1)
        E, F = self.condensed(Ah, Bh, Ch, dx, faff, yx)
        Hq = 2 * (self.M * mm(E.transpose(1, 2), E)
                  + self.N * torch.eye(self.Hc, dtype=dt, device=x.device))
        slack = self.n - self.Hc
        H = torch.zeros(L, self.n, self.n, dtype=dt, device=x.device)
        H[:, :self.Hc, :self.Hc] = Hq
        if slack:
            H[:, -1, -1].fill_(2 * self.Cwt)
        zero = torch.zeros(L, slack, dtype=dt, device=x.device)
        q = torch.cat([2 * self.M * mv(E.transpose(1, 2), F - ry.expand(L, self.Hp)), zero], -1)
        G = self.G.expand(L, self.m, self.n)
        h = torch.cat([(self.umax - lastu).expand(L, self.Hp),
                       (lastu - self.umin).expand(L, self.Hp), zero], -1)
        Z, kkt = qp_ref.solve(H, q, G, h, ar=self.ar)
        u = torch.minimum(torch.maximum(lastu + Z[:, :1], self.umin), self.umax)
        # EKF prediction with this period's Jacobian
        xn = torch.cat([self.step(xcd, u)[0], xc[:, 2:]], 1)
        Pn = mm(mm(Ah, Pc), Ah.transpose(1, 2)) + self.Q
        x.copy_(xn)
        P.copy_(0.5 * (Pn + Pn.transpose(1, 2)))
        lastu.copy_(u)
        return u, kkt
