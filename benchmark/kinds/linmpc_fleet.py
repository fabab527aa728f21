"""Fleets of LinMPC controllers on first-order multi-input plants.

The world: each lane is a plant of first-order transfer functions
``g/(τs+1)`` (manipulated inputs and measured disturbances), stepped
exactly under a zero-order hold on the device in float64 and measured with
Gaussian noise.  The port: ``mpc_tpu_torch.LinMPC`` controllers of the
drawn plants, one per distinct plant, in a ``parallel.BatchedLinMPC`` of
``reps`` lanes each (public lane order ``lane = r·n_d + c``), driven by
``BatchedLinMPC.step(ym, ry, d)``.  The reference (``Reference``): the
controller rebuilt in plain NumPy and PyTorch from the same plants and
settings, run in float64 over the recorded measurements of a subset of
lanes, with its own estimate and last input, solving each period's QP
exactly (``qp_ref``).
"""
from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import torch

from .. import qp_ref, roofline
from ..precision import FLOAT64
from . import graphed
from ..traffic import Traffic


# --------------------------------------------------------------------- plants
def draw_plants(cfg, seed):
    """Gains and time constants (n_d, ny, ns) of the distinct plants.

    As ``mpc_tpu_torch/parallel/scenarios.py`` draws them: per plant, the
    manipulated-input entries' gains ×U(gain_scale) then their time
    constants ×U(tau_scale), in row-major order, from
    ``numpy.random.default_rng(cfg["plant_seed"])``: every run has the same
    set of plants.  ``seed`` orders them over the controllers (and so over
    the lanes' setpoint phases), so a seed changes where the hard plants
    sit but not the work of a period (the lockstep ADMM loop's length is
    set by its slowest lane).  A disturbance column takes the draws of the
    input column ``d_follows_u`` names (``assumed``)."""
    rng = np.random.default_rng(cfg["plant_seed"])
    g0 = np.asarray(cfg["gains"], float)
    t0 = np.asarray(cfg["time_constants"], float)
    ny, ns = g0.shape
    i_d = list(cfg["i_d"])
    i_u = [j for j in range(ns) if j not in i_d]
    n_d = int(cfg["n_distinct"])
    G = np.empty((n_d, ny, ns))
    T = np.empty((n_d, ny, ns))
    for c in range(n_d):
        gs = rng.uniform(*cfg["gain_scale"], size=ny * len(i_u)).reshape(ny, len(i_u))
        ts = rng.uniform(*cfg["tau_scale"], size=ny * len(i_u)).reshape(ny, len(i_u))
        G[c][:, i_u] = gs * g0[:, i_u]
        T[c][:, i_u] = ts * t0[:, i_u]
        for jd, ju in zip(i_d, cfg["d_follows_u"]):
            G[c][:, jd] = G[c][:, ju] / g0[:, ju] * g0[:, jd]
            T[c][:, jd] = T[c][:, ju] / t0[:, ju] * t0[:, jd]
    order = np.random.default_rng([int(seed) % (1 << 63), 2]).permutation(n_d)
    return G[order], T[order]


class World:
    """The lanes' true plants on the device (float64, deviation from the
    operating point; lane ``b`` is plant ``b mod n_d``)."""

    def __init__(self, cfg, G, T, reps, traffic, seed, device, dtype):
        n_d, ny, ns = G.shape
        i_d = list(cfg["i_d"])
        i_u = [j for j in range(ns) if j not in i_d]
        f64 = dict(dtype=torch.float64, device=device)
        a = torch.as_tensor(np.exp(-cfg["Ts"] / T), **f64).repeat(reps, 1, 1)
        gain = torch.as_tensor(G, **f64).repeat(reps, 1, 1)
        self.iu, self.id = i_u, i_d
        self.a, self.b = a, (1 - a) * gain
        self.x = torch.zeros_like(a)                     # (B, ny, ns)
        self.uop = torch.tensor(cfg["uop"], **f64)
        self.dop = torch.tensor(cfg["dop"], **f64)
        self.yop = torch.tensor(cfg["yop"], **f64)
        self.traffic, self.dtype = traffic, dtype
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed) % (1 << 63))
        self.B, self.ny = a.shape[0], ny
        self._d = None

    def measure(self, k):
        noise = torch.randn(self.B, self.ny, generator=self.gen, dtype=torch.float64,
                            device=self.x.device) * self.traffic.noise_sd
        ym = self.yop + self.x.sum(-1) + noise
        ry, d = self.traffic.setpoints(k)
        self._d = d
        return ym.to(self.dtype), ry, d

    def advance(self, u):
        v = torch.empty(self.B, self.x.shape[2], dtype=torch.float64, device=self.x.device)
        v[:, self.iu] = u.to(torch.float64) - self.uop
        v[:, self.id] = self._d.to(torch.float64) - self.dop
        self.x = self.a * self.x + self.b * v[:, None, :]


# ------------------------------------------------------------------ the port
def port_controllers(mt, cfg, G, T, qp_solver, device):
    """One ``mpc_tpu_torch.LinMPC`` per drawn plant, as the configuration
    states it (default SteadyKalmanFilter)."""
    ny, ns = G.shape[1:]
    out = []
    for g, t in zip(G, T):
        tfm = mt.tf_matrix([[mt.tf(g[i, j], [t[i, j], 1]) for j in range(ns)]
                            for i in range(ny)])
        model = mt.LinModel(tfm, cfg["Ts"], i_d=cfg["i_d"])
        model.setop(uop=cfg["uop"], yop=cfg["yop"], dop=cfg["dop"])
        c = mt.LinMPC(model, Hp=cfg["Hp"], Hc=cfg["Hc"], Mwt=cfg["Mwt"], Nwt=cfg["Nwt"],
                      Cwt=cfg["Cwt"], qp_solver=qp_solver, device=device)
        c.setconstraint(umin=cfg["umin"], umax=cfg["umax"],
                        ymin=cfg["ymin"], ymax=cfg["ymax"])
        out.append(c)
    return out


class Cell:
    """The port's fleet in closed loop with the world."""

    kernels = {"active_set": "gi_solve", "admm": "admm_sweep"}

    def __init__(self, cfg, cell, traffic_spec, seed, device):
        import mpc_tpu_torch as mt
        from mpc_tpu_torch.parallel import BatchedLinMPC
        self.cfg, self.cell = cfg, cell
        dtype = getattr(torch, cfg["dtype"])
        self.n_d, reps = int(cfg["n_distinct"]), int(cell["reps"])
        self.B = self.n_d * reps
        self.G, self.T = draw_plants(cfg, seed)
        self.qp_solver = cfg["qp_solver"]
        ctrls = port_controllers(mt, cfg, self.G, self.T, self.qp_solver, device)
        self.fleet = BatchedLinMPC(ctrls, reps=reps, dtype=dtype, device=device,
                                   gi_slot_dtype=getattr(torch, cfg["gi_slot_dtype"]))
        self.traffic = Traffic(traffic_spec, self.B, device, dtype)
        self.world = World(cfg, self.G, self.T, reps, self.traffic, seed, device, dtype)
        rng = np.random.default_rng([int(seed) % (1 << 63), 1])
        per = int(cell["check_lanes_per_controller"])
        r = np.stack([rng.choice(reps, per, replace=False) for _ in range(self.n_d)])
        lanes = np.sort((r * self.n_d + np.arange(self.n_d)[:, None]).ravel())
        self.check_lanes = torch.as_tensor(lanes, device=device)
        self.kernel = self.kernels[self.qp_solver]

    def measure(self, k):
        return self.world.measure(k)

    def step(self, ym, ry, d):
        """The timed entry: ``(u, n_conv)``, both on the device."""
        return self.fleet.step(ym, ry, d)

    def advance(self, u):
        self.world.advance(u)

    def counters(self):
        """This period's QP iterations: the slowest lane's and the sum over
        the lanes (the fleet's ``last_iters``: [max, sum // B])."""
        it = self.fleet.last_iters
        return dict(iters_max=it[0], pivots=it[1] * self.B)

    def reference(self, device, ar=FLOAT64):
        return Reference(self.cfg, self.G, self.T, self.check_lanes.cpu().numpy() % self.n_d,
                         device, ar)

    def bound_s(self, ref, pivots, launches):
        """The least time of a period's ``launches`` of the cell's kernel,
        with ``pivots`` the QP iterations summed over the lanes: GI's
        launches each over all lanes (f32 data, f64 slots) sharing the
        pivots; the sweeps' launches on their active lanes, counted as the
        summed sweeps over the sweeps a launch (``sweeps_per_launch``, the
        port's ``check_every``)."""
        if not launches:
            return 0.0
        if self.kernel == "gi_solve":
            return launches * roofline.gi_bound_s(
                lanes=self.B, n=ref.n, m=ref.m, slots=ref.n, n_p=self.n_d, n_a=self.n_d,
                data_size=4, slot_size=8, pivots=pivots / launches)[0]
        return roofline.admm_bound_s(sweeps=pivots,
                                     lane_launches=pivots / self.cfg["sweeps_per_launch"],
                                     n=ref.n, m=ref.m, n_c=self.n_d, data_size=4)[0]

    def free(self):
        del self.fleet, self.world


# ----------------------------------------------------------------- reference
def discrete_plant(cfg, g, t):
    """The controller's discrete model of one plant (NumPy float64).

    Each entry ``g/(τs+1)`` is realized in controller-canonical form
    (A = −1/τ, B = 1, C = g/τ), as ``ss`` of a transfer function gives it;
    the input entries are discretized by zero-order hold, the disturbance
    entries by the bilinear transform, one state each, stacked in
    row-major order.  The minimal realization the package computes from it
    differs by an orthogonal change of basis, which leaves the default
    Kalman filter (an isotropic σQ on the model states) unchanged."""
    Ts, i_d = cfg["Ts"], list(cfg["i_d"])
    ny, ns = g.shape
    i_u = [j for j in range(ns) if j not in i_d]
    blocks = [(i, j) for i in range(ny) for j in i_u] + [(i, j) for j in i_d for i in range(ny)]
    nx = len(blocks)
    A, Bu, Bd = np.zeros((nx, nx)), np.zeros((nx, len(i_u))), np.zeros((nx, len(i_d)))
    C, Dd = np.zeros((ny, nx)), np.zeros((ny, len(i_d)))
    for s, (i, j) in enumerate(blocks):
        tau, k = t[i, j], g[i, j]
        if j in i_u:
            a = np.exp(-Ts / tau)
            A[s, s], Bu[s, i_u.index(j)], C[i, s] = a, tau * (1 - a), k / tau
        else:
            M = 1 + Ts / (2 * tau)
            A[s, s] = (1 - Ts / (2 * tau)) / M
            Bd[s, i_d.index(j)] = Ts / M
            C[i, s] = k / tau / M
            Dd[i, i_d.index(j)] += Ts / 2 * k / tau / M
    ctrb = np.hstack([np.linalg.matrix_power(A, p) @ np.hstack([Bu, Bd]) for p in range(nx)])
    obsv = np.vstack([C @ np.linalg.matrix_power(A, p) for p in range(nx)])
    if min(np.linalg.matrix_rank(ctrb), np.linalg.matrix_rank(obsv)) < nx:
        raise ValueError("a drawn plant is not minimal; the reference's "
                         "realization would differ from the package's")
    return A, Bu, Bd, C, Dd


def controller_matrices(cfg, g, t):
    """Everything the reference's period needs for one plant."""
    A, Bu, Bd, C, Dd = discrete_plant(cfg, g, t)
    nx, nu, nd, ny = A.shape[0], Bu.shape[1], Bd.shape[1], C.shape[0]
    # augmented model: one integrating disturbance on each measured output
    Ah = sla.block_diag(A, np.eye(ny))
    Buh = np.vstack([Bu, np.zeros((ny, nu))])
    Bdh = np.vstack([Bd, np.zeros((ny, nd))])
    Ch = np.hstack([C, np.eye(ny)])
    Q = np.diag(np.r_[np.full(nx, 1.0 / nx), np.ones(ny)] ** 2)
    R = np.eye(ny)
    Pp = sla.solve_discrete_are(Ah.T, Ch.T, Q, R)
    K = Pp @ Ch.T @ np.linalg.inv(Ch @ Pp @ Ch.T + R)
    Hp, Hc = int(cfg["Hp"]), int(cfg["Hc"])
    nxh = Ah.shape[0]

    def predict(x0, lastu0, d0, dU):
        """Ŷ0 (ny·Hp) and U0 (nu·Hp) of the augmented model over Hp, with
        move j applied at step j (j < Hc) and held after."""
        x, u, Y, U = x0, lastu0.copy(), [], []
        for j in range(Hp):
            if j < Hc:
                u = u + dU[j * nu:(j + 1) * nu]
            x = Ah @ x + Buh @ u + Bdh @ d0
            Y.append(Ch @ x + Dd @ d0)
            U.append(u)
        return np.concatenate(Y), np.concatenate(U)

    z = lambda n: np.zeros(n)
    cols = lambda n, f: np.stack([f(np.eye(n)[i]) for i in range(n)], 1)
    E = cols(nu * Hc, lambda e: predict(z(nxh), z(nu), z(nd), e)[0])
    Pu = cols(nu * Hc, lambda e: predict(z(nxh), z(nu), z(nd), e)[1])
    Kx = cols(nxh, lambda e: predict(e, z(nu), z(nd), z(nu * Hc))[0])
    Vx = cols(nu, lambda e: predict(z(nxh), e, z(nd), z(nu * Hc))[0])
    Tu = cols(nu, lambda e: predict(z(nxh), e, z(nd), z(nu * Hc))[1])
    Gx = cols(nd, lambda e: predict(z(nxh), z(nu), e, z(nu * Hc))[0])
    M = np.diag(np.tile(cfg["Mwt"], Hp))
    N = np.diag(np.tile(cfg["Nwt"], Hc))
    H = 2 * sla.block_diag(E.T @ M @ E + N, [[cfg["Cwt"]]])
    return dict(Ah=Ah, Buh=Buh, Bdh=Bdh, Ch=Ch, Dd=Dd, K=K, E=E, Pu=Pu, Kx=Kx, Vx=Vx,
                Tu=Tu, Gx=Gx, M=M, H=0.5 * (H + H.T))


class Reference:
    """The plain controller of the recorded lanes (``ctrl`` (L,): each
    lane's plant), run over recorded measurements in the arithmetic ``ar``
    (float64; TF32 for the control)."""

    def __init__(self, cfg, G, T, ctrl, device, ar=FLOAT64):
        dtype = ar.dtype
        self.ar = ar
        per = [controller_matrices(cfg, G[c], T[c]) for c in range(G.shape[0])]
        mats = {k: np.stack([p[k] for p in per]) for k in per[0]}
        idx = torch.as_tensor(ctrl, device=device)
        self.m_ = {k: torch.as_tensor(v, dtype=dtype, device=device).index_select(0, idx)
                   for k, v in mats.items()}
        t = lambda v: torch.as_tensor(np.asarray(v, float), dtype=dtype, device=device)
        Hp = int(cfg["Hp"])
        self.uop, self.yop, self.dop = t(cfg["uop"]), t(cfg["yop"]), t(cfg["dop"])
        self.U0max = t(np.tile(np.subtract(cfg["umax"], cfg["uop"]), Hp))
        self.U0min = t(np.tile(np.subtract(cfg["umin"], cfg["uop"]), Hp))
        self.Y0max = t(np.tile(np.subtract(cfg["ymax"], cfg["yop"]), Hp))
        self.Y0min = t(np.tile(np.subtract(cfg["ymin"], cfg["yop"]), Hp))
        self.Hp, self.nu = Hp, len(cfg["uop"])
        self.n = self.nu * int(cfg["Hc"]) + 1
        self.m = 2 * self.U0max.numel() + 2 * self.Y0max.numel() + 1
        E, Pu = self.m_["E"], self.m_["Pu"]
        L = E.shape[0]
        one = torch.ones(L, E.shape[1], 1, dtype=dtype, device=device)
        zu = torch.zeros(L, Pu.shape[1], 1, dtype=dtype, device=device)
        eps = torch.zeros(L, 1, self.n, dtype=dtype, device=device)
        eps[:, 0, -1] = -1.0
        self.Grows = torch.cat([torch.cat([Pu, zu], -1), torch.cat([-Pu, zu], -1),
                                torch.cat([E, -one], -1), torch.cat([-E, -one], -1), eps], 1)
        self.dtype = dtype

    def run(self, ym, ry, d):
        """u (K, L, nu) and the QPs' KKT residual (K, L) from the recorded
        ``ym`` (K, L, ny), ``ry`` (K, L, ny) and ``d`` (K, L, nd)."""
        L, dev = ym.shape[1], ym.device
        st = dict(x=torch.zeros(L, self.m_["Ah"].shape[1], dtype=self.dtype, device=dev),
                  lastu0=torch.zeros(L, self.nu, dtype=self.dtype, device=dev))
        return graphed.run(self.period, st, [ym, ry, d])

    def period(self, st, inputs):
        """One period of every recorded lane: correction, QP, prediction."""
        m_, dt = self.m_, self.dtype
        ym, ry, d = (t.to(dt) for t in inputs)
        mv = self.ar.mv
        x, lastu0 = st["x"], st["lastu0"]
        zero = torch.zeros(x.shape[0], 1, dtype=dt, device=x.device)
        d0 = d - self.dop
        v = ym - self.yop - mv(m_["Ch"], x) - mv(m_["Dd"], d0)
        xc = x + mv(m_["K"], v)
        F = mv(m_["Kx"], xc) + mv(m_["Vx"], lastu0) + mv(m_["Gx"], d0)
        Cy = F + self.yop.repeat(self.Hp) - ry.repeat(1, self.Hp)
        q = torch.cat([2 * mv(m_["E"].transpose(1, 2), mv(m_["M"], Cy)), zero], -1)
        Tl = mv(m_["Tu"], lastu0)
        h = torch.cat([self.U0max - Tl, Tl - self.U0min, self.Y0max - F, F - self.Y0min,
                       zero], -1)
        Z, kkt = qp_ref.solve(m_["H"], q, self.Grows, h, ar=self.ar)
        u0 = torch.minimum(torch.maximum(lastu0 + Z[:, :self.nu], self.U0min[:self.nu]),
                           self.U0max[:self.nu])
        x.copy_(mv(m_["Ah"], xc) + mv(m_["Buh"], u0) + mv(m_["Bdh"], d0))
        lastu0.copy_(u0)
        return u0 + self.uop, kkt
