"""Batched LinMPC serving fleet (torch port of ``mpc_tpu/parallel/batch.py``).

One fleet step runs, for every lane at once: the steady-Kalman correction,
the LinMPC step (F/q̃ build, bounds, warm-start shift, the batched QP —
ADMM with the hand-written sweep kernel, or Goldfarb–Idnani with the
hand-written per-lane solve kernel and its cross-period operator carry —
receding input) and the Kalman prediction (``mpc_tpu``
``batch.py:191-217``).  Parameters are stacked over the DISTINCT
controllers only and read per lane through ``lane_ctrl``
(``grouped.py``); per-lane state lives on the device between steps.
``limit_solve_time`` is the Ts-deadline policy of the reference's fleet
(``mpc_tpu/parallel/batch.py:87-99, 369-490``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..controllers.linmpc import LinMPC, _build_step
from ..ops.admm_kernel import admm_sweep
from ..ops.gi_kernel import gi_solve, slot_dtype_for
from ..ops.qp import _check_cache_penalties
from ..ops.qp_active import gi_state_init
from ..utils.config import as_device, resolve_device
from ..utils.lanes import mv, take
from ..utils.trace import ROOT, span, synced
from .grouped import lane_ctrl as _lane_ctrl
from .mesh import LaneShards

STATE_KEYS = ("x0_hat", "lastu0", "Z_tilde", "y_dual", "rho_rung", "qp_state")
GI_STATE_KEYS = ("gis_idx", "gis_side", "gis_vmask", "gis_Ginv")


def stack_params(controllers):
    """Stack the params dicts of several same-shaped controllers (NumPy)."""
    keys = controllers[0].params.keys()
    return {k: np.stack([np.asarray(c.params[k]) for c in controllers])
            for k in keys}


def _estimator_dict(c):
    e = c.estim
    return dict(K_hat=e.K_hat, A_hat=e.A_hat, Bu_hat=e.Bu_hat,
                Cm_hat=e.Cm_hat, Ddm_hat=e.Ddm_hat, Bd_hat=e.Bd_hat,
                fop_m_xop=e.fop_hat - e.xop_hat, yop_m=e.model.yop[e.i_ym],
                uop=e.model.uop, dop=e.model.dop)


def estimator_params(controllers):
    """Stacked SteadyKalmanFilter matrices for the batched feedback path
    (NumPy; the same keys as ``mpc_tpu.parallel.estimator_params``)."""
    per = [_estimator_dict(c) for c in controllers]
    return {k: np.stack([np.asarray(d[k]) for d in per]) for k in per[0]}


def _structure(p):
    """Static step shapes, recovered from one controller's params dict."""
    nu = p["C_umin_u"].shape[0]
    Hp = p["Uop"].shape[0] // nu
    ny = p["Yop"].shape[0] // Hp
    Hc = p["DUmin"].shape[0] // nu
    nx_hat = p["x0min"].shape[0]
    nW = p["Wmin_b"].shape[0]
    nZt = p["H"].shape[0]
    n_ineq = 2 * (nu * Hp + nu * Hc + ny * Hp + nW + nx_hat)
    n_eq = nZt - p["Nnull"].shape[1] if "Nnull" in p else 0
    n_eps = p["A_stack"].shape[0] - n_ineq - n_eq
    if n_eps not in (0, 1):
        raise ValueError("params dict does not describe a LinMPC row stack")
    return dict(nu=nu, Hc=Hc, nd=p["dop_w"].shape[0], n_eps=n_eps,
                nZ=nZt - n_eps, n_ineq=n_ineq, n_eq=n_eq, is_ms=n_eq > 0,
                nx_hat=nx_hat, nw=nW // (Hp + 1), Hp=Hp, ny=ny)


class _Part:
    """The lanes of one shard or chunk: its configurations' params and
    estimator matrices, its lane map into them (made once, so the kernels'
    lane grouping is cached for the fleet's life) and its lanes' state,
    all on its device."""

    def __init__(self, params, eparams, lane_ctrl, state):
        self.params, self.eparams, self.lane_ctrl = params, eparams, lane_ctrl
        self.state = state


class _Chunks:
    """The split of one device's lanes into ``grouped_chunks`` index sets
    (``split``/``gather``/``psum`` as ``mesh.LaneShards``)."""

    def __init__(self, lane_sets, device):
        self.index = [torch.as_tensor(ls, dtype=torch.int64, device=device)
                      for ls in lane_sets]
        self.B = sum(len(ls) for ls in lane_sets)
        self.devices = (device,) * len(lane_sets)

    def split(self, x, dim=0):
        return [x.index_select(dim, i) for i in self.index]

    def gather(self, parts, dim=0):
        out = parts[0].new_empty(parts[0].shape[:dim] + (self.B,) + parts[0].shape[dim + 1:])
        for i, p in zip(self.index, parts):
            out.index_copy_(dim, i, p)
        return out

    def psum(self, parts):
        return torch.stack(parts).sum(0)


class BatchedLinMPC:
    """Lockstep batch of LinMPC controllers (one plant model each).

    ``step(ym, ry, d)`` runs the full control step for every lane.  The
    fleet has ``B = len(controllers)·reps`` lanes in the public order
    ``lane = r·n_d + c``; ``share_params=True`` is one controller shared by
    ``reps`` lanes.  The fleet lives on ``device``: the GPU unless the
    caller asks for another (``device="cpu"``); without a GPU the default
    raises.  ``sweep`` (also an attribute) is the ADMM inner sweep
    and the attribute ``gi`` the Goldfarb–Idnani per-lane solve: by
    default the CUDA kernels on a GPU and their plain versions on the CPU;
    checks set ``ops.admm_kernel.admm_sweep_reference`` /
    ``ops.gi_kernel.gi_solve_reference`` to compare the two.

    A fleet of ``qp_solver="active_set"`` controllers solves with GI and
    carries each lane's active-set operators in ``state["qp_state"]``;
    ``gi_slot_dtype`` picks float32 slots for a float32 fleet (default
    float64, the reference's mixed precision).

    ``mesh`` (a sequence of devices, ``parallel/mesh.py``) shards the lanes:
    shard ``s`` holds the contiguous lanes ``[s·B/k, (s+1)·B/k)`` with their
    state, the distinct configurations they read (the shared one, replicated,
    for ``share_params``) and a lane map into them, on ``mesh[s]``; the
    fleet's ``device`` is ``mesh[0]``, where ``step`` returns u and the
    fleet-wide ``n_conv``.

    ``grouped_chunks``: the reference's chunking of a grouped fleet's
    distinct configurations (a shared fleet's lanes) into this many groups
    solved one after another, so that each group's lockstep ADMM outer loop
    exits at the group's slowest lane.  It needs ``n_distinct`` (``B`` for
    ``share_params``) to be a multiple of it, is ignored when ``reps`` is 1
    and refused with a mesh.  With GI the option is checked and the fleet
    keeps its single launch: the per-lane kernel has no lockstep tail.
    The answers are per lane, the same with and without chunks or shards.
    """

    def __init__(self, controllers: list[LinMPC], *, device=None,
                 dtype=torch.float64, reps: int = 1,
                 share_params: bool = False, mesh=None,
                 limit_solve_time: bool = False, grouped_chunks: int = 1,
                 sweep=admm_sweep, gi_slot_dtype=None):
        solvers = {c.qp_solver for c in controllers}
        caps = {c.gi_max_active for c in controllers}
        if len(solvers) != 1 or len(caps) != 1:
            raise ValueError("a fleet's controllers must share qp_solver and "
                             "gi_max_active")
        self._setup([c.params for c in controllers],
                    [_estimator_dict(c) for c in controllers], reps=reps,
                    share_params=share_params, device=device, dtype=dtype,
                    sweep=sweep, gi_max_active=caps.pop(),
                    gi_slot_dtype=gi_slot_dtype, mesh=mesh,
                    grouped_chunks=grouped_chunks)
        self.Ts = float(controllers[0].estim.model.Ts)
        self.limit_solve_time = bool(limit_solve_time)

    @classmethod
    def from_params(cls, params_list, eparams_list, *, reps=1,
                    share_params=False, device=None, dtype=torch.float64,
                    sweep=admm_sweep, gi_max_active=None,
                    gi_slot_dtype=None, mesh=None, grouped_chunks=1):
        """Fleet from ``LinMPC.params`` dicts and per-controller estimator
        dicts (NumPy arrays; the keys of ``estimator_params``), e.g. the
        ones a ``mpc_tpu`` controller built.  A params dict with
        ``gic_Pinv`` is a GI controller's; the dict does not carry its slot
        cap, so ``gi_max_active`` (and ``gi_slot_dtype``) come here."""
        self = cls.__new__(cls)
        self._setup(params_list, eparams_list, reps=reps,
                    share_params=share_params, device=device, dtype=dtype,
                    sweep=sweep, gi_max_active=gi_max_active,
                    gi_slot_dtype=gi_slot_dtype, mesh=mesh,
                    grouped_chunks=grouped_chunks)
        return self

    def _setup(self, params_list, eparams_list, *, reps, share_params,
               device, dtype, sweep, gi_max_active, gi_slot_dtype, mesh,
               grouped_chunks):
        if share_params and len(params_list) != 1:
            raise ValueError("share_params=True expects exactly one "
                             "controller (the shared configuration); set "
                             "reps=B for the fleet size")
        if "gic_Pinv" in params_list[0]:
            self.qp_solver = "active_set"
        elif "qpc_Minvs" in params_list[0]:
            self.qp_solver = "admm"
            for p in params_list:      # the step solves with the defaults
                _check_cache_penalties(p, sigma=1e-6, rho=0.1)
        else:
            raise ValueError("params dict has neither the ADMM cache "
                             "(qpc_Minvs) nor the GI cache (gic_Pinv)")
        self.n_distinct = len(params_list)
        self.reps = int(reps)
        self.B = self.n_distinct * self.reps
        self.share_params = bool(share_params)
        self.grouped_chunks = int(grouped_chunks)
        if self.grouped_chunks < 1:
            raise ValueError("grouped_chunks must be ≥ 1")
        if self.grouped_chunks > 1 and mesh is not None:
            raise ValueError("grouped_chunks is a single-device "
                             "optimization; it cannot be combined with a "
                             "mesh-sharded fleet")
        grouped = self.reps > 1 and not self.share_params
        if grouped and self.grouped_chunks > 1 and self.n_distinct % self.grouped_chunks:
            raise ValueError(f"n_distinct ({self.n_distinct}) must be a "
                             f"multiple of grouped_chunks ({self.grouped_chunks})")
        if self.share_params and self.grouped_chunks > 1 and self.B % self.grouped_chunks:
            raise ValueError(f"B ({self.B}) must be a multiple of grouped_chunks "
                             f"({self.grouped_chunks}) for a share_params fleet")
        self.mesh = None if mesh is None else LaneShards(mesh, self.B)
        if self.mesh is not None:
            if device is not None and as_device(resolve_device(device)) != self.mesh.home:
                raise ValueError("a mesh-sharded fleet lives on mesh[0]; "
                                 f"device={device!r} differs")
            self.device = self.mesh.home
        else:
            self.device = resolve_device(device)
        self.dtype = dtype
        s = _structure({k: np.asarray(v) for k, v in params_list[0].items()})
        self.nu, self.nd, self.Hp, self.ny = s["nu"], s["nd"], s["Hp"], s["ny"]
        self.n_qp = s["nZ"] + s["n_eps"] - s["n_eq"]
        use_as = self.qp_solver == "active_set"
        self.gi_max_active = None if gi_max_active is None else int(gi_max_active)
        self.gi_slots = (min(self.n_qp, self.gi_max_active)
                         if use_as and self.gi_max_active is not None else self.n_qp)
        self.gi_slot_dtype = slot_dtype_for(dtype, gi_slot_dtype) if use_as else None

        def upload(dicts, skip=()):
            out = {}
            for k in dicts[0]:
                if k in skip:
                    continue
                a = np.stack([np.asarray(d[k]) for d in dicts])
                t = torch.as_tensor(a, device=self.device)
                out[k] = t.to(dtype) if t.is_floating_point() else t
            return out

        self.params = upload(params_list, skip=("qpc_sigma", "qpc_rho"))
        self.eparams = upload(eparams_list)
        self.nym = self.eparams["Cm_hat"].shape[1]
        self.lane_ctrl = _lane_ctrl(self.n_distinct, self.reps, self.device)
        self._step_raw = _build_step(
            s["nu"], s["Hc"], s["nd"], s["n_eps"], s["nZ"], s["n_ineq"],
            s["n_eq"], s["is_ms"], s["nx_hat"], s["nw"],
            qp_solver=self.qp_solver, gi_max_active=self.gi_max_active,
            slot_dtype=self.gi_slot_dtype)
        self.sweep = sweep
        self.gi = gi_solve
        nZt, m = s["nZ"] + s["n_eps"], self.params["A_stack"].shape[1]

        def fresh_state(Bp, dev):
            z = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
            return dict(
                x0_hat=z(Bp, s["nx_hat"]), lastu0=z(Bp, self.nu), Z_tilde=z(Bp, nZt),
                y_dual=z(Bp, m),
                rho_rung=torch.full((Bp,), 4, dtype=torch.int32, device=dev),
                # GI cross-period operator carry (per-lane active set + Ginv)
                qp_state=(gi_state_init(self.gi_slots, Bp, self.gi_slot_dtype, dev)
                          if use_as else None))

        self._lanes, self._parts = self._split_lanes(grouped, fresh_state)
        self.last_iters = None
        # Ts-deadline policy (limit_solve_time=True; needs Ts, so only the
        # constructor from controllers turns it on): the QP iteration budget
        # of the next period comes from Ts and an EWMA of the measured wall
        # cost per iteration of the slowest lane
        self.Ts = None
        self.limit_solve_time = False
        self._iter_cost = None
        self.last_step_time = None
        self.last_iter_budget = None
        self.last_deadline_miss = False
        self.deadline_miss_count = 0
        self._mstep_shapes = set()

    def _split_lanes(self, grouped, fresh_state):
        """``(lanes, parts)``: the lane map (``None``, one part holding
        every lane; a ``mesh.LaneShards``; or the ADMM chunks) and a part a
        shard or chunk, each holding only its configurations."""
        n_d, B = self.n_distinct, self.B
        chunked = (self.qp_solver == "admm" and self.grouped_chunks > 1
                   and (grouped or self.share_params))
        if self.mesh is None and not chunked:
            return None, [_Part(self.params, self.eparams, self.lane_ctrl,
                                fresh_state(B, self.device))]
        ctrl_of = np.arange(B) % n_d              # the public lane order
        if self.mesh is not None:
            lanes = self.mesh
            lane_sets = [np.arange(B)[sl] for sl in lanes.slices]
        elif self.share_params:
            lane_sets = np.split(np.arange(B), self.grouped_chunks)
        else:
            per = n_d // self.grouped_chunks
            lane_sets = [np.flatnonzero(ctrl_of // per == j) for j in range(self.grouped_chunks)]
        if self.mesh is None:
            lanes = _Chunks(lane_sets, self.device)
        parts = []
        for ls, dev in zip(lane_sets, lanes.devices):
            used = np.unique(ctrl_of[ls])
            if used[-1] - used[0] + 1 == len(used):     # a range: views
                pick = lambda t, a=int(used[0]), b=int(used[-1]) + 1: t[a:b]
            else:
                idx = torch.as_tensor(used, device=self.device)
                pick = lambda t, idx=idx: t.index_select(0, idx)
            sub = lambda d: {k: pick(v).to(dev) for k, v in d.items()}
            lc = torch.as_tensor(np.searchsorted(used, ctrl_of[ls]), dtype=torch.int32,
                                 device=dev)
            parts.append(_Part(sub(self.params), sub(self.eparams), lc,
                               fresh_state(len(ls), dev)))
        return lanes, parts

    # ------------------------------------------------------------------
    def _split(self, x, dim=0):
        return [x] if self._lanes is None else self._lanes.split(x, dim)

    def _gather(self, parts, dim=0):
        return parts[0] if self._lanes is None else self._lanes.gather(parts, dim)

    def _gather_state(self, states):
        out = {k: self._gather([s[k] for s in states]) for k in STATE_KEYS
               if k != "qp_state"}
        qs = states[0]["qp_state"]
        out["qp_state"] = None if qs is None else {
            g: self._gather([s["qp_state"][g] for s in states]) for g in GI_STATE_KEYS}
        return out

    @property
    def state(self):
        """Per-lane state as NumPy arrays (a copy); ``qp_state`` is the dict
        of the four ``gis_*`` arrays for GI, None for ADMM."""
        host = lambda t: t.cpu().numpy().copy()
        full = self._gather_state([p.state for p in self._parts])
        out = {k: host(v) for k, v in full.items() if k != "qp_state"}
        qs = full["qp_state"]
        out["qp_state"] = None if qs is None else {k: host(v) for k, v in qs.items()}
        return out

    @state.setter
    def state(self, new):
        unknown = set(new) - set(STATE_KEYS)
        if unknown:
            raise KeyError(f"unknown state keys {sorted(unknown)}")
        cur_full = self._gather_state([p.state for p in self._parts])

        def tensor(name, v, cur):
            t = torch.as_tensor(np.array(v), device=self.device).to(cur.dtype)
            if t.shape != cur.shape:
                raise ValueError(f"state[{name!r}] must have shape "
                                 f"{tuple(cur.shape)}, got {tuple(t.shape)}")
            return [p.contiguous() for p in self._split(t)]

        for k, v in new.items():
            cur = cur_full[k]
            if k != "qp_state":
                for part, t in zip(self._parts, tensor(k, v, cur)):
                    part.state[k] = t
            elif cur is None:
                if v is not None:
                    raise ValueError("state['qp_state'] is None for an ADMM fleet")
            else:
                if v is None or set(v) != set(GI_STATE_KEYS):
                    raise ValueError("state['qp_state'] must hold the arrays "
                                     f"{', '.join(GI_STATE_KEYS)}")
                split = {g: tensor(f"qp_state.{g}", v[g], cur[g]) for g in GI_STATE_KEYS}
                for i, part in enumerate(self._parts):
                    part.state["qp_state"] = {g: split[g][i] for g in GI_STATE_KEYS}

    def _tensor(self, a, width, lead=()):
        if not torch.is_tensor(a):
            a = np.array(a)      # a writable host copy
        t = torch.as_tensor(a, dtype=self.dtype, device=self.device)
        if t.shape != lead + (self.B, width):
            raise ValueError(f"expected shape {lead + (self.B, width)}, got {tuple(t.shape)}")
        return t

    def _budget(self, iter_cost):
        """The iteration budget from a per-iteration cost (floor 50; 2**30
        means unlimited)."""
        if iter_cost:
            return int(np.clip(0.8 * self.Ts / iter_cost, 50, 2**30))
        return 2**30

    def _inputs(self, ym, ry, d, lead=()):
        """``(ym, ry, d)`` as tensors on the fleet's device in its dtype
        (zeros for a missing ``d``), split on the lane axis."""
        dim = len(lead)
        d = (torch.zeros(lead + (self.B, self.nd), dtype=self.dtype, device=self.device)
             if d is None else self._tensor(d, self.nd, lead))
        return (self._split(self._tensor(ym, self.nym, lead), dim),
                self._split(self._tensor(ry, self.ny, lead), dim), self._split(d, dim))

    def _part_period(self, part, ym, ry, d, budget):
        """One control period of one part's lanes: ``(u, conv, iters)``;
        the part's state advances."""
        ep, st, lc, B = part.eparams, part.state, part.lane_ctrl, ym.shape[0]
        E = lambda k: take(ep[k], lc)
        EM = lambda k, v: mv(ep[k], v, lc)
        with span("estimator.correct"):     # the SKF's constant gain
            d0 = d - E("dop") if self.nd else d
            y0m = ym - E("yop_m")
            x0 = st["x0_hat"]
            v = y0m - EM("Cm_hat", x0)
            if self.nd:
                v = v - EM("Ddm_hat", d0)
            x0c = x0 + EM("K_hat", v)
        # --- MPC solve ---
        zeros = lambda k: torch.zeros(B, k, dtype=self.dtype, device=ym.device)
        u, Z_t, y_dual, conv, _F, _obj, iters, rung, qps = self._step_raw(
            part.params, x0c, st["lastu0"], d0, d0.repeat(1, self.Hp),
            ry.repeat(1, self.Hp), take(part.params["Uop"], lc),
            zeros(part.params["Ks"].shape[2]), zeros(self.ny),
            st["Z_tilde"], st["y_dual"], st["rho_rung"], lc, self.sweep,
            qp_state=st["qp_state"], gi=self.gi,
            iter_budget=None if budget >= 2**30 else budget)
        lastu0 = u - E("uop")
        with span("estimator.predict"):
            x0n = EM("A_hat", x0c) + EM("Bu_hat", lastu0)
            if self.nd:
                x0n = x0n + EM("Bd_hat", d0)
            x0n = x0n + E("fop_m_xop")
        part.state = dict(x0_hat=x0n, lastu0=lastu0, Z_tilde=Z_t,
                          y_dual=y_dual, rho_rung=rung, qp_state=qps)
        return u, conv, iters

    def _period(self, ym, ry, d, budget):
        """One control period for every lane under an iteration budget,
        from the split inputs; returns ``(u, n_conv)`` on the fleet's device
        and sets ``last_iters`` (fleet-wide)."""
        outs = [self._part_period(p, *x, budget) for p, *x in zip(self._parts, ym, ry, d)]
        u, iters = (self._gather([o[i] for o in outs]) for i in (0, 2))
        n_conv = (outs[0][1].sum() if self._lanes is None
                  else self._lanes.psum([o[1].sum() for o in outs]))
        self.last_iters = torch.stack([iters.max(), iters.sum() // self.B])
        return u, n_conv

    def step(self, ym, ry, d=None):
        """One control period for every lane: returns ``(u, n_conv)`` with
        ``u`` (B, nu) and ``n_conv`` the number of converged QPs, both on the
        fleet's device.  ``last_iters`` holds the QP iterations' [max, mean].

        With ``limit_solve_time`` every step ends in a host copy of
        ``last_iters`` and records ``last_step_time``, ``last_iter_budget``,
        ``last_deadline_miss`` and ``deadline_miss_count``; the first step
        neither seeds the cost EWMA nor counts as a miss."""
        with span(ROOT, self.device):
            budget = self._budget(self._iter_cost if self.limit_solve_time else None)
            t0 = time.perf_counter()
            u, n_conv = self._period(*self._inputs(ym, ry, d), budget)
            self.last_iter_budget = budget
            if self.limit_solve_time:
                # the lockstep cost per iteration is set by the slowest lane
                it_max = float(synced(self.last_iters[0].item()))
                wall = time.perf_counter() - t0
                first = self.last_step_time is None
                if not first and it_max > 0:
                    c = wall / it_max
                    self._iter_cost = c if self._iter_cost is None else \
                        0.7 * self._iter_cost + 0.3 * c
                self.last_step_time = wall
                self.last_deadline_miss = (not first) and wall > self.Ts
                if self.last_deadline_miss:
                    self.deadline_miss_count += 1
        return u, n_conv

    def multistep(self, ym_seq, ry_seq, d_seq=None):
        """``K = ym_seq.shape[0]`` control periods, one ``step`` each.

        ``ym_seq``/``ry_seq``: (K, B, nym)/(K, B, ny); ``d_seq``: optional
        (K, B, nd).  Returns ``(U, n_conv)`` with ``U`` (K, B, nu) and
        ``n_conv`` (K,); ``last_iters`` is the final period's.

        With ``limit_solve_time`` the policy runs once per call, as the
        reference's in-graph scan does: the budget comes from the cost EWMA
        at the call's start, a period counts as a miss when its max
        iterations times that cost exceed Ts, and one host copy at the end
        updates the EWMA from the call's wall time (a call with a new (K, B)
        shape neither updates it nor counts misses)."""
        ic = self._iter_cost if self.limit_solve_time and self._iter_cost else 0.0
        budget = self._budget(ic)
        t0 = time.perf_counter()
        K = len(ym_seq)
        ym_p, ry_p, d_p = self._inputs(ym_seq, ry_seq, d_seq, lead=(K,))
        U, NC, IT = [], [], []
        for k in range(K):
            at = lambda parts: [x[k] for x in parts]
            with span(ROOT, self.device):
                u, n_conv = self._period(at(ym_p), at(ry_p), at(d_p), budget)
            U.append(u)
            NC.append(n_conv)
            IT.append(self.last_iters[0])
        self.last_iter_budget = budget
        if self.limit_solve_time:
            it_max = synced(torch.stack(IT).cpu()).numpy().astype(float)
            wall = time.perf_counter() - t0
            miss = (it_max * ic > self.Ts) if ic > 0 else np.zeros(K, bool)
            shape_key = (K, self.B)
            first = (self.last_step_time is None
                     or shape_key not in self._mstep_shapes)
            self._mstep_shapes.add(shape_key)
            if not first and it_max.sum() > 0:
                c = wall / it_max.sum()
                self._iter_cost = c if self._iter_cost is None else \
                    0.7 * self._iter_cost + 0.3 * c
            self.last_step_time = wall / K
            self.last_deadline_miss = bool(miss[-1])
            if not first:
                self.deadline_miss_count += int(miss.sum())
        return torch.stack(U), torch.stack(NC)
