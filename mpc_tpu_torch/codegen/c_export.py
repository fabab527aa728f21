"""Embedded C code generation for LinMPC (counterpart of
``mpc_tpu/codegen/c_export.py``).

``export_c`` emits ONE dependency-free C99 file implementing a port
``LinMPC``'s whole control step:

    SKF correction → F/q̃ build → constraint RHS → QP solve → receding
    input → SKF prediction

with the QP solved either by fixed-iteration ADMM (the pre-factorized KKT
inverse and the Ruiz scalings baked in as constants — the OSQP role) or by
an exact Goldfarb–Idnani dual active set warm-started from the persisted
duals (the DAQP role, mirroring ``ops/qp_active.py``).  The file is the
reference's, line for line, except its header comment.

Every matrix is compiled in as a ``static const double`` array read from the
controller's host NumPy params, never from device tensors; the hot loop is
plain matvecs — no malloc, no libm beyond fabs, suited to bare-metal
targets.  ``compile_and_load`` builds the file with the system C compiler
and returns a ctypes handle, e.g. to hold it against ``moveinput``.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np
import torch

from ..controllers.linmpc import LinMPC
from ..controllers.transcription import SingleShooting
from ..estimators import Luenberger, SteadyKalmanFilter
from ..ops.qp import _ruiz_equilibrate


def _carr(name, arr):
    arr = np.atleast_1d(np.asarray(arr, float))
    flat = arr.ravel()
    vals = ", ".join(f"{v:.17g}" for v in flat)
    return f"static const double {name}[{max(flat.size, 1)}] = {{{vals if flat.size else '0'}}};"


def export_c(ctrl: LinMPC, name="mpc", admm_iters=4000, admm_tol=1e-9,
             solver="admm"):
    """Generate standalone C99 source implementing ``ctrl``'s control step.

    ``solver="admm"`` emits the OSQP-role fixed-iteration ADMM with baked
    Ruiz scaling and active-set polish.  ``solver="active_set"`` emits the
    DAQP-role Goldfarb–Idnani dual active set (mirrors ops/qp_active.py):
    exact in a handful of pivots, warm-started from the persisted duals —
    the embedded form the reference gets from LinearMPC.jl's DAQP codegen
    (ext/LinearMPCext.jl).  Note: it embeds the m×m matrix A·P⁻¹·Aᵀ as a
    constant (~m²·8 bytes of flash), and that the C step
    has no convergence status output: on an infeasible QP it applies its
    final (clamped) iterate where the Python path warns and keeps the
    shifted warm start.
    """
    if solver not in ("admm", "active_set"):
        raise ValueError("solver must be 'admm' or 'active_set'")
    use_gi = solver == "active_set"
    estim = ctrl.estim
    if not isinstance(estim, (SteadyKalmanFilter, Luenberger)):
        # both are constant-gain observers sharing the same correct/predict
        # form, so the generated C is identical up to the K̂ constant
        # (ext/LinearMPCext.jl has the same observer restriction)
        raise ValueError("C export currently supports LinMPC with a "
                         "SteadyKalmanFilter or Luenberger observer")
    if not isinstance(ctrl.transcription, SingleShooting):
        raise ValueError("C export supports the SingleShooting transcription")
    if getattr(ctrl, "nw", 0):
        raise ValueError("C export does not support custom linear constraints")
    model = estim.model
    p = {k: np.asarray(v) for k, v in ctrl.params.items()}
    nu, ny, nd = model.nu, model.ny, model.nd
    nx = estim.nx_hat
    Hp, Hc = ctrl.Hp, ctrl.Hc
    nZ = ctrl.nZt
    A = p["A_stack"]
    m = A.shape[0]
    n_ineq, n_eps, n_eq = ctrl.n_ineq, ctrl.n_eps, ctrl.n_eq
    sigma = 1e-6
    if use_gi:
        # GI is exact on the raw problem — identity scalings keep the shared
        # q̃/bounds/receding-input code identical to the ADMM path
        Hs, As = p["H"], A
        Dv, Ev, csc = np.ones(nZ), np.ones(m), 1.0
        try:
            np.linalg.cholesky(0.5 * (p["H"] + p["H"].T))
        except np.linalg.LinAlgError:
            raise ValueError(
                "active-set export needs a strictly convex QP (Goldfarb-"
                "Idnani requirement): H is not positive definite — check "
                "Nwt > 0 and the plant's input directions")
        Pinv = np.linalg.inv(p["H"])
        HIAT = Pinv @ A.T            # (nZ, m): P⁻¹ aᵢ columns
        GIG = A @ HIAT               # (m, m): aᵢᵀ P⁻¹ aⱼ
    else:
        # bake Ruiz equilibration in (constant H/A → constant scalings),
        # on one lane of float64 CPU tensors whatever the controller's
        # device and dtype
        f64 = lambda a: torch.as_tensor(np.asarray(a, float), dtype=torch.float64)[None]
        Hs, _, As, Dv, Ev, csc = (t[0].numpy() for t in _ruiz_equilibrate(
            f64(p["H"]), f64(np.zeros(nZ)), f64(A)))
        # The runtime bounds vary, so the baked ρ must be conservative: full
        # weight on every inequality row (the "loose-row" down-weighting of
        # ops/qp.py would cripple rows whose runtime bound is finite), 1000×
        # on equality rows — mirroring OSQP's defaults.
        rho = np.concatenate([np.full(n_ineq + n_eps, 0.1),
                              np.full(n_eq, 100.0)])
        M = Hs + sigma * np.eye(nZ) + (As.T * rho) @ As
        Minv = np.linalg.inv(M)
    A = As
    # q̃ precomputations: q = Wq_y (F + Yop − R̂y) + Wq_u (Tu·lastu0 + Uop − R̂u)
    # (pre-scaled: q̄ = c·D·q folded into the Wq matrices; identity for GI)
    Wq_y = (csc * Dv)[:, None] * (2.0 * p["E_t"].T @ p["M_Hp"])
    Wq_u = (csc * Dv)[:, None] * (2.0 * p["Pu_t"].T @ p["L_Hp"])

    nym = estim.nym
    lines = [
        "/* Auto-generated by mpc_tpu_torch.codegen — standalone LinMPC step.",
        f" * nu={nu} ny={ny} nym={nym} nd={nd} nx̂={nx} Hp={Hp} Hc={Hc} nZ̃={nZ} m={m}",
        f" * QP solver: {'Goldfarb-Idnani dual active set' if use_gi else 'ADMM + polish'} */",
        "#include <math.h>",
        "#include <string.h>",
        f"#define NU {nu}",
        f"#define NYM {nym}",
        f"#define ND {nd}",
        f"#define NX {nx}",
        f"#define NY {ny}",
        f"#define HP {Hp}",
        f"#define NZ {nZ}",
        f"#define M_ROWS {m}",
        f"#define N_INEQ {n_ineq}",
        f"#define N_EPS {n_eps}",
        f"#define ADMM_ITERS {admm_iters}",
        f"#define ADMM_TOL {admm_tol:.3g}",
        f"#define SIGMA {sigma:.3g}",
        "",
        _carr("C_K", p["K"]), _carr("C_V", p["V"]), _carr("C_B", p["B"]),
        _carr("C_G", p["G"]), _carr("C_J", p["J"]),
        _carr("C_kx", p["kx"]), _carr("C_vx", p["vx"]), _carr("C_bx", p["bx"]),
        _carr("C_gx", p["gx"]), _carr("C_jx", p["jx"]),
        _carr("C_A", A),
        _carr("C_HS", Hs), _carr("C_DSC", Dv), _carr("C_ESC", Ev),
        _carr("C_WQY", Wq_y), _carr("C_WQU", Wq_u),
        _carr("C_TU", p["Tu"]),
        _carr("C_UOP", p["Uop"]), _carr("C_YOP", p["Yop"]),
        _carr("C_U0MIN", p["U0min"]), _carr("C_U0MAX", p["U0max"]),
        _carr("C_CUMINU", p["C_umin_u"]), _carr("C_CUMAXU", p["C_umax_u"]),
        _carr("C_DUMIN", p["DUmin"]), _carr("C_DUMAX", p["DUmax"]),
        _carr("C_Y0MIN", p["Y0min"]), _carr("C_Y0MAX", p["Y0max"]),
        _carr("C_X0MIN", p["x0min"]), _carr("C_X0MAX", p["x0max"]),
        # estimator
        _carr("C_KHAT", estim.K_hat), _carr("C_AH", estim.A_hat),
        _carr("C_BUH", estim.Bu_hat), _carr("C_BDH", estim.Bd_hat),
        _carr("C_CMH", estim.Cm_hat), _carr("C_DDMH", estim.Ddm_hat),
        _carr("C_FOPX", estim.fop_hat - estim.xop_hat),
        _carr("C_YOPM", model.yop[estim.i_ym]),
        _carr("C_UOP1", model.uop), _carr("C_DOP", model.dop),
    ]
    if use_gi:
        lines += [_carr("C_PINV", Pinv), _carr("C_HIAT", HIAT),
                  _carr("C_GIG", GIG),
                  "#define GI_TOL 1e-9",
                  f"#define GI_MAXPIV {8 * nZ + 16}"]
    else:
        lines += [_carr("C_MINV", Minv), _carr("C_RHO", rho)]
    lines += [
        "",
        "typedef struct {",
        "    double xhat[NX];      /* estimator state (deviation) */",
        "    double lastu0[NU];",
        "    double z[NZ];         /* QP warm start */",
    ] + (["    double zd[M_ROWS];   /* ADMM z */"] if solver == "admm"
         else []) + [
        "    double yd[M_ROWS];    /* QP duals (GI: warm-start active set) */",
        f"}} {name}_state_t;",
        "",
        "static void matvec(const double*A_, int r, int c, const double*x, double*y){",
        "    for(int i=0;i<r;i++){double s=0; for(int j=0;j<c;j++) s+=A_[i*c+j]*x[j]; y[i]=s;}}",
        "static void matvec_add(const double*A_, int r, int c, const double*x, double*y){",
        "    for(int i=0;i<r;i++){double s=0; for(int j=0;j<c;j++) s+=A_[i*c+j]*x[j]; y[i]+=s;}}",
        "static void matvec_t_add(const double*A_, int r, int c, const double*x, double*y){",
        "    for(int j=0;j<c;j++){double s=0; for(int i=0;i<r;i++) s+=A_[i*c+j]*x[i]; y[j]+=s;}}",
    ]
    if use_gi:
        lines += [
            "/* Gaussian elimination with partial pivoting (in-place, row-major,",
            "   stride nn).  Returns 0 on a (near-)singular pivot. */",
            "static int ge_solve(double*K, double*b, int nn){",
            "    int r, c, i2;",
            "    for(r=0;r<nn;r++){ int piv=r; double mx=fabs(K[r*nn+r]);",
            "      for(i2=r+1;i2<nn;i2++){ double a2=fabs(K[i2*nn+r]); if(a2>mx){mx=a2;piv=i2;} }",
            "      if(mx<1e-13) return 0;",
            "      if(piv!=r){ for(c=0;c<nn;c++){ double t=K[r*nn+c]; K[r*nn+c]=K[piv*nn+c]; K[piv*nn+c]=t; }",
            "        double t=b[r]; b[r]=b[piv]; b[piv]=t; }",
            "      for(i2=r+1;i2<nn;i2++){ double f=K[i2*nn+r]/K[r*nn+r];",
            "        if(f!=0){ for(c=r;c<nn;c++) K[i2*nn+c]-=f*K[r*nn+c]; b[i2]-=f*b[r]; } } }",
            "    for(r=nn-1;r>=0;r--){ double s2=b[r];",
            "      for(c=r+1;c<nn;c++) s2-=K[r*nn+c]*b[c];",
            "      b[r]=s2/K[r*nn+r]; }",
            "    return 1; }",
        ]
    lines += [
        "",
        f"void {name}_init({name}_state_t*s){{ memset(s,0,sizeof(*s)); }}",
        "",
        f"void {name}_step({name}_state_t*s, const double ym[NYM], const double ry[NY],",
        "              const double d[ND>0?ND:1], double u_out[NU]){",
        "    double d0[ND>0?ND:1]; double F[NY*HP]; double q[NZ];",
        "    double bl[M_ROWS], bu[M_ROWS];",
        "    double tmpy[NY*HP]; double tul[NU*HP]; double fx[NX];",
        "    int i;",
        "    for(i=0;i<ND;i++) d0[i]=d[i]-C_DOP[i];",
        "    /* --- SKF correction --- */",
        "    double v[NYM];",
        "    matvec(C_CMH, NYM, NX, s->xhat, v);",
        "    if(ND>0) matvec_add(C_DDMH, NYM, ND, d0, v);",
        "    for(i=0;i<NYM;i++) v[i]=(ym[i]-C_YOPM[i])-v[i];",
        "    matvec_add(C_KHAT, NX, NYM, v, s->xhat);",
        "    /* --- predictions F = B + K x + V lastu0 (+G d0 + J D) --- */",
        "    memcpy(F, C_B, sizeof(F));",
        "    matvec_add(C_K, NY*HP, NX, s->xhat, F);",
        "    matvec_add(C_V, NY*HP, NU, s->lastu0, F);",
        "    if(ND>0){ double Dh[ND*HP];",
        "        for(i=0;i<HP;i++) memcpy(Dh+i*ND, d0, ND*sizeof(double));",
        "        matvec_add(C_G, NY*HP, ND, d0, F);",
        "        matvec_add(C_J, NY*HP, ND*HP, Dh, F); }",
        "    /* --- q = WQY (F + Yop − R̂y) + WQU (Tu lastu0 + Uop − R̂u) --- */",
        "    for(i=0;i<NY*HP;i++) tmpy[i]=F[i]+C_YOP[i]-ry[i%NY];",
        "    matvec(C_WQY, NZ, NY*HP, tmpy, q);",
        "    matvec(C_TU, NU*HP, NU, s->lastu0, tul);",
        "    { double cu[NU*HP];",
        "      for(i=0;i<NU*HP;i++) cu[i]=tul[i];  /* R̂u = Uop cancels */",
        "      matvec_add(C_WQU, NZ, NU*HP, cu, q); }",
        "    /* --- terminal fx --- */",
        "    memcpy(fx, C_bx, sizeof(fx));",
        "    matvec_add(C_kx, NX, NX, s->xhat, fx);",
        "    matvec_add(C_vx, NX, NU, s->lastu0, fx);",
        "    if(ND>0){ double Dh[ND*HP];",
        "        for(i=0;i<HP;i++) memcpy(Dh+i*ND, d0, ND*sizeof(double));",
        "        matvec_add(C_gx, NX, ND, d0, fx);",
        "        matvec_add(C_jx, NX, ND*HP, Dh, fx); }",
        "    /* --- bounds l/u per row block --- */",
        "    memset(bl, 0, sizeof(bl)); memset(bu, 0, sizeof(bu));",
        "    { int r=0; int k;",
        f"      for(k=0;k<{nu*Hp};k++){{ bl[r]=-2e18; bu[r]=-C_U0MIN[k]+tul[k]; r++; }}",
        f"      for(k=0;k<{nu*Hp};k++){{ bl[r]=-2e18; bu[r]= C_U0MAX[k]-tul[k]; r++; }}",
        f"      for(k=0;k<{nu*Hc};k++){{ bl[r]=-2e18; bu[r]=-C_DUMIN[k]; r++; }}",
        f"      for(k=0;k<{nu*Hc};k++){{ bl[r]=-2e18; bu[r]= C_DUMAX[k]; r++; }}",
        f"      for(k=0;k<{ny*Hp};k++){{ bl[r]=-2e18; bu[r]=-C_Y0MIN[k]+F[k]; r++; }}",
        f"      for(k=0;k<{ny*Hp};k++){{ bl[r]=-2e18; bu[r]= C_Y0MAX[k]-F[k]; r++; }}",
        f"      for(k=0;k<{nx};k++){{ bl[r]=-2e18; bu[r]=-C_X0MIN[k]+fx[k]; r++; }}",
        f"      for(k=0;k<{nx};k++){{ bl[r]=-2e18; bu[r]= C_X0MAX[k]-fx[k]; r++; }}",
        "      if(N_EPS){ bl[r]=0; bu[r]=2e18; r++; }",
        "      (void)r; }",
    ]
    if not use_gi:
        lines += [
            "    /* Ruiz row scaling + clip */",
            "    for(i=0;i<M_ROWS;i++){ bl[i]*=C_ESC[i]; bu[i]*=C_ESC[i];",
            "        if(bu[i]>2e18) bu[i]=2e18; if(bl[i]<-2e18) bl[i]=-2e18; }",
            "    /* --- warm start: shift ΔU --- */",
            "    { double zs[NZ]; memset(zs,0,sizeof(zs));",
            f"      for(i=0;i<{nu*(Hc-1)};i++) zs[i]=s->z[i+NU];",
            "      if(N_EPS) zs[NZ-1]=s->z[NZ-1];",
            "      memcpy(s->z, zs, sizeof(zs)); }",
            "    /* --- ADMM --- */",
            "    { double x[NZ], zz[M_ROWS], y[M_ROWS], rhs[NZ], xt[NZ], zt[M_ROWS];",
            "      /* primal warm start only: duals from the previous problem",
            "         (different q / bounds) stall the fixed-iteration ADMM */",
            "      memcpy(x, s->z, sizeof(x));",
            "      memset(y, 0, sizeof(y));",
            "      for(int attempt=0; attempt<2; attempt++){",
            "      if(attempt){ memset(x,0,sizeof(x)); memset(y,0,sizeof(y)); }",
            "      matvec(C_A, M_ROWS, NZ, x, zz);",
            "      for(i=0;i<M_ROWS;i++){ if(zz[i]<bl[i]) zz[i]=bl[i]; if(zz[i]>bu[i]) zz[i]=bu[i]; }",
            "      for(int it=0; it<ADMM_ITERS; it++){",
            "        double t[M_ROWS];",
            "        for(i=0;i<M_ROWS;i++) t[i]=C_RHO[i]*zz[i]-y[i];",
            "        for(i=0;i<NZ;i++) rhs[i]=SIGMA*x[i]-q[i];",
            "        matvec_t_add(C_A, M_ROWS, NZ, t, rhs);",
            "        matvec(C_MINV, NZ, NZ, rhs, xt);",
            "        matvec(C_A, M_ROWS, NZ, xt, zt);",
            "        const double al=1.6;",
            "        for(i=0;i<NZ;i++) x[i]=al*xt[i]+(1-al)*x[i];",
            "        for(i=0;i<M_ROWS;i++){",
            "          double zp=al*zt[i]+(1-al)*zz[i];",
            "          double zn=zp+y[i]/C_RHO[i];",
            "          if(zn<bl[i]) zn=bl[i]; if(zn>bu[i]) zn=bu[i];",
            "          y[i]+=C_RHO[i]*(zp-zn);",
            "          zz[i]=zn; }",
            "        if(it%25==24){  /* true primal/dual residual test */",
            "          double rp=0, rd=0, Ax2, g2[NZ];",
            "          for(i=0;i<M_ROWS;i++){ Ax2=0;",
            "            for(int c3=0;c3<NZ;c3++) Ax2+=C_A[i*NZ+c3]*x[c3];",
            "            double e=fabs(Ax2-zz[i]); if(e>rp) rp=e; }",
            "          matvec(C_HS, NZ, NZ, x, g2);",
            "          for(i=0;i<NZ;i++) g2[i]+=q[i];",
            "          matvec_t_add(C_A, M_ROWS, NZ, y, g2);",
            "          for(i=0;i<NZ;i++){ double e=fabs(g2[i]); if(e>rd) rd=e; }",
            "          if(rp<ADMM_TOL && rd<ADMM_TOL) break; }",
            "      }",
            "      /* cold-restart fallback if the warm start stalled the ADMM */",
            "      { double rp2=0, Ax3;",
            "        for(i=0;i<M_ROWS;i++){ Ax3=0;",
            "          for(int c4=0;c4<NZ;c4++) Ax3+=C_A[i*NZ+c4]*x[c4];",
            "          double e=fabs(Ax3-zz[i]); if(e>rp2) rp2=e; }",
            "        if(rp2<1e-6) break; } }",
            "      /* --- active-set polish: solve the equality-constrained KKT",
            "         system by Gaussian elimination (mirrors ops/qp.py _polish) --- */",
            "      { static double Km[(NZ+M_ROWS)*(NZ+M_ROWS)];",
            "        static double rhs2[NZ+M_ROWS]; static int act[M_ROWS]; static int side[M_ROWS];",
            "        int na=0, r2, c2;",
            "        for(i=0;i<M_ROWS;i++){",
            "          if(bu[i]-bl[i]<1e-12){ act[na]=i; side[na]=0; rhs2[NZ+na]=bu[i]; na++; }",
            "          else if(y[i]<-1e-9 && bl[i]>-1e17){ act[na]=i; side[na]=-1; rhs2[NZ+na]=bl[i]; na++; }",
            "          else if(y[i]>1e-9 && bu[i]<1e17){ act[na]=i; side[na]=+1; rhs2[NZ+na]=bu[i]; na++; } }",
            "        int nn=NZ+na;",
            "        for(r2=0;r2<NZ;r2++){ for(c2=0;c2<NZ;c2++) Km[r2*nn+c2]=C_HS[r2*NZ+c2];",
            "          Km[r2*nn+r2]+=1e-10;",
            "          for(c2=0;c2<na;c2++) Km[r2*nn+NZ+c2]=C_A[act[c2]*NZ+r2];",
            "          rhs2[r2]=-q[r2]; }",
            "        for(r2=0;r2<na;r2++){ for(c2=0;c2<NZ;c2++) Km[(NZ+r2)*nn+c2]=C_A[act[r2]*NZ+c2];",
            "          for(c2=0;c2<na;c2++) Km[(NZ+r2)*nn+NZ+c2]=(r2==c2)?-1e-10:0.0; }",
            "        /* gaussian elimination with partial pivoting */",
            "        int ok=1;",
            "        for(r2=0;r2<nn && ok;r2++){ int piv=r2; double mx=fabs(Km[r2*nn+r2]);",
            "          for(i=r2+1;i<nn;i++){ double a2=fabs(Km[i*nn+r2]); if(a2>mx){mx=a2;piv=i;} }",
            "          if(mx<1e-14){ ok=0; break; }",
            "          if(piv!=r2){ for(c2=0;c2<nn;c2++){ double t2=Km[r2*nn+c2];",
            "              Km[r2*nn+c2]=Km[piv*nn+c2]; Km[piv*nn+c2]=t2; }",
            "            double t2=rhs2[r2]; rhs2[r2]=rhs2[piv]; rhs2[piv]=t2; }",
            "          for(i=r2+1;i<nn;i++){ double f2=Km[i*nn+r2]/Km[r2*nn+r2];",
            "            if(f2!=0){ for(c2=r2;c2<nn;c2++) Km[i*nn+c2]-=f2*Km[r2*nn+c2];",
            "              rhs2[i]-=f2*rhs2[r2]; } } }",
            "        if(ok){ for(r2=nn-1;r2>=0;r2--){ double s2=rhs2[r2];",
            "            for(c2=r2+1;c2<nn;c2++) s2-=Km[r2*nn+c2]*rhs2[c2];",
            "            rhs2[r2]=s2/Km[r2*nn+r2]; }",
            "          /* accept only if primal feasible AND dual-sign feasible",
            "             (a wrong active-set face is stationary but suboptimal) */",
            "          double viol=0; double Ax2; int dual_ok=1;",
            "          for(i=0;i<M_ROWS;i++){ Ax2=0;",
            "            for(c2=0;c2<NZ;c2++) Ax2+=C_A[i*NZ+c2]*rhs2[c2];",
            "            if(Ax2-bu[i]>viol) viol=Ax2-bu[i];",
            "            if(bl[i]-Ax2>viol) viol=bl[i]-Ax2; }",
            "          for(c2=0;c2<na;c2++){ double nv=rhs2[NZ+c2];",
            "            if(side[c2]>0 && nv<-1e-7) dual_ok=0;",
            "            if(side[c2]<0 && nv> 1e-7) dual_ok=0; }",
            "          if(viol<1e-6 && dual_ok) for(i=0;i<NZ;i++) x[i]=rhs2[i]; } }",
            "      memcpy(s->z, x, sizeof(x)); memcpy(s->zd, zz, sizeof(zz));",
            "      memcpy(s->yd, y, sizeof(y)); }",
        ]
    else:
        lines += [
            "    /* --- Goldfarb–Idnani dual active set (exact; warm-started",
            "       from the previous duals in s->yd — mirrors ops/qp_active.py) --- */",
            "    { double x[NZ]; double lam[NZ]; int idx[NZ]; int sidev[NZ]; int cnt=0;",
            "      int r2, c2;",
            "      matvec(C_PINV, NZ, NZ, q, x);",
            "      for(i=0;i<NZ;i++) x[i]=-x[i];   /* unconstrained minimum */",
            "      /* seed the active set from the previous duals (top-NZ |y|) */",
            "      { double mag[M_ROWS];",
            "        for(i=0;i<M_ROWS;i++){ double yv=s->yd[i]; double a2=fabs(yv);",
            "          if(yv>0 && bu[i]>1e17) a2=0;",
            "          if(yv<0 && bl[i]<-1e17) a2=0;",
            "          mag[i]=(a2>1e-12)?a2:0; }",
            "        for(int sl=0; sl<NZ; sl++){ int best=-1; double mx=0;",
            "          for(i=0;i<M_ROWS;i++) if(mag[i]>mx){ mx=mag[i]; best=i; }",
            "          if(best<0) break;",
            "          idx[cnt]=best; sidev[cnt]=(s->yd[best]>0)?1:-1; lam[cnt]=0; cnt++;",
            "          mag[best]=0; } }",
            "      /* warm phase: price the set, drop wrong-sign multipliers */",
            "      for(int wit=0; wit<NZ+2 && cnt>0; wit++){",
            "        static double Km[(2*NZ)*(2*NZ)]; static double rv[2*NZ];",
            "        int nn=NZ+cnt;",
            "        for(r2=0;r2<NZ;r2++){ for(c2=0;c2<NZ;c2++) Km[r2*nn+c2]=C_HS[r2*NZ+c2];",
            "          for(c2=0;c2<cnt;c2++) Km[r2*nn+NZ+c2]=C_A[idx[c2]*NZ+r2];",
            "          rv[r2]=-q[r2]; }",
            "        for(r2=0;r2<cnt;r2++){ for(c2=0;c2<NZ;c2++) Km[(NZ+r2)*nn+c2]=C_A[idx[r2]*NZ+c2];",
            "          for(c2=0;c2<cnt;c2++) Km[(NZ+r2)*nn+NZ+c2]=0.0;",
            "          rv[NZ+r2]=(sidev[r2]>0)? bu[idx[r2]] : bl[idx[r2]]; }",
            "        if(!ge_solve(Km, rv, nn)){ cnt=0; break; }  /* dependent set → cold */",
            "        int kmin=-1; double lmin=-1e-9;",
            "        for(c2=0;c2<cnt;c2++){ double lj=sidev[c2]*rv[NZ+c2];",
            "          if(lj<lmin){ lmin=lj; kmin=c2; } }",
            "        if(kmin>=0){ cnt--; idx[kmin]=idx[cnt]; sidev[kmin]=sidev[cnt]; continue; }",
            "        for(i=0;i<NZ;i++) x[i]=rv[i];",
            "        for(c2=0;c2<cnt;c2++){ double lj=sidev[c2]*rv[NZ+c2]; lam[c2]=(lj>0)?lj:0; }",
            "        break; }",
            "      /* main GI pivoting */",
            "      for(int piv=0; piv<GI_MAXPIV; piv++){",
            "        /* select the most violated row/side */",
            "        double Axr[M_ROWS];",
            "        matvec(C_A, M_ROWS, NZ, x, Axr);",
            "        int p=-1, sp=0; double worst=GI_TOL;",
            "        for(i=0;i<M_ROWS;i++){",
            "          if(bl[i]>-1e17 && bl[i]-Axr[i]>worst){ worst=bl[i]-Axr[i]; p=i; sp=-1; }",
            "          if(bu[i]< 1e17 && Axr[i]-bu[i]>worst){ worst=Axr[i]-bu[i]; p=i; sp=+1; } }",
            "        if(p<0) break;  /* optimal */",
            "        double lamp=0;",
            "        for(int inner=0; inner<2*NZ+4; inner++){",
            "          static double Ms[NZ*NZ]; static double rr[NZ];",
            "          for(r2=0;r2<cnt;r2++){ for(c2=0;c2<cnt;c2++)",
            "              Ms[r2*cnt+c2]=sidev[r2]*sidev[c2]*C_GIG[idx[r2]*M_ROWS+idx[c2]];",
            "            rr[r2]=sidev[r2]*sp*C_GIG[idx[r2]*M_ROWS+p]; }",
            "          if(cnt && !ge_solve(Ms, rr, cnt)){ p=-1; break; }",
            "          double z2[NZ];",
            "          for(i=0;i<NZ;i++){ double s2=-sp*C_HIAT[i*M_ROWS+p];",
            "            for(c2=0;c2<cnt;c2++) s2+=C_HIAT[i*M_ROWS+idx[c2]]*rr[c2]*sidev[c2];",
            "            z2[i]=s2; }",
            "          double nuz=0, apx=0;",
            "          for(i=0;i<NZ;i++){ nuz+=C_A[p*NZ+i]*z2[i]; apx+=C_A[p*NZ+i]*x[i]; }",
            "          nuz*=-sp;",
            "          double bndp=(sp>0)? bu[p] : bl[p];",
            "          double slack=sp*(apx-bndp);",
            "          double t2v=(nuz>GI_TOL)? slack/nuz : 1e300;",
            "          double t1v=1e300; int kd=-1;",
            "          for(c2=0;c2<cnt;c2++) if(rr[c2]>GI_TOL){",
            "            double rt=lam[c2]/rr[c2]; if(rt<t1v){ t1v=rt; kd=c2; } }",
            "          double t=(t1v<t2v)?t1v:t2v;",
            "          if(t>=1e300){ p=-1; break; }  /* infeasible direction */",
            "          for(i=0;i<NZ;i++) x[i]+=t*z2[i];",
            "          for(c2=0;c2<cnt;c2++){ lam[c2]-=t*rr[c2]; if(lam[c2]<0) lam[c2]=0; }",
            "          lamp+=t;",
            "          if(t2v<=t1v){ if(cnt<NZ){ idx[cnt]=p; sidev[cnt]=sp; lam[cnt]=lamp; cnt++; }",
            "            break; }",
            "          else { cnt--; idx[kd]=idx[cnt]; sidev[kd]=sidev[cnt]; lam[kd]=lam[cnt]; } }",
            "        if(p<0) break; }",
            "      memcpy(s->z, x, sizeof(x));",
            "      memset(s->yd, 0, sizeof(s->yd));",
            "      for(c2=0;c2<cnt;c2++) s->yd[idx[c2]]=sidev[c2]*lam[c2]; }",
        ]
    lines += [
        "    /* --- receding input: clamp to the eps-RELAXED soft box",
        "           (linmpc.py getinput parity; hard box when N_EPS==0) --- */",
        "    { double epsf = N_EPS ? C_DSC[NZ-1]*s->z[NZ-1] : 0.0;",
        "      if(epsf < 0.0) epsf = 0.0;",
        "      for(i=0;i<NU;i++){",
        "        double u0=C_DSC[i]*s->z[i]+s->lastu0[i];",
        "        double lo=C_U0MIN[i]-C_CUMINU[i]*epsf;",
        "        double hi=C_U0MAX[i]+C_CUMAXU[i]*epsf;",
        "        if(u0<lo) u0=lo;",
        "        if(u0>hi) u0=hi;",
        "        u_out[i]=u0+C_UOP1[i];",
        "        s->lastu0[i]=u0; } }",
        "    /* --- SKF prediction --- */",
        "    { double xn[NX];",
        "      matvec(C_AH, NX, NX, s->xhat, xn);",
        "      matvec_add(C_BUH, NX, NU, s->lastu0, xn);",
        "      if(ND>0) matvec_add(C_BDH, NX, ND, d0, xn);",
        "      for(i=0;i<NX;i++) s->xhat[i]=xn[i]+C_FOPX[i]; }",
        "}",
    ]
    return "\n".join(lines)


def compile_and_load(c_source, name="mpc", workdir=None):
    """Compile generated C with the system compiler (``gcc -O2 -std=c99
    -shared -fPIC … -lm``) into ``workdir`` (default: a fresh temporary
    directory); return a ctypes CDLL."""
    workdir = workdir or tempfile.mkdtemp(prefix="mpc_cgen_")
    src = os.path.join(workdir, f"{name}.c")
    so = os.path.join(workdir, f"lib{name}.so")
    with open(src, "w") as f:
        f.write(c_source)
    subprocess.run(["gcc", "-O2", "-std=c99", "-shared", "-fPIC", src,
                    "-o", so, "-lm"], check=True)
    return ctypes.CDLL(so)
