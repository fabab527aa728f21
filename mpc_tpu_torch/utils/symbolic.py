"""Symbolic ODE -> NonLinModel bridge (counterpart of
``mpc_tpu/utils/symbolic.py``; the reference's ModelingToolkit manual,
docs/src/manual/mtk.md).

Write the plant as symbolic first-order ODEs and output expressions;
:func:`nonlinmodel_from_sympy` lambdifies them into torch functions on ONE
sample, so the model runs under ``torch.func.vmap``, ``jacfwd`` and
``jacrev`` like a hand-written one.  A component that lambdifies to a plain
number (an output that is a constant, an ODE ``dx = 0``) becomes a tensor
of the state's dtype, device and batch shape.

Mirrored semantics of the reference bridge:

* the output map must be strictly proper: an input symbol in an output
  expression raises (mtk.md "NonLinModel only support strictly proper
  systems");
* algebraic (non-ODE) state equations raise (mtk.md "Systems with algebraic
  equations are not supported");
* the parameters become the model's ``p`` vector, with the symbol order
  reported back (mtk.md ``p_sym``).

SymPy is imported when the function is called.
"""
from __future__ import annotations

import numpy as np
import torch


def nonlinmodel_from_sympy(odes, outputs, Ts, *, inputs, disturbances=(),
                           params=None, solver="rk4", device=None):
    """Build a :class:`~mpc_tpu_torch.models.NonLinModel` from symbolic ODEs.

    ``odes`` is ``{state_symbol: dx/dt expression}`` (the state order
    follows the dict), ``outputs`` the output expressions ``y = h(x, d)``,
    ``inputs``/``disturbances`` the symbols of u and d in vector order,
    ``params`` ``{symbol: value}`` for every other free symbol (the model's
    ``p``), ``solver`` as for ``NonLinModel`` (``None``: already discrete)
    and ``device`` the model's (the GPU unless the caller asks for
    another).  Returns ``(model, info)`` with ``info`` the symbol orders
    ``x_syms``, ``u_syms``, ``d_syms``, ``p_syms``.
    """
    import sympy as sp

    from ..models import NonLinModel

    x_syms = list(odes.keys())
    f_exprs = [sp.sympify(e) for e in odes.values()]
    h_exprs = [sp.sympify(e) for e in outputs]
    u_syms = list(inputs)
    d_syms = list(disturbances)
    params = dict(params or {})
    p_syms = list(params.keys())
    p0 = np.asarray([float(params[s]) for s in p_syms], float)

    for s in x_syms:
        if not isinstance(s, sp.Symbol):
            raise TypeError(
                f"state {s!r} is not a plain sympy Symbol; higher-order or "
                "algebraic equations are not supported — rewrite as "
                "first-order ODEs (reference: mtk.md rejects algebraic "
                "equations)")

    known = set(x_syms) | set(u_syms) | set(d_syms) | set(p_syms)
    free = set().union(*(e.free_symbols for e in f_exprs + h_exprs)) if \
        (f_exprs or h_exprs) else set()
    missing = free - known
    if missing:
        raise ValueError(
            f"free symbols {sorted(missing, key=str)} are neither states, "
            "inputs, disturbances nor params — give them values via "
            "params={...}")
    improper = set(u_syms) & set().union(*(e.free_symbols for e in h_exprs)) \
        if h_exprs else set()
    if improper:
        raise ValueError(
            f"output expressions reference input(s) {sorted(improper, key=str)}:"
            " only strictly proper systems are supported (reference mtk.md)")

    argsyms = (*x_syms, *u_syms, *d_syms, *p_syms)
    # SymPy's torch printer: sin/cos/exp/... resolve to torch functions
    f_fun = sp.lambdify(argsyms, f_exprs, modules="torch")
    h_fun = sp.lambdify(argsyms, h_exprs, modules="torch")

    nx, nu, nd, ny = len(x_syms), len(u_syms), len(d_syms), len(h_exprs)

    def unpack(x, u, d, p):
        # the parameters as a tensor of the state's dtype and device: the
        # torch functions SymPy prints (torch.pow, ...) take no NumPy scalars
        p = torch.as_tensor(p, dtype=x.dtype, device=x.device) if len(p_syms) else p
        return (*(x[i] for i in range(nx)), *(u[i] for i in range(nu)),
                *(d[i] for i in range(nd)), *(p[i] for i in range(len(p_syms))))

    def stack(values, x):
        # a component that came out a number takes the state's dtype, device
        # and (under vmap) batch shape; a tensor of another dtype (a float64
        # disturbance with a float32 state) takes the state's dtype
        like = x[0]
        return torch.stack([v.to(like.dtype) if torch.is_tensor(v)
                            else torch.full_like(like, float(v)) for v in values])

    def f(x, u, d, p):
        return stack(f_fun(*unpack(x, u, d, p)), x)

    def h(x, d, p):
        u = x.new_zeros(nu)
        return stack(h_fun(*unpack(x, u, d, p)), x)

    model = NonLinModel(f, h, Ts, nu, nx, ny, nd=nd, p=p0, solver=solver,
                        device=device)
    info = dict(x_syms=x_syms, u_syms=u_syms, d_syms=d_syms, p_syms=p_syms)
    return model, info
