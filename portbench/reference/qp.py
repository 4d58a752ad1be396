"""Plain reference solver: OSQP-style ADMM over a batch of dense QPs.

``min ½xᵀHx + gᵀx  s.t.  l ≤ Ax ≤ u`` for every row of ``g``, ``l``,
``u``, with ``H`` and ``A`` shared by the rows and ``l < u``. Written in
plain PyTorch from the textbook iteration (Stellato et al., "OSQP: an
operator splitting solver for quadratic programs", 2020, Algorithm 1),
with one step size ρ per row adapted from the ratio of the residuals, and
nothing of the program under test. The x-update's system ``H + σI +
ρAᵀA`` is diagonalised once (``operator``), so every row's ρ is a scale
between two shared products. The reference runs it in float64 to a
tolerance far below the program's; the control (``portbench.control``)
runs the same code in the program's place at the program's tolerance with
every product in TF32 (``mm``).
"""
from __future__ import annotations

import torch

SIGMA = 1e-6
ALPHA = 1.6
ADAPT_EVERY = 50
POLISH_BLOCK = 32


def _inf_norm(v):
    return v.abs().amax(dim=1)


def residuals(H, g, A, l, u, x, z, y, mm=torch.matmul):
    """``(pri, dua)``: ‖Ax − z‖∞ and ‖Hx + g + Aᵀy‖∞ per row."""
    return (_inf_norm(mm(x, A.T) - z),
            _inf_norm(mm(x, H.T) + g + mm(y, A)))


def operator(H, A):
    """``(P, lam)`` with ``(H + σI + ρAᵀA)⁻¹ = P diag(1 / (1 + ρ lam))
    Pᵀ`` for every ρ: ``H + σI = LLᵀ``, ``L⁻¹AᵀAL⁻ᵀ = Q diag(lam) Qᵀ``,
    ``P = L⁻ᵀQ``; in ``H``'s dtype."""
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    L = torch.linalg.cholesky(H + SIGMA * eye)
    Li = torch.linalg.solve_triangular(L, eye, upper=False)
    C = Li @ (A.T @ A) @ Li.T
    lam, Q = torch.linalg.eigh(0.5 * (C + C.T))
    return Li.T @ Q, torch.clamp(lam, min=0.0)


def solve(H, g, A, l, u, *, eps: float, max_iter: int, rho: float = 0.1,
          check_every: int = 25, mm=torch.matmul, op=None):
    """ADMM from zero until every row's residuals are below ``eps`` or
    ``max_iter`` iterations have run; a row leaves the iteration at its
    first certified check. Returns ``(x, z, y, pri, dua, iters)``;
    ``iters`` is each row's count at that check (``max_iter`` where none
    certified). All tensors share ``g``'s dtype and device; ``mm``
    computes every product (the diagonalisation aside); ``op`` is
    ``operator(H, A)`` where the caller keeps it."""
    R, n = g.shape
    m = l.shape[1]
    dt, dev = g.dtype, g.device
    P, lam = operator(H, A) if op is None else op
    x_out = torch.zeros((R, n), dtype=dt, device=dev)
    z_out = torch.zeros((R, m), dtype=dt, device=dev)
    y_out = torch.zeros((R, m), dtype=dt, device=dev)
    iters = torch.full((R,), max_iter, dtype=torch.int64, device=dev)
    live = torch.arange(R, device=dev)
    gl, ll, ul = g, l, u
    x, z, y = x_out.clone(), z_out.clone(), y_out.clone()
    rho_row = torch.full((R, 1), float(rho), dtype=dt, device=dev)
    for k in range(1, max_iter + 1):
        d = 1.0 / (1.0 + rho_row * lam)
        rhs = SIGMA * x - gl + mm(rho_row * z - y, A)
        xt = mm(mm(rhs, P) * d, P.T)
        zt = mm(xt, A.T)
        x = ALPHA * xt + (1.0 - ALPHA) * x
        zr = ALPHA * zt + (1.0 - ALPHA) * z
        z_new = torch.minimum(torch.maximum(zr + y / rho_row, ll), ul)
        y = y + rho_row * (zr - z_new)
        z = z_new
        if k % check_every and k != max_iter:
            continue
        pri, dua = residuals(H, gl, A, ll, ul, x, z, y, mm)
        done = ((pri < eps) & (dua < eps)) | (k == max_iter)
        if bool(done.any()):
            rows = live[done]
            x_out[rows], z_out[rows], y_out[rows] = x[done], z[done], y[done]
            iters[rows] = k
            keep = ~done
            live, gl, ll, ul = live[keep], gl[keep], ll[keep], ul[keep]
            x, z, y, rho_row = x[keep], z[keep], y[keep], rho_row[keep]
            pri, dua = pri[keep], dua[keep]
            if not len(live):
                break
        if k % ADAPT_EVERY == 0:
            Ax, Hx, Aty = mm(x, A.T), mm(x, H.T), mm(y, A)
            tiny = torch.finfo(dt).tiny
            p_rel = pri / torch.clamp(torch.maximum(_inf_norm(Ax),
                                                    _inf_norm(z)), min=tiny)
            d_rel = dua / torch.clamp(torch.maximum(
                torch.maximum(_inf_norm(Hx), _inf_norm(Aty)),
                _inf_norm(gl)), min=tiny)
            ratio = torch.sqrt(p_rel / torch.clamp(d_rel, min=tiny))
            new = torch.clamp(rho_row[:, 0] * ratio, 1e-6, 1e6)
            move = (new > 5 * rho_row[:, 0]) | (new < 0.2 * rho_row[:, 0])
            rho_row = torch.where(move[:, None], new[:, None], rho_row)
    pri, dua = residuals(H, g, A, l, u, x_out, z_out, y_out, mm)
    return x_out, z_out, y_out, pri, dua, iters


def _polish_block(H, g, A, l, u, x, z, y, tol):
    R, n = g.shape
    m = l.shape[1]
    dt, dev = g.dtype, g.device
    low = (z - l) < -y
    upp = (u - z) < y
    act = low | upp
    K = torch.zeros((R, n + m, n + m), dtype=dt, device=dev)
    K[:, :n, :n] = H
    K[:, :n, n:] = A.T
    K[:, n:, :n] = A * act[:, :, None]
    K[:, n:, n:] = torch.diag_embed((~act).to(dt) * -1.0)
    b = torch.where(low, l, torch.where(upp, u, torch.zeros_like(l)))
    rhs = torch.cat([-g, b], dim=1)
    sol = torch.linalg.solve(K, rhs[:, :, None])[:, :, 0]
    xp, yp = sol[:, :n], sol[:, n:]
    Ax = xp @ A.T
    zp = torch.minimum(torch.maximum(Ax, l), u)
    feas = ((Ax - zp).abs() <= tol * torch.clamp(Ax.abs(), min=1.0)).all(1)
    sign = torch.where(low & ~upp, yp <= tol,
                       torch.where(upp & ~low, yp >= -tol, yp.abs() <= tol))
    ok = feas & sign.all(1) & torch.isfinite(sol).all(1)
    keep = ok[:, None]
    return (torch.where(keep, xp, x), torch.where(keep, zp, z),
            torch.where(keep, yp, y), ok)


def polish(H, g, A, l, u, x, z, y, tol: float = 1e-9):
    """Exact solve on the active set that ADMM's ``(x, z, y)`` points to
    (OSQP's polish): the KKT system ``Hx + Aᵀy = -g``, ``A_i x = l_i`` or
    ``u_i`` on the active rows and ``y_i = 0`` on the others, solved in the
    dtype given, ``POLISH_BLOCK`` rows at a time. A row keeps its polished
    point only where that point is feasible and its multipliers have the
    right signs, within ``tol``; returns ``(x, z, y, ok)``."""
    parts = [_polish_block(H, g[s], A, l[s], u[s], x[s], z[s], y[s], tol)
             for s in (slice(i, i + POLISH_BLOCK)
                       for i in range(0, len(g), POLISH_BLOCK))]
    return tuple(torch.cat(p) for p in zip(*parts))


def solve_exact(H, g, A, l, u, *, eps_admm: float = 1e-6,
                max_iter: int = 20000):
    """The reference's answer: ADMM to ``eps_admm``, then ``polish``; rows
    whose polish was refused go on with ADMM from scratch to a tolerance a
    hundred times tighter and are polished again. Returns ``(x, z, y, pri,
    dua)`` with the final residuals."""
    x, z, y, _, _, _ = solve(H, g, A, l, u, eps=eps_admm, max_iter=max_iter)
    x, z, y, ok = polish(H, g, A, l, u, x, z, y)
    if not bool(ok.all()):
        bad = ~ok
        x2, z2, y2, _, _, _ = solve(H, g[bad], A, l[bad], u[bad],
                                    eps=eps_admm * 1e-2, max_iter=max_iter)
        x2, z2, y2, _ = polish(H, g[bad], A, l[bad], u[bad], x2, z2, y2)
        x[bad], z[bad], y[bad] = x2, z2, y2
    pri, dua = residuals(H, g, A, l, u, x, z, y)
    return x, z, y, pri, dua
