"""Batched bound-constrained L-BFGS-B in PyTorch.

Counterpart of ``repro/core/lbfgsb.py``: every restart carries its own
limited-memory state stacked along a leading batch axis ``(B, m, D)``, all
restarts advance in lockstep, and the function evaluations of all active
restarts happen in one batched call.  Each restart's two-loop recursion
reads only its own history slice, so the implied inverse Hessian is
block-diagonal by construction: the D-BE property.

JAX's ``lax.while_loop`` becomes a Python loop over device tensors: ONE
flattened loop for the whole batch (never one loop per row), whose
condition is the only host sync per iteration and per line-search round.

Algorithm: projected quasi-Newton (gradient projection for the bound
active set + L-BFGS two-loop direction on the free variables + projected
backtracking Armijo line search).  Convergence criteria mirror scipy's
L-BFGS-B (``pgtol`` on the projected gradient's infinity norm, ``ftol``
relative decrease, ``maxiter``).
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Callable, NamedTuple, Tuple

import torch

Tensor = torch.Tensor

# Status codes (per restart).
RUNNING = 0
CONV_PGTOL = 1
CONV_FTOL = 2
CONV_MAXITER = 3
CONV_LS_FAIL = 4


class LbfgsbOptions(NamedTuple):
    m: int = 10
    maxiter: int = 200
    pgtol: float = 1e-5
    ftol: float = 1e-12          # relative f decrease; 0 disables
    maxls: int = 25
    armijo_c1: float = 1e-4
    ls_shrink: float = 0.5
    bound_eps: float = 1e-10     # active-set detection slack
    curv_eps: float = 1e-10      # curvature-pair acceptance threshold


@dataclass
class LbfgsbState:
    """Stacked per-restart solver state. All tensors lead with B."""
    x: Tensor            # (B, D) current iterate (always inside [l, u])
    f: Tensor            # (B,)
    g: Tensor            # (B, D)
    s_hist: Tensor       # (B, m, D) displacement history (circular)
    y_hist: Tensor       # (B, m, D) gradient-difference history (circular)
    rho: Tensor          # (B, m)   1 / s.y per slot
    start: Tensor        # (B,) int32 circular-buffer head (oldest slot)
    length: Tensor       # (B,) int32 number of valid slots
    gamma: Tensor        # (B,)  H0 = gamma * I scaling
    k: Tensor            # (B,) int32 iteration count
    status: Tensor       # (B,) int32 RUNNING / CONV_*
    n_evals: Tensor      # (B,) int32 per-restart *active* objective evals
    rounds: int          # number of batched evaluation rounds


@dataclass
class LbfgsbResult:
    x: Tensor            # (*batch, D)
    f: Tensor            # (*batch,)
    g: Tensor            # (*batch, D)
    k: Tensor            # (*batch,) iterations taken
    status: Tensor       # (*batch,)
    n_evals: Tensor      # (*batch,)
    rounds: int          # total batched rounds (line-search rounds incl.)
    state: LbfgsbState   # final full (flattened) state


def _proj(x: Tensor, lower: Tensor, upper: Tensor) -> Tensor:
    return torch.minimum(torch.maximum(x, lower), upper)


def projected_grad(x: Tensor, g: Tensor, lower: Tensor,
                   upper: Tensor) -> Tensor:
    """scipy-style projected gradient: x - P(x - g)."""
    return x - _proj(x - g, lower, upper)


def _active_mask(x, g, lower, upper, eps):
    """Coordinates pinned at a bound with the gradient pushing outward."""
    at_lo = (x <= lower + eps) & (g > 0)
    at_hi = (x >= upper - eps) & (g < 0)
    return at_lo | at_hi


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return (a * b).sum(-1)


def _ordered_history(state: LbfgsbState, m: int):
    """Gather history slots in chronological order (j=0 oldest)."""
    j = torch.arange(m, dtype=torch.int64, device=state.x.device)
    order = (state.start.long()[:, None] + j[None, :]) % m         # (B, m)
    D = state.x.shape[1]
    idx = order[:, :, None].expand(-1, -1, D)
    s_ord = torch.gather(state.s_hist, 1, idx)
    y_ord = torch.gather(state.y_hist, 1, idx)
    rho_ord = torch.gather(state.rho, 1, order)
    valid = j[None, :] < state.length.long()[:, None]              # (B, m)
    return s_ord, y_ord, rho_ord, valid


def two_loop_direction(g: Tensor, s_ord: Tensor, y_ord: Tensor,
                       rho_ord: Tensor, valid: Tensor,
                       gamma: Tensor) -> Tensor:
    """Batched L-BFGS two-loop recursion: returns H·g (NOT negated).

    History is chronological (slot 0 oldest); invalid slots are masked to
    no-ops, so restarts with different history lengths share one call.
    """
    m = s_ord.shape[1]
    q = g
    alphas = []
    for jj in range(m - 1, -1, -1):     # newest -> oldest
        a = rho_ord[:, jj] * _dot(s_ord[:, jj], q)
        a = torch.where(valid[:, jj], a, 0.0)
        q = q - a[:, None] * y_ord[:, jj]
        alphas.append(a)
    alphas = alphas[::-1]               # index by chronological jj
    r = gamma[:, None] * q
    for jj in range(m):                 # oldest -> newest
        b = rho_ord[:, jj] * _dot(y_ord[:, jj], r)
        b = torch.where(valid[:, jj], b, 0.0)
        r = r + (alphas[jj] - b)[:, None] * s_ord[:, jj]
    return r


def inv_hessian_dense(state: LbfgsbState, m: int) -> Tensor:
    """The inverse Hessian H (B, D, D) that each row's history implies.

    For the off-diagonal-artifact experiments: the two-loop recursion
    applied to the D identity columns (all B·D of them in one batched
    call) gives the dense matrix it represents, H e_j in column j.
    """
    B, D = state.x.shape
    s_ord, y_ord, rho_ord, valid = _ordered_history(state, m)
    eye = torch.eye(D, dtype=state.x.dtype, device=state.x.device)

    def rows(t: Tensor) -> Tensor:              # (B, ...) → (B·D, ...)
        return t.repeat_interleave(D, dim=0)
    cols = two_loop_direction(eye.repeat(B, 1), rows(s_ord), rows(y_ord),
                              rows(rho_ord), rows(valid),
                              rows(state.gamma))
    return cols.reshape(B, D, D).transpose(1, 2)


def _init_state(fun_batched, x0, lower, upper,
                opts: LbfgsbOptions) -> LbfgsbState:
    B, D = x0.shape
    x0 = _proj(x0, lower, upper)
    f0, g0 = fun_batched(x0)
    dt, dev = x0.dtype, x0.device
    zeros_hist = torch.zeros((B, opts.m, D), dtype=dt, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return LbfgsbState(
        x=x0, f=f0, g=g0,
        s_hist=zeros_hist, y_hist=zeros_hist.clone(),
        rho=torch.zeros((B, opts.m), dtype=dt, device=dev),
        start=torch.zeros((B,), **i32),
        length=torch.zeros((B,), **i32),
        gamma=torch.ones((B,), dtype=dt, device=dev),
        k=torch.zeros((B,), **i32),
        status=torch.full((B,), RUNNING, **i32),
        n_evals=torch.ones((B,), **i32),
        rounds=1,
    )


def _check_initial_convergence(state: LbfgsbState, lower, upper,
                               opts: LbfgsbOptions) -> None:
    pg = projected_grad(state.x, state.g, lower, upper)
    done = pg.abs().amax(-1) <= opts.pgtol
    state.status = torch.where(done, CONV_PGTOL, state.status).to(
        torch.int32)


def _line_search(fun_batched, state: LbfgsbState, d: Tensor, t0: Tensor,
                 running: Tensor, lower, upper, opts: LbfgsbOptions):
    """Projected backtracking Armijo search, all rows in batched rounds.

    Frozen/accepted rows re-evaluate their accepted point (lockstep);
    their result is discarded by the masks.
    """
    B = state.x.shape[0]
    t = t0
    accepted = ~running
    x_new, f_new, g_new = state.x, state.f, state.g
    tries = torch.zeros((B,), dtype=torch.int32, device=state.x.device)
    n_evals = torch.zeros_like(tries)
    rounds = 0
    while bool((running & ~accepted & (tries < opts.maxls)).any()):
        x_trial = _proj(state.x + t[:, None] * d, lower, upper)
        f_t, g_t = fun_batched(x_trial)
        step_vec = x_trial - state.x
        gs = _dot(state.g, step_vec)
        armijo = f_t <= state.f + opts.armijo_c1 * gs
        # accept also if projection collapsed the step to ~zero (stuck)
        stuck = step_vec.abs().amax(-1) <= 1e-30
        newly = running & ~accepted & (armijo | stuck)
        take = newly[:, None]
        evals = (running & ~accepted).to(torch.int32)
        t = torch.where(newly | accepted, t, t * opts.ls_shrink)
        accepted = accepted | newly | stuck
        x_new = torch.where(take, x_trial, x_new)
        f_new = torch.where(newly, f_t, f_new)
        g_new = torch.where(take, g_t, g_new)
        tries = tries + evals
        n_evals = n_evals + evals
        rounds += 1
    return accepted, x_new, f_new, g_new, n_evals, rounds


def _step(fun_batched, lower, upper, opts: LbfgsbOptions,
          state: LbfgsbState) -> LbfgsbState:
    B, D = state.x.shape
    dt = state.x.dtype
    running = state.status == RUNNING                            # (B,)

    # ---- search direction -------------------------------------------------
    act = _active_mask(state.x, state.g, lower, upper, opts.bound_eps)
    gm = torch.where(act, 0.0, state.g)
    s_ord, y_ord, rho_ord, valid = _ordered_history(state, opts.m)
    d = -two_loop_direction(gm, s_ord, y_ord, rho_ord, valid, state.gamma)
    d = torch.where(act, 0.0, d)
    # descent check; fall back to projected steepest descent
    dg = _dot(d, gm)
    gnorm2 = _dot(gm, gm)
    bad = dg > -1e-12 * torch.clamp(gnorm2, min=1e-30)
    d = torch.where(bad[:, None], -gm, d)

    # initial trial step: unit for QN steps, conservative on cold start
    dinf = d.abs().amax(-1)
    t0 = torch.where(state.length == 0,
                     torch.clamp(1.0 / torch.clamp(dinf, min=1e-30),
                                 max=1.0),
                     torch.ones((B,), dtype=dt, device=state.x.device))

    accepted, x_ls, f_ls, g_ls, ls_evals, ls_rounds = _line_search(
        fun_batched, state, d, t0, running, lower, upper, opts)

    ls_failed = running & ~accepted
    # on failure keep the old iterate
    x_new = torch.where(ls_failed[:, None], state.x, x_ls)
    f_new = torch.where(ls_failed, state.f, f_ls)
    g_new = torch.where(ls_failed[:, None], state.g, g_ls)

    # ---- curvature-pair update (masked, circular buffer) ------------------
    s_vec = x_new - state.x
    y_vec = g_new - state.g
    sy = _dot(s_vec, y_vec)
    yy = _dot(y_vec, y_vec)
    ss = _dot(s_vec, s_vec)
    curv_ok = sy > opts.curv_eps * torch.sqrt(
        torch.clamp(ss, min=1e-300) * torch.clamp(yy, min=1e-300))
    do_push = running & ~ls_failed & curv_ok

    full = state.length == opts.m
    slot = (state.start + state.length % opts.m) % opts.m        # write pos
    onehot = torch.nn.functional.one_hot(slot.long(), opts.m).to(dt) * \
        do_push.to(dt)[:, None]                                  # (B, m)
    s_hist = state.s_hist * (1 - onehot)[:, :, None] + \
        onehot[:, :, None] * s_vec[:, None, :]
    y_hist = state.y_hist * (1 - onehot)[:, :, None] + \
        onehot[:, :, None] * y_vec[:, None, :]
    rho_new = torch.where(do_push, 1.0 / torch.where(do_push, sy, 1.0), 0.0)
    rho = state.rho * (1 - onehot) + onehot * rho_new[:, None]
    start = torch.where(do_push & full, (state.start + 1) % opts.m,
                        state.start)
    length = torch.where(do_push, torch.clamp(state.length + 1, max=opts.m),
                         state.length)
    gamma = torch.where(do_push, sy / torch.clamp(yy, min=1e-300),
                        state.gamma)

    # ---- convergence tests -------------------------------------------------
    pg = projected_grad(x_new, g_new, lower, upper)
    conv_pg = pg.abs().amax(-1) <= opts.pgtol
    denom = torch.clamp(torch.maximum(state.f.abs(), f_new.abs()), min=1.0)
    conv_f = (state.f - f_new) <= opts.ftol * denom
    if not opts.ftol > 0:
        conv_f = torch.zeros_like(conv_f)
    k_new = state.k + running.to(torch.int32)
    conv_it = k_new >= opts.maxiter

    status = state.status
    status = torch.where(running & conv_pg, CONV_PGTOL, status)
    status = torch.where(running & ~conv_pg & conv_f, CONV_FTOL, status)
    status = torch.where(running & (status == RUNNING) & ls_failed,
                         CONV_LS_FAIL, status)
    status = torch.where(running & (status == RUNNING) & conv_it,
                         CONV_MAXITER, status)

    keep = running[:, None]
    return LbfgsbState(
        x=torch.where(keep, x_new, state.x),
        f=torch.where(running, f_new, state.f),
        g=torch.where(keep, g_new, state.g),
        s_hist=s_hist, y_hist=y_hist, rho=rho,
        start=start.to(torch.int32), length=length.to(torch.int32),
        gamma=gamma, k=k_new, status=status.to(torch.int32),
        n_evals=state.n_evals + ls_evals,
        rounds=state.rounds + ls_rounds,
    )


def _minimize_2d(fun_batched, x0, lower, upper,
                 options: LbfgsbOptions) -> LbfgsbResult:
    """The core (B, D) lockstep solve (see :func:`lbfgsb_minimize`)."""
    state = _init_state(fun_batched, x0, lower, upper, options)
    _check_initial_convergence(state, lower, upper, options)
    while bool((state.status == RUNNING).any()):
        state = _step(fun_batched, lower, upper, options, state)
    return LbfgsbResult(x=state.x, f=state.f, g=state.g, k=state.k,
                        status=state.status, n_evals=state.n_evals,
                        rounds=state.rounds, state=state)


def lbfgsb_minimize(
    fun_batched: Callable[[Tensor], Tuple[Tensor, Tensor]],
    x0: Tensor,
    lower,
    upper,
    options: LbfgsbOptions = LbfgsbOptions(),
) -> LbfgsbResult:
    """Minimize independent D-dimensional problems in lockstep.

    ``x0`` of shape ``(*batch, D)`` runs ``prod(batch)`` problems through
    ONE loop: they share their QN iterations and line-search rounds.
    Every result tensor leads with ``batch`` again; ``rounds`` is a
    scalar (rounds are shared by construction).

    Args:
      fun_batched: maps ``(*batch, D)`` → ``(batch values, (*batch, D)
        grads)``.  One call == one batched evaluation round.
      x0: ``(*batch, D)`` initial points.
      lower/upper: broadcastable to ``x0.shape`` box bounds (±inf ok).
    """
    if x0.ndim < 2:
        raise ValueError(f"x0 must be (*batch, D), got {tuple(x0.shape)}")
    lower = torch.as_tensor(lower, dtype=x0.dtype,
                            device=x0.device).expand(x0.shape)
    upper = torch.as_tensor(upper, dtype=x0.dtype,
                            device=x0.device).expand(x0.shape)
    if x0.ndim == 2:
        return _minimize_2d(fun_batched, x0, lower, upper, options)

    batch_shape, D = tuple(x0.shape[:-1]), x0.shape[-1]

    def fun_flat(xf):
        f, g = fun_batched(xf.reshape(batch_shape + (D,)))
        return f.reshape(-1), g.reshape(-1, D)

    res = _minimize_2d(fun_flat, x0.reshape(-1, D),
                       lower.reshape(-1, D), upper.reshape(-1, D), options)
    out = {}
    for fld in fields(res):
        v = getattr(res, fld.name)
        if isinstance(v, Tensor):
            v = v.reshape(batch_shape + tuple(v.shape[1:]))
        out[fld.name] = v
    return LbfgsbResult(**out)


# The reference jit-compiles the whole solve; a CUDA-graph entry is later
# speed work (ROADMAP), so here the jit entry is the plain solve.
lbfgsb_minimize_jit = lbfgsb_minimize


# ---------------------------------------------------------------------------
# dense BFGS (for the unbounded off-diagonal-artifact appendix experiments)
# ---------------------------------------------------------------------------

class BfgsState(NamedTuple):
    x: Tensor
    f: Tensor
    g: Tensor
    hinv: Tensor         # (B, D, D)
    k: Tensor
    status: Tensor


def bfgs_minimize(fun_batched, x0: Tensor, *, maxiter: int = 200,
                  gtol: float = 1e-8, maxls: int = 25,
                  armijo_c1: float = 1e-4, shrink: float = 0.5
                  ) -> BfgsState:
    """Batched dense BFGS (no bounds), all rows in one lockstep loop.

    Keeps the full (B, D, D) inverse Hessian so the artifact experiments
    can inspect it directly.  Backtracking Armijo line search from a unit
    step; the reference's statuses (CONV_PGTOL on ‖g‖∞ ≤ gtol,
    CONV_LS_FAIL, CONV_MAXITER) and per-row iteration count ``k``.
    """
    B, D = x0.shape
    dt, dev = x0.dtype, x0.device
    f0, g0 = fun_batched(x0)
    i32 = dict(dtype=torch.int32, device=dev)
    eye = torch.eye(D, dtype=dt, device=dev)
    st = BfgsState(x=x0, f=f0, g=g0, hinv=eye.expand(B, D, D).clone(),
                   k=torch.zeros((B,), **i32),
                   status=torch.where(g0.abs().amax(-1) <= gtol,
                                      CONV_PGTOL, RUNNING).to(torch.int32))
    while bool((st.status == RUNNING).any()):
        running = st.status == RUNNING
        d = -(st.hinv @ st.g[..., None])[..., 0]
        bad = _dot(d, st.g) >= 0
        d = torch.where(bad[:, None], -st.g, d)

        t = torch.ones((B,), dtype=dt, device=dev)
        acc = ~running
        x_new, f_new, g_new = st.x, st.f, st.g
        tries = torch.zeros((B,), **i32)
        while bool((running & ~acc & (tries < maxls)).any()):
            xt = st.x + t[:, None] * d
            ft, gt = fun_batched(xt)
            ok = ft <= st.f + armijo_c1 * _dot(st.g, xt - st.x)
            newly = running & ~acc & ok
            take = newly[:, None]
            tries = tries + (running & ~acc).to(torch.int32)
            t = torch.where(newly | acc, t, t * shrink)
            acc = acc | newly
            x_new = torch.where(take, xt, x_new)
            f_new = torch.where(newly, ft, f_new)
            g_new = torch.where(take, gt, g_new)
        fail = running & ~acc
        x_new = torch.where(fail[:, None], st.x, x_new)
        f_new = torch.where(fail, st.f, f_new)
        g_new = torch.where(fail[:, None], st.g, g_new)

        sv = x_new - st.x
        yv = g_new - st.g
        sy = _dot(sv, yv)
        upd = running & ~fail & (sy > 1e-12)
        rho = 1.0 / torch.where(upd, sy, 1.0)
        V = eye - rho[:, None, None] * (sv[:, :, None] * yv[:, None, :])
        h_upd = V @ st.hinv @ V.transpose(1, 2) + \
            rho[:, None, None] * (sv[:, :, None] * sv[:, None, :])
        hinv = torch.where(upd[:, None, None], h_upd, st.hinv)

        conv = g_new.abs().amax(-1) <= gtol
        k_new = st.k + running.to(torch.int32)
        status = st.status
        status = torch.where(running & conv, CONV_PGTOL, status)
        status = torch.where(running & (status == RUNNING) & fail,
                             CONV_LS_FAIL, status)
        status = torch.where(running & (status == RUNNING)
                             & (k_new >= maxiter), CONV_MAXITER, status)
        keep = running[:, None]
        st = BfgsState(x=torch.where(keep, x_new, st.x),
                       f=torch.where(running, f_new, st.f),
                       g=torch.where(keep, g_new, st.g), hinv=hinv,
                       k=k_new, status=status.to(torch.int32))
    return st


def make_batched_value_and_grad(f_single: Callable[[Tensor], Tensor]):
    """Lift a single-point objective x:(D,) → () to the batched interface
    ``(B, D) → ((B,), (B, D))``: the values of all rows in one
    ``torch.func.vmap`` call, the gradients by one backward of their sum
    (the rows are independent, so row r's gradient is d(Σf)/dx_r)."""
    f_rows = torch.func.vmap(f_single)

    def fun_batched(xb: Tensor) -> Tuple[Tensor, Tensor]:
        with torch.enable_grad():
            xb = xb.detach().requires_grad_(True)
            f = f_rows(xb)
            (g,) = torch.autograd.grad(f.sum(), xb)
        return f.detach(), g
    return fun_batched
