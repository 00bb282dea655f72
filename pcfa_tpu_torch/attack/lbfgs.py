"""L-BFGS with torch `optim.LBFGS` semantics (no line search), for B
independent problems at once (`pcfa_tpu/attack/lbfgs.py`).

Every state field carries a leading pair axis B, and every break latch,
history push and state update is masked per pair (`torch.where`), so one
network pass serves all pairs while each pair follows exactly its own
single-problem trajectory. One call of `lbfgs_iteration` is one uniform
iteration: evaluate loss and gradient at x, push the curvature pair,
compute the direction, maybe update x. `pos` (0..max_iter-1) is the
iteration's index within the current `.step()` segment; the `done` latch
resets at `pos == 0`.

Directions: 'two_loop' (the recursion torch runs) or 'compact'
(Byrd–Nocedal–Schnabel, with the Gram matrices SᵀY and YᵀY maintained
incrementally, one row and column per push). The history ring buffers may
be stored in bfloat16; products with them accumulate in float32. The
compact direction's two passes over the ring (the products, the final
combination) are `ops/lbfgs_hist.py`: CUDA kernels on the card, plain
versions on the CPU.

The ring buffers (the optimizer's largest tensors, B·m·n each) are updated
in place; every other field is a new tensor.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from pcfa_tpu_torch.ops import lbfgs_hist
from pcfa_tpu_torch.utils import profiling


class LBFGSState(NamedTuple):
    x: torch.Tensor              # (B, n)
    d: torch.Tensor              # (B, n) last search direction
    t: torch.Tensor              # (B,) last step size
    prev_grad: torch.Tensor      # (B, n)
    prev_loss: torch.Tensor      # (B,)
    y_buf: torch.Tensor          # (B, m, n) gradient differences
    s_buf: torch.Tensor          # (B, m, n) parameter steps
    ro_buf: torch.Tensor         # (B, m) 1/(y·s)
    h_diag: torch.Tensor         # (B,)
    count: torch.Tensor          # (B,) int64, total history pushes
    n_iter: torch.Tensor         # (B,) int64, iterations executed
    done: torch.Tensor           # (B,) bool, segment break latch
    last_step_max: torch.Tensor  # (B,) max|t·d| of the last applied update
    gram_sy: torch.Tensor        # (B, m, m) SᵀY in ring order
    gram_yy: torch.Tensor        # (B, m, m) YᵀY in ring order


def lbfgs_init(x0: torch.Tensor, history_size: int = 100,
               history_dtype: torch.dtype | str | None = None) -> LBFGSState:
    """x0: (B, n). `history_dtype` ('bfloat16' or a torch dtype) stores the
    (m, n) ring buffers in that dtype; everything else stays x0's dtype."""
    if isinstance(history_dtype, str):
        history_dtype = getattr(torch, history_dtype)
    B, n = x0.shape
    m = history_size
    kw = {"dtype": x0.dtype, "device": x0.device}
    hdt = history_dtype or x0.dtype
    return LBFGSState(
        x=x0.clone(),
        d=torch.zeros_like(x0),
        t=torch.zeros(B, **kw),
        prev_grad=torch.zeros_like(x0),
        prev_loss=torch.zeros(B, **kw),
        y_buf=torch.zeros((B, m, n), dtype=hdt, device=x0.device),
        s_buf=torch.zeros((B, m, n), dtype=hdt, device=x0.device),
        ro_buf=torch.zeros((B, m), **kw),
        h_diag=torch.ones(B, **kw),
        count=torch.zeros(B, dtype=torch.int64, device=x0.device),
        n_iter=torch.zeros(B, dtype=torch.int64, device=x0.device),
        done=torch.zeros(B, dtype=torch.bool, device=x0.device),
        last_step_max=torch.full((B,), float("inf"), **kw),
        gram_sy=torch.zeros((B, m, m), **kw),
        gram_yy=torch.zeros((B, m, m), **kw),
    )


def _two_loop(grad, y_buf, s_buf, ro_buf, h_diag, count) -> torch.Tensor:
    """Two-loop recursion over each pair's `count` valid ring entries."""
    B, m, _ = y_buf.shape
    ar = torch.arange(B, device=grad.device)
    num_valid = torch.clamp(count, max=m)
    trips = int(num_valid.max())
    q = -grad
    al = torch.zeros((B, m), dtype=grad.dtype, device=grad.device)
    for k in range(trips):  # newest first
        active = k < num_valid
        i = (count - 1 - k) % m
        a = ro_buf[ar, i] * (s_buf[ar, i].to(grad.dtype) * q).sum(1)
        a = torch.where(active, a, 0.0)
        q = q - a[:, None] * y_buf[ar, i].to(grad.dtype)
        al[ar, i] = torch.where(active, a, al[ar, i])
    d = q * h_diag[:, None]
    for k in range(trips):  # oldest first
        active = k < num_valid
        i = (count - num_valid + k) % m
        be = ro_buf[ar, i] * (y_buf[ar, i].to(grad.dtype) * d).sum(1)
        step = s_buf[ar, i].to(grad.dtype) * (al[ar, i] - be)[:, None]
        d = d + torch.where(active[:, None], step, 0.0)
    return d


def _permute2(gram: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """gram[b][perm[b]][:, perm[b]]."""
    B, m = perm.shape
    rows = gram.gather(1, perm[:, :, None].expand(B, m, m))
    return rows.gather(2, perm[:, None, :].expand(B, m, m))


def _compact_solve(gram_sy, gram_yy, sg, yg, h_diag, count):
    """Coefficients of the compact-representation direction −H·g from the
    Gram matrices and the projections Sᵀg, Yᵀg, in ring order. With
    R = triu(SᵀY), D = diag(SᵀY), γ = h:
        H·g = γg + S·R⁻ᵀ(D + γYᵀY)R⁻¹Sᵀg − γS·R⁻ᵀYᵀg − γY·R⁻¹Sᵀg
            = γg + S·top + γY·bot;
    returns (top, bot), each (B, m), 0 on the rows past the fill."""
    B, m = sg.shape
    num_valid = torch.clamp(count, max=m)
    start = torch.where(count < m, 0, count % m)
    ranks = torch.arange(m, device=sg.device)
    perm = (start[:, None] + ranks[None]) % m     # chronological → ring
    valid = ranks[None] < num_valid[:, None]      # (B, m) in rank space

    gamma = h_diag[:, None]
    sy = _permute2(gram_sy, perm)
    yy = _permute2(gram_yy, perm)
    p1 = torch.where(valid, sg.gather(1, perm), 0.0)
    p2 = torch.where(valid, yg.gather(1, perm), 0.0)

    both = valid[:, :, None] & valid[:, None, :]
    upper = ranks[:, None] <= ranks[None, :]
    # unit diagonal on invalid ranks: the solves are the identity there,
    # and those coefficients are zeroed below anyway
    r_mat = torch.where(both & upper, sy, 0.0) + torch.diag_embed(
        torch.where(valid, 0.0, 1.0).to(gram_sy.dtype))
    d_diag = torch.where(valid, torch.diagonal(sy, dim1=1, dim2=2), 0.0)
    yy_m = torch.where(both, yy, 0.0)

    q = torch.linalg.solve_triangular(r_mat, p1[..., None], upper=True)
    t_vec = d_diag[..., None] * q + gamma[..., None] * (yy_m @ q) \
        - gamma[..., None] * p2[..., None]
    top = torch.linalg.solve_triangular(r_mat.transpose(1, 2), t_vec,
                                        upper=False)[..., 0]
    top = torch.where(valid, top, 0.0)
    bot = torch.where(valid, -q[..., 0], 0.0)

    top_r = torch.zeros_like(top).scatter(1, perm, top)
    bot_r = torch.zeros_like(bot).scatter(1, perm, bot)
    return top_r, bot_r


def lbfgs_iteration(
    value_and_grad_fn: Callable[[torch.Tensor],
                                tuple[torch.Tensor, torch.Tensor]],
    state: LBFGSState,
    pos: int,
    lr: float = 1.0,
    tolerance_grad: float = 1e-7,
    tolerance_change: float = 1e-9,
    direction: str = "two_loop",
) -> tuple[LBFGSState, torch.Tensor]:
    """One uniform iteration for all pairs. `value_and_grad_fn(x)` maps
    (B, n) to (loss (B,), grad (B, n)). Returns (new state, loss at
    entry)."""
    if direction not in ("two_loop", "compact"):
        raise ValueError(f"unknown L-BFGS direction {direction!r}")
    profiling.count("lbfgs.iterations")
    with profiling.span("lbfgs.iteration"):
        return _iteration(value_and_grad_fn, state, pos, lr, tolerance_grad,
                          tolerance_change, direction)


def _iteration(value_and_grad_fn, state, pos, lr, tolerance_grad,
               tolerance_change, direction):
    B, m, _ = state.y_buf.shape
    ar = torch.arange(B, device=state.x.device)
    loss, grad = value_and_grad_fn(state.x)

    opt_cond = grad.abs().amax(dim=1) <= tolerance_grad
    if pos == 0:
        done = opt_cond
    else:
        # torch checks these at the end of the previous loop trip
        small_step = state.last_step_max <= tolerance_change
        flat_loss = (loss - state.prev_loss).abs() < tolerance_change
        done = state.done | opt_cond | small_step | flat_loss

    first = state.n_iter == 0

    with profiling.span("lbfgs.push"):
        y = grad - state.prev_grad
        s = state.d * state.t[:, None]
        ys = (y * s).sum(1)
        push = ~done & ~first & (ys > 1e-10)
        idx = state.count % m
        hdt = state.y_buf.dtype
        y_buf, s_buf = state.y_buf, state.s_buf
        y_buf[ar, idx] = torch.where(push[:, None], y.to(hdt),
                                     y_buf[ar, idx])
        s_buf[ar, idx] = torch.where(push[:, None], s.to(hdt),
                                     s_buf[ar, idx])
        ro_buf = state.ro_buf.clone()
        ro_buf[ar, idx] = torch.where(push, 1.0 / ys, ro_buf[ar, idx])
        count = torch.where(push, state.count + 1, state.count)
        h_diag = torch.where(push, ys / (y * y).sum(1), state.h_diag)

    with profiling.span("lbfgs.direction"):
        gram_sy, gram_yy = state.gram_sy, state.gram_yy
        if direction == "compact":
            # one pass over the valid rows of both buffers gives Sᵀg, Yᵀg
            # and the new Gram row and column (S·y_new, Y·y_new, Y·s_new),
            # with g, y, s rounded to the history dtype
            sg, s_y, yg, y_y, y_s = lbfgs_hist.hist_products(
                s_buf, y_buf, grad, y, s, count).unbind(1)
            p = push[:, None]
            gram_sy, gram_yy = gram_sy.clone(), gram_yy.clone()
            gram_sy[ar, :, idx] = torch.where(p, s_y, gram_sy[ar, :, idx])
            gram_sy[ar, idx, :] = torch.where(p, y_s, gram_sy[ar, idx, :])
            gram_yy[ar, :, idx] = torch.where(p, y_y, gram_yy[ar, :, idx])
            gram_yy[ar, idx, :] = torch.where(p, y_y, gram_yy[ar, idx, :])
            top, bot = _compact_solve(gram_sy, gram_yy, sg, yg, h_diag,
                                      count)
            # the second pass: −(γg + S·top + γY·bot)
            d_hist = lbfgs_hist.hist_combine(s_buf, y_buf, grad, top, bot,
                                             h_diag, count)
        else:
            d_hist = _two_loop(grad, y_buf, s_buf, ro_buf, h_diag, count)
        d = torch.where(first[:, None], -grad, d_hist)

    with profiling.span("lbfgs.update"):
        t0 = torch.clamp(1.0 / grad.abs().sum(1), max=1.0) * lr
        t = torch.where(first, t0, torch.full_like(t0, lr))

        gtd = (grad * d).sum(1)
        pre_break = gtd > -tolerance_change
        apply = ~done & ~pre_break
        x_new = torch.where(apply[:, None], state.x + t[:, None] * d,
                            state.x)
        last_step_max = torch.where(apply,
                                    (t[:, None] * d).abs().amax(dim=1),
                                    float("inf"))

        def sel(new, old):
            mask = done.reshape(-1, *([1] * (new.dim() - 1)))
            return torch.where(mask, old, new)

        new_state = LBFGSState(
            x=x_new,
            d=sel(d, state.d),
            t=sel(t, state.t),
            prev_grad=sel(grad, state.prev_grad),
            prev_loss=sel(loss, state.prev_loss),
            y_buf=y_buf,  # pushes already gated on ~done
            s_buf=s_buf,
            ro_buf=ro_buf,
            h_diag=sel(h_diag, state.h_diag),
            count=sel(count, state.count),
            n_iter=sel(state.n_iter + 1, state.n_iter),
            done=done | pre_break,
            last_step_max=sel(last_step_max, state.last_step_max),
            gram_sy=gram_sy,  # updates already gated on push
            gram_yy=gram_yy,
        )
    return new_state, loss


def lbfgs_run(value_and_grad_fn, x0: torch.Tensor, num_steps: int,
              max_iter: int = 10, history_size: int = 100, lr: float = 1.0,
              direction: str = "two_loop",
              history_dtype: torch.dtype | str | None = None):
    """`num_steps` `.step()` segments of `max_iter` iterations each.
    Returns (x_final (B, n), losses (B, num_steps·max_iter))."""
    state = lbfgs_init(x0, history_size, history_dtype)
    losses = []
    for _ in range(num_steps):
        for pos in range(max_iter):
            state, loss = lbfgs_iteration(value_and_grad_fn, state, pos, lr,
                                          direction=direction)
            losses.append(loss)
    return state.x, torch.stack(losses, dim=1)
