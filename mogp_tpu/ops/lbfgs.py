"""Batched on-device L-BFGS.

Replacement for the reference's optimizer drivers: scipy
``minimize(method="L-BFGS-B")`` per restart (``fitting.py:244``) and the
GPU backend's serial dlib BFGS (``mogp_gpu/src/fitting.hpp:91-99``).  The
whole minimization -- two-loop recursion, line search, convergence tests
-- is one ``lax.while_loop``, so it can be ``vmap``-ed over an
(outputs x restarts) axis and sharded over a device mesh: every restart
of every output advances in lockstep inside a single XLA program instead
of a process pool (``fitting.py:333-335``).

Failure semantics: a start whose objective is non-finite (non-PD
covariance and similar) stops iterating and reports its best-seen point;
NaN objectives propagate to the final value where the caller masks them
out -- the XLA-friendly version of the reference's try/except-skip
restart policy (``fitting.py:252-255``).  A line search that exhausts
its per-iteration trial cap does NOT terminate the lane: the shrunken
step warm-starts the next iteration (see ``_DEF_MAX_LS``), and the lane
stops only on convergence, step collapse, or stall.

The objective must be smooth; gradients come from ``jax.value_and_grad``.
"""

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["LBFGSResult", "lbfgs_minimize"]

def _dot(a, b):
    # full-f32 dot: these are tiny (P,) contractions, but the GPU's
    # default float32 product is TF32 and the curvature tests (s.y, y.y,
    # g.d) deserve full mantissas
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)


# Per-iteration line-search trial cap.  Under vmap every lane pays the
# batch-MAX trial count per lockstep iteration (each trial is one full
# batched objective), so the cap is a direct multiplier on batched fit
# cost.  A capped-out search does NOT terminate the lane: the shrunken
# step carries into the next iteration's warm start, so a deep
# backtracking ladder is amortized ACROSS iterations instead of charging
# every lane for it within one (measured on the tsunami-shape batch:
# race phase A from random prior starts was ~85% of fit wall-clock,
# ~3x phase B's per-lane-iteration cost, almost entirely batch-max
# trial ladders).  Default 2 was tuned on the previous accelerator and is
# not yet measured on the GPU.
_DEF_MAX_LS = int(os.environ.get("MOGP_TPU_MAX_LINESEARCH", "2"))


class LBFGSResult(NamedTuple):
    x: jnp.ndarray          # final iterate
    fun: jnp.ndarray        # objective at x (inf/NaN when failed)
    grad: jnp.ndarray       # gradient at x
    n_iter: jnp.ndarray     # iterations taken
    converged: jnp.ndarray  # gradient/function tolerance reached


class _State(NamedTuple):
    x: jnp.ndarray
    f: jnp.ndarray
    g: jnp.ndarray
    S: jnp.ndarray        # (m, P) step history
    Y: jnp.ndarray        # (m, P) grad-diff history
    rho: jnp.ndarray      # (m,) 1 / s.y
    gamma: jnp.ndarray    # H0 scaling
    n_hist: jnp.ndarray   # valid history entries
    f_best: jnp.ndarray   # best objective seen (stall detection)
    stall: jnp.ndarray    # iterations since a significant improvement
    t_prev: jnp.ndarray   # last accepted step length (warm-started t0)
    it: jnp.ndarray
    done: jnp.ndarray
    converged: jnp.ndarray


def _two_loop(g, S, Y, rho, gamma, n_hist):
    """Two-loop recursion producing the quasi-Newton direction -H g.

    History is kept *ordered* (slot m-1 = newest, maintained by rolling on
    store), so both loops scan fixed-order slices with no dynamic
    indexing -- keeps the lowered HLO free of gathers.
    """
    m = S.shape[0]
    ks = jnp.arange(m)
    valid = ks >= (m - n_hist)  # slots holding real history

    def bwd(carry, operands):
        q, = carry
        s, y, rh, v = operands
        alpha = jnp.where(v, rh * _dot(s, q), 0.0)
        q = q - alpha * y
        return (q,), alpha

    (q,), alphas_rev = lax.scan(
        bwd, (g,), (S[::-1], Y[::-1], rho[::-1], valid[::-1])
    )
    r = gamma * q
    alphas = alphas_rev[::-1]

    def fwd(carry, operands):
        r, = carry
        s, y, rh, v, alpha = operands
        beta = jnp.where(v, rh * _dot(y, r), 0.0)
        r = r + (alpha - beta) * s * v
        return (r,), None

    (r,), _ = lax.scan(fwd, (r,), (S, Y, rho, valid, alphas))
    return -r


def lbfgs_minimize(
    fun,
    x0,
    maxiter=200,
    gtol=None,
    ftol=None,
    memory=10,
    max_linesearch=None,
    c1=1e-4,
    c2=0.9,
):
    """Minimize ``fun`` from ``x0`` with L-BFGS + weak-Wolfe backtracking.

    :param fun: scalar objective ``f(x)``; differentiated with
                ``jax.value_and_grad``.
    :param x0: starting point ``(P,)``.
    :param gtol: inf-norm gradient tolerance; ``None`` selects a
                 dtype-appropriate default (1e-5 in f64, ~3e-4 in f32 --
                 f64-calibrated tolerances make float32 runs spin to
                 maxiter on rounding noise).
    :param ftol: relative objective-change tolerance; ``None`` selects
                 ~1e-10 in f64, ~1e-6 in f32.
    :returns: ``LBFGSResult``.  Jittable and vmappable.
    """
    if max_linesearch is None:
        max_linesearch = _DEF_MAX_LS
    value_and_grad = jax.value_and_grad(fun)
    P = x0.shape[0]
    dtype = x0.dtype
    m = memory

    eps = float(jnp.finfo(dtype).eps)
    if gtol is None:
        gtol = max(1e-5, 2.0 * eps**0.5)
    if ftol is None:
        ftol = max(1e-10, 10.0 * eps)

    f0, g0 = value_and_grad(x0)
    bad_start = jnp.logical_not(jnp.isfinite(f0) & jnp.all(jnp.isfinite(g0)))

    init = _State(
        x=x0,
        f=f0,
        g=g0,
        S=jnp.zeros((m, P), dtype=dtype),
        Y=jnp.zeros((m, P), dtype=dtype),
        rho=jnp.zeros((m,), dtype=dtype),
        gamma=jnp.ones((), dtype=dtype),
        n_hist=jnp.zeros((), dtype=jnp.int32),
        f_best=f0,
        stall=jnp.zeros((), dtype=jnp.int32),
        t_prev=jnp.ones((), dtype=dtype),
        it=jnp.zeros((), dtype=jnp.int32),
        done=bad_start,
        converged=jnp.array(False),
    )

    def linesearch(x, f, g, d, t0, active):
        """Backtracking (Armijo) line search with value-and-grad trials
        and safeguarded quadratic interpolation.

        Trials evaluate the objective WITH its gradient: for this
        framework's objectives the gradient is nearly free on top of the
        forward pass (the custom-VJP Cholesky factor reuse makes the
        pullback a handful of triangular solves with no new
        factorization), so
        carrying the gradient through the trial loop and skipping the
        separate value-and-grad at the accepted point halves the
        objective evaluations of the common one-trial iteration.  The
        Wolfe curvature condition is replaced by the positive-curvature
        filter at history-store time, the standard pairing for
        backtracking L-BFGS.

        On a rejected trial the next step length comes from the minimizer
        of the quadratic through ``(f, gd, f_new)`` -- clamped to
        ``[0.02 t, 0.5 t]`` -- instead of plain halving.  Under vmap the
        trial loop costs every lane the MAX trial count over the batch
        (one full batched objective per trial), so shaving the trial
        ladder of the worst lane is a direct multiplier on batched fit
        throughput; interpolation typically lands an overshot first trial
        in one extra evaluation where halving needs several.

        ``active`` short-circuits the search: lanes that are already done
        (converged/stalled/failed) sit at points where no strict decrease
        exists, so without this flag they would drag every batched
        iteration to ``max_linesearch`` objective evaluations.
        """
        gd = _dot(g, d)

        def cond(carry):
            t, ls_it, accepted, *_ = carry
            return jnp.logical_and(ls_it < max_linesearch, jnp.logical_not(accepted))

        def body(carry):
            t, ls_it, accepted, xt, ft, gt, t_acc = carry
            x_new = x + t * d
            f_new, g_new = value_and_grad(x_new)
            armijo = f_new <= f + c1 * t * gd
            # accept only fully finite trials: a finite objective with a
            # NaN/Inf gradient (near-singular Cholesky pullback) would
            # poison the next direction and the curvature pair
            finite = jnp.logical_and(
                jnp.isfinite(f_new), jnp.all(jnp.isfinite(g_new))
            )
            ok = jnp.logical_and(finite, armijo)
            xt = jnp.where(ok, x_new, xt)
            ft = jnp.where(ok, f_new, ft)
            gt = jnp.where(ok, g_new, gt)
            t_acc = jnp.where(ok, t, t_acc)
            # quadratic interpolation: minimizer of the parabola matching
            # f(0)=f, f'(0)=gd, f(t)=f_new is t_q = -gd t^2 / (2 (f_new -
            # f - gd t)); safeguard into [0.02 t, 0.5 t] and fall back to
            # halving when the trial value is non-finite.  The lower
            # clamp is deliberately loose: under vmap every lane pays the
            # batch-max trial count, and a lane whose acceptable step is
            # 100x below the trial needs 7 trials at a 0.1 floor but only
            # 2-3 at 0.02.  Tuned on the previous accelerator; not yet
            # measured on the GPU.
            denom = 2.0 * (f_new - f - gd * t)
            t_q = -gd * t * t / jnp.where(denom == 0.0, 1.0, denom)
            t_next = jnp.clip(t_q, 0.02 * t, 0.5 * t)
            # non-finite trial (failed Cholesky region): no parabola to
            # interpolate -- shrink aggressively (0.1x) to exit the bad
            # region in few trials.  With both shrink rates, 10 trials
            # reach step reductions of 1e-10..1e-17, far below anything
            # a finite-precision objective can use, so the default
            # ``max_linesearch=10`` loses nothing (25 -> 10 trials gave
            # bit-identical final optima on the tsunami-shape batch).
            t_next = jnp.where(jnp.isfinite(f_new), t_next, 0.1 * t)
            return (t_next, ls_it + 1, ok, xt, ft, gt, t_acc)

        # inactive lanes start "accepted" so they never spin the loop;
        # the outer update masks on the outer while predicate anyway
        carry = (
            t0, jnp.zeros((), jnp.int32), jnp.logical_not(active), x, f, g, t0,
        )
        t_next, _, accepted, xt, ft, gt, t_acc = lax.while_loop(
            cond, body, carry
        )
        # rejected lanes already carry (x, f, g) unchanged: the carry
        # initializes the trial slots to the incumbent point and only
        # overwrites them on acceptance.  t_next is the (shrunken) step
        # the NEXT trial would have used -- a capped-out lane resumes its
        # backtracking ladder there next iteration.
        accepted = jnp.logical_and(accepted, active)
        return accepted, xt, ft, gt, t_acc, t_next

    def step(state):
        d = _two_loop(
            state.g, state.S, state.Y, state.rho, state.gamma, state.n_hist,
        )
        # safeguard: fall back to steepest descent if not a descent direction
        descent = _dot(state.g, d) < 0
        d = jnp.where(descent, d, -state.g)

        # with no curvature history the direction is the raw (unscaled)
        # gradient, whose magnitude can be enormous for badly-scaled
        # objectives; scale the first trial step to unit length
        # (Nocedal & Wright's standard first-iteration step length).
        # Otherwise warm-start from twice the last accepted step, capped
        # at the unit quasi-Newton step: lanes whose acceptable step has
        # collapsed (endgame near the float32 rounding floor, or a badly
        # scaled region) would otherwise re-descend the whole backtracking
        # ladder from t=1 EVERY iteration -- and under vmap the batched
        # trial loop runs to the max trial count over all lanes, so a few
        # such lanes made every batched iteration cost ~max_linesearch
        # objective evaluations.
        # In BOTH branches the warm start is capped by 2*t_prev: with the
        # low trial cap, a capped-out search relies on t_prev carrying
        # the shrunken step into the next iteration -- including before
        # any curvature pair is stored (n_hist == 0), where recomputing
        # t0 from 1/||d|| alone would retry the identical short ladder
        # every iteration and falsely stall lanes whose acceptable step
        # is far below the unit-length start.
        d_norm = jnp.linalg.norm(d)
        t0 = jnp.minimum(
            2.0 * state.t_prev,
            jnp.where(
                state.n_hist == 0,
                jnp.minimum(1.0, 1.0 / jnp.maximum(d_norm, 1e-30)),
                jnp.ones((), dtype=dtype),
            ),
        ).astype(dtype)

        accepted, x_new, f_new, g_new, t_acc, t_next = linesearch(
            state.x, state.f, state.g, d, t0, jnp.logical_not(state.done)
        )

        s = x_new - state.x
        y = g_new - state.g
        sy = _dot(s, y)
        curv_ok = sy > 1e-10 * jnp.linalg.norm(s) * jnp.linalg.norm(y)
        store = jnp.logical_and(accepted, curv_ok)

        # ordered history: roll the buffers and write the newest at m-1
        S_rolled = jnp.concatenate([state.S[1:], s[None]], axis=0)
        Y_rolled = jnp.concatenate([state.Y[1:], y[None]], axis=0)
        rho_rolled = jnp.concatenate(
            [state.rho[1:], (1.0 / sy)[None]], axis=0
        )
        S = jnp.where(store, S_rolled, state.S)
        Y = jnp.where(store, Y_rolled, state.Y)
        rho = jnp.where(store, rho_rolled, state.rho)
        n_hist = jnp.where(store, jnp.minimum(state.n_hist + 1, m), state.n_hist)
        gamma = jnp.where(store, sy / _dot(y, y), state.gamma)

        g_conv = jnp.max(jnp.abs(g_new)) <= gtol
        f_conv = jnp.abs(f_new - state.f) <= ftol * jnp.maximum(
            jnp.abs(f_new), 1.0
        )
        converged = jnp.logical_and(
            accepted, jnp.logical_or(g_conv, f_conv)
        )
        # stall detection: lockstep-batched lanes that bounce around a
        # plateau without net progress would otherwise run to maxiter and
        # hold the whole batch hostage.  A capped-out line search is NOT
        # terminal: the lane keeps its point, resumes the (shrunken)
        # backtracking ladder next iteration via t_prev, and only stops
        # when the step has collapsed below any float-representable
        # decrease or the stall counter fires -- this is what makes a
        # LOW trial cap safe (the ladder amortizes across iterations
        # instead of costing every lane the batch-max within one).
        improved = f_new < state.f_best - ftol * jnp.maximum(
            jnp.abs(state.f_best), 1.0
        )
        f_best = jnp.minimum(state.f_best, f_new)
        stall = jnp.where(improved, 0, state.stall + 1)
        t_carry = jnp.where(accepted, t_acc, t_next).astype(dtype)
        step_collapsed = jnp.logical_and(
            jnp.logical_not(accepted), t_carry <= 1e3 * jnp.finfo(dtype).tiny
        )
        done = jnp.logical_or(
            jnp.logical_or(converged, step_collapsed),
            stall >= 10,
        )

        return _State(
            x=jnp.where(accepted, x_new, state.x),
            f=jnp.where(accepted, f_new, state.f),
            g=jnp.where(accepted, g_new, state.g),
            S=S, Y=Y, rho=rho, gamma=gamma, n_hist=n_hist,
            f_best=f_best,
            stall=stall,
            t_prev=t_carry,
            it=state.it + 1,
            done=done,
            converged=converged,
        )

    def cond(state):
        return jnp.logical_and(state.it < maxiter, jnp.logical_not(state.done))

    final = lax.while_loop(cond, step, init)
    return LBFGSResult(
        x=final.x,
        fun=final.f,
        grad=final.g,
        n_iter=final.it,
        converged=final.converged,
    )
