"""NUTS / HMC sampling kernels, batched over chains.

The reference framework stops at MAP point estimates (``fitting.py``);
this module supplies full posterior inference over GP hyperparameters --
the headline capability upgrade of this framework (BASELINE.json north
star: "NUTS/HMC with vectorized log-prob + leapfrog kernels ... chains
sharded across devices").

Design:

* The NUTS transition is the *iterative* formulation of multinomial NUTS
  (tree doubling with progressive biased sampling and the
  power-of-two-boundary U-turn bookkeeping), so the whole transition is
  ``lax.while_loop``/``fori_loop`` -- no recursion, fixed shapes, fully
  ``vmap``-able over chains and ``pjit``-able over a mesh.
* Warmup follows the Stan scheme in simplified form: dual-averaging step
  size adaptation throughout, diagonal mass-matrix (Welford) updates at
  two checkpoints inside one ``lax.scan``.
* All randomness is explicit ``jax.random`` keys.

References (public algorithms): Hoffman & Gelman (2014) for NUTS;
Betancourt (2017) for multinomial sampling on trajectories; Stan's
window adaptation.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "NUTSInfo",
    "nuts_kernel",
    "sample_nuts",
    "potential_and_grad",
    "nuts_warmup_init",
    "nuts_warmup_segment",
    "nuts_warmup_finish",
    "nuts_sample_segment",
]


def potential_and_grad(potential_fn):
    return jax.value_and_grad(potential_fn)


class NUTSInfo(NamedTuple):
    accept_prob: jnp.ndarray
    step_size: jnp.ndarray
    n_leapfrog: jnp.ndarray
    diverging: jnp.ndarray
    energy: jnp.ndarray


class _DAState(NamedTuple):
    """Dual-averaging state (Hoffman & Gelman 2014, eq. 6)."""

    log_step: jnp.ndarray
    log_step_avg: jnp.ndarray
    h_avg: jnp.ndarray
    mu: jnp.ndarray
    count: jnp.ndarray


def _da_init(step_size):
    return _DAState(
        log_step=jnp.log(step_size),
        log_step_avg=jnp.zeros_like(step_size, dtype=jnp.result_type(float)),
        h_avg=jnp.zeros(()),
        mu=jnp.log(10.0 * step_size),
        count=jnp.zeros(()),
    )


def _da_update(state, accept_prob, target=0.8, gamma=0.05, t0=10.0, kappa=0.75):
    count = state.count + 1.0
    h_avg = (1.0 - 1.0 / (count + t0)) * state.h_avg + (
        target - accept_prob
    ) / (count + t0)
    log_step = state.mu - jnp.sqrt(count) / gamma * h_avg
    eta = count ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return _DAState(log_step, log_step_avg, h_avg, state.mu, count)


def _leapfrog(pg_fn, inv_mass, step_size, q, p, grad):
    p_half = p - 0.5 * step_size * grad
    q_new = q + step_size * inv_mass * p_half
    u_new, grad_new = pg_fn(q_new)
    p_new = p_half - 0.5 * step_size * grad_new
    return q_new, p_new, u_new, grad_new


def _kinetic(inv_mass, p):
    return 0.5 * jnp.sum(inv_mass * p * p)


def _is_turning(inv_mass, p_left, p_right, p_sum):
    """Generalized U-turn criterion on a trajectory segment."""
    v = inv_mass * p_sum
    return jnp.logical_or(
        jnp.dot(v, p_left, precision=jax.lax.Precision.HIGHEST) <= 0.0,
        jnp.dot(v, p_right, precision=jax.lax.Precision.HIGHEST) <= 0.0
    )


class _TreeState(NamedTuple):
    q_left: jnp.ndarray
    p_left: jnp.ndarray
    grad_left: jnp.ndarray
    q_right: jnp.ndarray
    p_right: jnp.ndarray
    grad_right: jnp.ndarray
    q_prop: jnp.ndarray       # current proposal (multinomial draw)
    grad_prop: jnp.ndarray
    u_prop: jnp.ndarray       # potential at proposal
    log_weight: jnp.ndarray   # log sum of exp(-energy) over the tree
    p_sum: jnp.ndarray        # sum of momenta across the trajectory
    turning: jnp.ndarray
    diverging: jnp.ndarray
    sum_accept: jnp.ndarray   # sum of min(1, exp(H0 - H)) for adaptation
    n_steps: jnp.ndarray


def _popcount(i):
    """Number of set bits of a (traced) non-negative int32."""

    def body(carry):
        n, v = carry
        return n + (v & 1), v >> 1

    def cond(carry):
        return carry[1] > 0

    n, _ = lax.while_loop(cond, body, (jnp.zeros((), jnp.int32), i))
    return n


def _trailing_ones(i):
    """Number of trailing one-bits of i."""

    def cond(carry):
        return carry[1] % 2 == 1

    def body(carry):
        n, v = carry
        return n + 1, v // 2

    n, _ = lax.while_loop(cond, body, (jnp.zeros((), jnp.int32), i))
    return n


def _build_subtree(
    pg_fn, inv_mass, step_size, depth, max_depth, direction, energy0, state,
    key, max_delta=1000.0,
):
    """Extend the trajectory by ``2**depth`` leapfrog steps in ``direction``.
    (``depth`` is traced -- the loop bound lowers to a while loop;
    ``max_depth`` is static and sizes the checkpoint stack.)

    U-turn detection uses the iterative checkpoint scheme: momentum and
    cumulative momentum-sum are stored at even leaf indices (checkpoint
    slot ``popcount(i >> 1)``); every odd leaf checks the generalized
    no-U-turn criterion against the checkpoints of all balanced subtrees
    that end at that leaf (slots ``popcount(i>>1) - trailing_ones(i) + 1
    .. popcount(i>>1)``).
    """
    P = state.q_left.shape[0]
    n_leaf = 2**depth
    stack_size = max(int(max_depth), 1)

    # starting point: the trajectory edge in `direction`
    q0 = jnp.where(direction > 0, state.q_right, state.q_left)
    p0 = jnp.where(direction > 0, state.p_right, state.p_left)
    g0 = jnp.where(direction > 0, state.grad_right, state.grad_left)

    def leaf_step(i, carry):
        (
            q, p, grad, log_w, p_sum_sub, q_prop, grad_prop, u_prop,
            turning, diverging, sum_acc, key, r_ckpts, r_sum_ckpts,
        ) = carry

        q, p, u, grad = _leapfrog(
            pg_fn, inv_mass, direction * step_size, q, p, grad
        )
        energy = u + _kinetic(inv_mass, p)
        energy = jnp.where(jnp.isnan(energy), jnp.inf, energy)
        delta = energy - energy0
        diverging_new = delta > max_delta
        log_wi = -delta  # relative log weight of this leaf

        # multinomial progressive sampling within the subtree
        key, sub = jax.random.split(key)
        log_w_new = jnp.logaddexp(log_w, log_wi)
        accept_leaf = jnp.log(jax.random.uniform(sub)) < log_wi - log_w_new
        q_prop = jnp.where(accept_leaf, q, q_prop)
        grad_prop = jnp.where(accept_leaf, grad, grad_prop)
        u_prop = jnp.where(accept_leaf, u, u_prop)

        sum_acc = sum_acc + jnp.minimum(1.0, jnp.exp(-delta))
        p_sum_sub = p_sum_sub + p

        # --- iterative U-turn bookkeeping (checkpoint scheme) ---
        idx_max = _popcount(i >> 1)
        idx_min = idx_max - _trailing_ones(i) + 1

        def store(args):
            r_ckpts, r_sum_ckpts, turning = args
            r_ckpts = lax.dynamic_update_index_in_dim(r_ckpts, p, idx_max, 0)
            r_sum_ckpts = lax.dynamic_update_index_in_dim(
                r_sum_ckpts, p_sum_sub, idx_max, 0
            )
            return r_ckpts, r_sum_ckpts, turning

        def check(args):
            r_ckpts, r_sum_ckpts, turning = args

            def body(k, turning):
                applies = jnp.logical_and(k >= idx_min, k <= idx_max)
                r_left = r_ckpts[k]
                segment_sum = p_sum_sub - r_sum_ckpts[k] + r_left
                turn = _is_turning(inv_mass, r_left, p, segment_sum)
                return jnp.logical_or(turning, jnp.logical_and(applies, turn))

            turning = lax.fori_loop(0, stack_size, body, turning)
            return r_ckpts, r_sum_ckpts, turning

        r_ckpts, r_sum_ckpts, turning = lax.cond(
            i % 2 == 0, store, check, (r_ckpts, r_sum_ckpts, turning)
        )
        diverging = jnp.logical_or(diverging, diverging_new)

        return (
            q, p, grad, log_w_new, p_sum_sub, q_prop, grad_prop, u_prop,
            turning, diverging, sum_acc, key, r_ckpts, r_sum_ckpts,
        )

    def guarded_leaf(i, carry):
        turning, diverging = carry[8], carry[9]
        stop = jnp.logical_or(turning, diverging)
        return lax.cond(stop, lambda _i, c: c, leaf_step, i, carry)

    r_ckpts0 = jnp.zeros((stack_size, P), dtype=q0.dtype)
    r_sum_ckpts0 = jnp.zeros((stack_size, P), dtype=q0.dtype)
    init = (
        q0, p0, g0,
        jnp.array(-jnp.inf),             # subtree log weight
        jnp.zeros_like(p0),              # subtree momentum sum
        q0, g0, jnp.zeros(()),           # proposal placeholders
        jnp.array(False), jnp.array(False),
        jnp.zeros(()), key, r_ckpts0, r_sum_ckpts0,
    )
    (
        q_end, p_end, grad_end, log_w_sub, p_sum_sub, q_prop, grad_prop,
        u_prop, turning, diverging, sum_acc, _, _, _,
    ) = lax.fori_loop(0, n_leaf, guarded_leaf, init)

    return (
        q_end, p_end, grad_end, log_w_sub, p_sum_sub, q_prop, grad_prop,
        u_prop, turning, diverging, sum_acc,
    )


def nuts_kernel(potential_fn, max_depth=8, max_delta=1000.0):
    """Build a NUTS transition kernel for ``potential_fn`` (negative log
    density of the raw parameters).

    Returns ``step(key, q, u, grad, step_size, inv_mass) ->
    (q', u', grad', NUTSInfo)``; jittable and vmappable.
    """
    pg_fn = jax.value_and_grad(potential_fn)

    def step(key, q, u, grad, step_size, inv_mass):
        key_mom, key_tree = jax.random.split(key)
        p0 = jax.random.normal(key_mom, q.shape, dtype=q.dtype) / jnp.sqrt(
            inv_mass
        )
        energy0 = u + _kinetic(inv_mass, p0)

        state = _TreeState(
            q_left=q, p_left=p0, grad_left=grad,
            q_right=q, p_right=p0, grad_right=grad,
            q_prop=q, grad_prop=grad, u_prop=u,
            log_weight=jnp.zeros(()),
            p_sum=p0,
            turning=jnp.array(False),
            diverging=jnp.array(False),
            sum_accept=jnp.zeros(()),
            n_steps=jnp.zeros((), jnp.int32),
        )

        def cond(carry):
            depth, state, key = carry
            return jnp.logical_and(
                depth < max_depth,
                jnp.logical_not(
                    jnp.logical_or(state.turning, state.diverging)
                ),
            )

        def body(carry):
            depth, state, key = carry
            key, key_dir, key_sub, key_accept = jax.random.split(key, 4)
            direction = jnp.where(
                jax.random.bernoulli(key_dir), 1.0, -1.0
            ).astype(q.dtype)

            (
                q_end, p_end, grad_end, log_w_sub, p_sum_sub, q_prop_sub,
                grad_prop_sub, u_prop_sub, turning_sub, diverging_sub,
                sum_acc_sub,
            ) = _build_subtree(
                pg_fn, inv_mass, step_size, depth, max_depth, direction,
                energy0, state, key_sub, max_delta,
            )

            # update trajectory edges
            q_left = jnp.where(direction > 0, state.q_left, q_end)
            p_left = jnp.where(direction > 0, state.p_left, p_end)
            grad_left = jnp.where(direction > 0, state.grad_left, grad_end)
            q_right = jnp.where(direction > 0, q_end, state.q_right)
            p_right = jnp.where(direction > 0, p_end, state.p_right)
            grad_right = jnp.where(direction > 0, grad_end, state.grad_right)

            # biased progressive sampling between old tree and new subtree
            subtree_ok = jnp.logical_not(
                jnp.logical_or(turning_sub, diverging_sub)
            )
            log_ratio = log_w_sub - state.log_weight
            accept_sub = jnp.logical_and(
                subtree_ok,
                jnp.log(jax.random.uniform(key_accept))
                < jnp.minimum(0.0, log_ratio),
            )
            q_prop = jnp.where(accept_sub, q_prop_sub, state.q_prop)
            grad_prop = jnp.where(accept_sub, grad_prop_sub, state.grad_prop)
            u_prop = jnp.where(accept_sub, u_prop_sub, state.u_prop)

            log_weight = jnp.where(
                subtree_ok,
                jnp.logaddexp(state.log_weight, log_w_sub),
                state.log_weight,
            )

            p_sum = state.p_sum + jnp.where(subtree_ok, p_sum_sub, 0.0)
            turning_total = jnp.where(
                subtree_ok,
                _is_turning(inv_mass, p_left, p_right, p_sum),
                jnp.array(True),  # subtree failed: stop doubling
            )

            new_state = _TreeState(
                q_left=q_left, p_left=p_left, grad_left=grad_left,
                q_right=q_right, p_right=p_right, grad_right=grad_right,
                q_prop=q_prop, grad_prop=grad_prop, u_prop=u_prop,
                log_weight=log_weight,
                p_sum=p_sum,
                turning=jnp.logical_or(turning_sub, turning_total),
                diverging=jnp.logical_or(state.diverging, diverging_sub),
                sum_accept=state.sum_accept + sum_acc_sub,
                n_steps=state.n_steps + 2**depth,
            )
            return depth + 1, new_state, key

        _, final, _ = lax.while_loop(
            cond, body, (jnp.zeros((), jnp.int32), state, key_tree)
        )

        accept_prob = final.sum_accept / jnp.maximum(
            final.n_steps.astype(q.dtype), 1.0
        )
        info = NUTSInfo(
            accept_prob=accept_prob,
            step_size=step_size,
            n_leapfrog=final.n_steps,
            diverging=final.diverging,
            energy=final.u_prop,
        )
        return final.q_prop, final.u_prop, final.grad_prop, info

    return step


class _WelfordState(NamedTuple):
    mean: jnp.ndarray
    m2: jnp.ndarray
    count: jnp.ndarray


def _welford_init(P, dtype):
    return _WelfordState(
        jnp.zeros(P, dtype=dtype), jnp.zeros(P, dtype=dtype), jnp.zeros(())
    )


def _welford_update(state, x):
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count
    m2 = state.m2 + delta * (x - mean)
    return _WelfordState(mean, m2, count)


def _welford_var(state, regularize=True):
    var = state.m2 / jnp.maximum(state.count - 1.0, 1.0)
    if regularize:
        # Stan-style shrinkage towards unit
        n = state.count
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var


@partial(
    jax.jit,
    static_argnames=("potential_fn", "n_warmup", "n_samples", "max_depth",
                     "target_accept"),
)
def sample_nuts(
    potential_fn,
    q0,
    key,
    n_warmup=500,
    n_samples=500,
    max_depth=8,
    target_accept=0.8,
    init_step_size=0.1,
):
    """Run one NUTS chain: warmup (dual-averaging + diagonal mass) then
    sampling.  ``vmap`` over (q0, key) for multiple chains; shard the
    chain axis over a mesh for multi-chip scaling.

    :param potential_fn: negative log density of the raw parameters.
    :param q0: initial position ``(P,)``.
    :returns: ``(samples (n_samples, P), NUTSInfo (stacked))``.
    """
    pg_fn = jax.value_and_grad(potential_fn)
    P = q0.shape[0]
    dtype = q0.dtype
    kernel = nuts_kernel(potential_fn, max_depth=max_depth)

    u0, grad0 = pg_fn(q0)

    # mass-update checkpoints within warmup
    m1 = int(n_warmup * 0.5)
    m2 = int(n_warmup * 0.9)

    def warmup_step(carry, i):
        key, q, u, grad, da, inv_mass, welford = carry
        key, sub = jax.random.split(key)
        step_size = jnp.exp(da.log_step)
        q, u, grad, info = kernel(sub, q, u, grad, step_size, inv_mass)
        da = _da_update(da, info.accept_prob, target=target_accept)
        welford = _welford_update(welford, q)

        def refresh(args):
            da, inv_mass, welford = args
            new_inv_mass = _welford_var(welford)
            new_da = _da_init(jnp.exp(da.log_step_avg))
            return new_da, new_inv_mass, _welford_init(P, dtype)

        da, inv_mass, welford = lax.cond(
            jnp.logical_or(i == m1, i == m2),
            refresh,
            lambda args: args,
            (da, inv_mass, welford),
        )
        return (key, q, u, grad, da, inv_mass, welford), None

    init_carry = (
        key, q0, u0, grad0,
        _da_init(jnp.asarray(init_step_size, dtype=dtype)),
        jnp.ones(P, dtype=dtype),
        _welford_init(P, dtype),
    )
    (key, q, u, grad, da, inv_mass, _), _ = lax.scan(
        warmup_step, init_carry, jnp.arange(n_warmup)
    )

    step_size = jnp.exp(da.log_step_avg)

    def sample_step(carry, _):
        key, q, u, grad = carry
        key, sub = jax.random.split(key)
        q, u, grad, info = kernel(sub, q, u, grad, step_size, inv_mass)
        return (key, q, u, grad), (q, info)

    (_, q, u, grad), (samples, infos) = lax.scan(
        sample_step, (key, q, u, grad), None, length=n_samples
    )
    return samples, infos


# ---------------------------------------------------------------------------
# Segmented sampling: the same chain split into bounded-length dispatches
# ---------------------------------------------------------------------------
#
# A single `sample_nuts` program runs the WHOLE chain in one XLA
# execution.  The segmented API below carries the exact warmup/sampling
# state across fixed-size `lax.scan` segments, so a host loop can bound
# per-dispatch wall-clock and checkpoint between segments; the composed
# chain is IDENTICAL to the single-program one (same kernel, same dual-
# averaging / Welford state, same key stream).


class NUTSWarmupCarry(NamedTuple):
    key: jnp.ndarray
    q: jnp.ndarray
    u: jnp.ndarray
    grad: jnp.ndarray
    da: _DAState
    inv_mass: jnp.ndarray
    welford: _WelfordState


class NUTSSampleCarry(NamedTuple):
    key: jnp.ndarray
    q: jnp.ndarray
    u: jnp.ndarray
    grad: jnp.ndarray
    step_size: jnp.ndarray
    inv_mass: jnp.ndarray


@partial(jax.jit, static_argnames=("potential_fn",))
def nuts_warmup_init(potential_fn, q0, key, init_step_size=0.1):
    """Initial warmup carry for one chain (vmap over (q0, key))."""
    u0, grad0 = jax.value_and_grad(potential_fn)(q0)
    P = q0.shape[0]
    dtype = q0.dtype
    return NUTSWarmupCarry(
        key=key, q=q0, u=u0, grad=grad0,
        da=_da_init(jnp.asarray(init_step_size, dtype=dtype)),
        inv_mass=jnp.ones(P, dtype=dtype),
        welford=_welford_init(P, dtype),
    )


@partial(
    jax.jit,
    static_argnames=("potential_fn", "n_seg", "max_depth", "target_accept"),
)
def nuts_warmup_segment(potential_fn, carry, i0, n_seg, m1, m2,
                        max_depth=8, target_accept=0.8):
    """Advance warmup by ``n_seg`` iterations starting at global index
    ``i0`` (traced).  The Stan-style mass-matrix refresh checkpoints
    ``m1``/``m2`` (50%/90% of the TOTAL warmup length; traced scalars so
    the compiled program is independent of the total) fire on the global
    index, so any segmentation composes to the exact single-program
    warmup."""
    kernel = nuts_kernel(potential_fn, max_depth=max_depth)
    P = carry.q.shape[0]
    dtype = carry.q.dtype

    def warmup_step(c, i):
        key, sub = jax.random.split(c.key)
        step_size = jnp.exp(c.da.log_step)
        q, u, grad, info = kernel(sub, c.q, c.u, c.grad, step_size,
                                  c.inv_mass)
        da = _da_update(c.da, info.accept_prob, target=target_accept)
        welford = _welford_update(c.welford, q)

        def refresh(args):
            da, inv_mass, welford = args
            new_inv_mass = _welford_var(welford)
            new_da = _da_init(jnp.exp(da.log_step_avg))
            return new_da, new_inv_mass, _welford_init(P, dtype)

        da, inv_mass, welford = lax.cond(
            jnp.logical_or(i == m1, i == m2),
            refresh,
            lambda args: args,
            (da, c.inv_mass, welford),
        )
        return NUTSWarmupCarry(key, q, u, grad, da, inv_mass, welford), None

    carry, _ = lax.scan(warmup_step, carry, i0 + jnp.arange(n_seg))
    return carry


@jax.jit
def nuts_warmup_finish(carry):
    """Freeze the adapted step size / mass matrix into a sampling carry."""
    return NUTSSampleCarry(
        key=carry.key, q=carry.q, u=carry.u, grad=carry.grad,
        step_size=jnp.exp(carry.da.log_step_avg),
        inv_mass=carry.inv_mass,
    )


@partial(jax.jit, static_argnames=("potential_fn", "n_seg", "max_depth"))
def nuts_sample_segment(potential_fn, carry, n_seg, max_depth=8):
    """Draw ``n_seg`` samples, returning the carry for the next segment.

    :returns: ``(carry, samples (n_seg, P), NUTSInfo (stacked))``.
    """
    kernel = nuts_kernel(potential_fn, max_depth=max_depth)

    def sample_step(c, _):
        key, sub = jax.random.split(c.key)
        q, u, grad, info = kernel(sub, c.q, c.u, c.grad, c.step_size,
                                  c.inv_mass)
        return NUTSSampleCarry(key, q, u, grad, c.step_size, c.inv_mass), (
            q, info,
        )

    carry, (samples, infos) = lax.scan(sample_step, carry, None,
                                       length=n_seg)
    return carry, samples, infos
