"""Precision audit: every contraction in the main programs is pinned.

On the GPU an unpinned float32 ``dot_general`` may run in TF32 (about
three decimal digits), which wrecks the kernel matrix and everything
derived from its factor (see ``mogp_tpu.config``).  The suite runs in
float64 on the CPU, where that cannot show in a result, so this test
reads the programs instead: it traces each one and fails on any
``dot_general`` whose precision is not ``HIGHEST``, unless it is on the
allowlist below.
"""

import numpy as np
import pytest

import jax
import jax.extend.core
import jax.numpy as jnp
from jax import lax

# (program, reason) pairs whose unpinned products are accepted; empty --
# every product in the audited programs is pinned.
ALLOWLIST = {}


def _subjaxprs(eqn):
    for v in eqn.params.values():
        for item in v if isinstance(v, (tuple, list)) else (v,):
            if isinstance(item, jax.extend.core.ClosedJaxpr):
                yield item.jaxpr
            elif isinstance(item, jax.extend.core.Jaxpr):
                yield item


def unpinned_dots(jaxpr):
    """Every ``dot_general`` in ``jaxpr`` (recursively) not at HIGHEST."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            prec = eqn.params.get("precision")
            if prec is None or not all(
                p == lax.Precision.HIGHEST for p in prec
            ):
                out.append("{} {}".format(
                    [str(v.aval) for v in eqn.invars], prec))
        for sub in _subjaxprs(eqn):
            out.extend(unpinned_dots(sub))
    return out


def _gp(n=12, D=2, nugget="adaptive", mean=None, seed=0):
    from mogp_tpu import GaussianProcess

    r = np.random.RandomState(seed)
    x = r.uniform(size=(n, D))
    y = np.sin(3 * x[:, 0]) + x[:, 1]
    return GaussianProcess(x, y, mean=mean, nugget=nugget)


def _prog_gp_nlp_value_and_grad():
    from mogp_tpu.models.gp import gp_nlp

    gp = _gp(mean="x[0]")
    raw = jnp.zeros(gp.n_params)
    fns = []
    for ladder in (False, "single"):
        fns.append(jax.make_jaxpr(jax.value_and_grad(
            lambda r, ladder=ladder: gp_nlp(r, gp._data, gp.kernel,
                                            gp.nugget_type,
                                            sparse_ladder=ladder)))(raw))
    return fns


def _prog_gp_predict():
    from mogp_tpu.models.gp import gp_fit, gp_predict

    gp = _gp(mean="x[0]")
    raw = jnp.zeros(gp.n_params)
    arts = gp_fit(raw, gp._data, gp.kernel, gp.nugget_type)
    q = jnp.asarray(np.random.RandomState(1).uniform(size=(5, 2)))
    dm = jnp.asarray(gp.get_design_matrix(np.asarray(q)))
    return [jax.make_jaxpr(
        lambda a, t, d: gp_predict(a, gp._data, t, d, gp.kernel,
                                   gp.nugget_type, unc=True,
                                   include_nugget=True, full_cov=full))(
        arts, q, dm) for full in (False, True)]


def _prog_batched_fit():
    from mogp_tpu.models.fitting import _batched_fit_multi, _OPT_LADDER
    from mogp_tpu.models.mogp import _stack_pytrees

    gps = [_gp(seed=s) for s in range(2)]
    data = _stack_pytrees([g._data for g in gps])
    starts = jnp.zeros((2, 3, gps[0].n_params))
    return [jax.make_jaxpr(
        lambda s, d: _batched_fit_multi(s, d, gps[0].kernel, "adaptive", 4,
                                        None, None, _OPT_LADDER))(
        starts, data)]


def _prog_batched_refit():
    from mogp_tpu.models.fitting import _batched_refit
    from mogp_tpu.models.mogp import _stack_pytrees

    gps = [_gp(seed=s) for s in range(2)]
    data = _stack_pytrees([g._data for g in gps])
    return [jax.make_jaxpr(
        lambda r, d: _batched_refit(r, d, gps[0].kernel, "adaptive"))(
        jnp.zeros((2, gps[0].n_params)), data)]


def _prog_nuts():
    from mogp_tpu.models.inference import _nuts_single_program

    gp = _gp(nugget="fit")
    data = jax.tree_util.tree_map(lambda x: x[None], gp._data)
    q0 = jnp.zeros((1, 2, gp.n_params))
    keys = jax.random.split(jax.random.PRNGKey(0), 2)[None]
    return [jax.make_jaxpr(
        lambda d, q, k: _nuts_single_program(d, q, k, gp.kernel, "fit", 3, 3,
                                             4, 0.8))(data, q0, keys)]


def _prog_vi():
    from mogp_tpu.models.inference import _vi_run

    gp = _gp(nugget="fit")
    P = gp.n_params
    return [jax.make_jaxpr(
        lambda m, s, k: _vi_run(m, s, k, gp._data, gp.kernel, "fit", 3, 2,
                                0.05))(
        jnp.zeros(P), jnp.full((P,), -2.0), jax.random.PRNGKey(0))]


def _prog_mice_score():
    from mogp_tpu.uq.mice_device import _mice_score_step

    gp = _gp()
    mask = jnp.ones(gp.n)
    cand = jnp.asarray(np.random.RandomState(2).uniform(size=(2, 4, 2)))
    return [jax.make_jaxpr(
        lambda r, c: _mice_score_step(r, gp._data, mask, c, jnp.ones((2, 4)),
                                      1e-6, 1.0, gp.kernel, "adaptive",
                                      True))(jnp.zeros(gp.n_params), cand)]


def _prog_mice_fit():
    from mogp_tpu.uq.mice_device import _mice_fit_step

    gp = _gp()
    return [jax.make_jaxpr(
        lambda s: _mice_fit_step(s, gp._data, jnp.ones(gp.n), gp.kernel,
                                 "adaptive", True, 4, None, None, "single"))(
        jnp.zeros((3, gp.n_params)))]


def _prog_hm_topk():
    from mogp_tpu.models.gp import gp_fit
    from mogp_tpu.models.mogp import _stack_pytrees
    from mogp_tpu.uq.history_matching import _implausibility_topk_tiled

    gps = [_gp(seed=s) for s in range(3)]
    arts = _stack_pytrees([gp_fit(jnp.zeros(g.n_params), g._data, g.kernel,
                                  "adaptive") for g in gps])
    data = _stack_pytrees([g._data for g in gps])
    q = jnp.asarray(np.random.RandomState(3).uniform(size=(16, 2)))
    dm = jnp.zeros((16, 0))
    ones = jnp.ones(3)
    return [jax.make_jaxpr(
        lambda a, d, t: _implausibility_topk_tiled(
            a, d, t, dm, ones, ones, 0.0 * ones, gps[0].kernel, "adaptive",
            2, 8))(arts, data, q)]


def _prog_gkdr():
    from mogp_tpu.uq.dimension_reduction import _gkdr_projection

    r = np.random.RandomState(4)
    X = jnp.asarray(r.uniform(size=(10, 3)))
    Y = jnp.asarray(r.uniform(size=(10, 1)))
    return [jax.make_jaxpr(_gkdr_projection)(X, Y, 1.0, 1.0, 1e-8)]


def _prog_maximin():
    from mogp_tpu.uq.experimental_design import _min_pdist_batch

    return [jax.make_jaxpr(_min_pdist_batch)(jnp.zeros((2, 5, 3)))]


def _prog_smc_implausibility():
    from mogp_tpu import fit_GP_MAP
    from mogp_tpu.uq.smc import _make_implausibility_fn

    gp = _gp()
    np.random.seed(0)
    fit_GP_MAP(gp, n_tries=1, maxiter=3)
    fn = _make_implausibility_fn(gp, 0.5, 0.1, 0.0, True)
    return [jax.make_jaxpr(fn)(jnp.zeros((4, 2)))]


PROGRAMS = {
    "gp_nlp_value_and_grad": _prog_gp_nlp_value_and_grad,
    "gp_predict": _prog_gp_predict,
    "batched_lbfgs_fit": _prog_batched_fit,
    "batched_refit": _prog_batched_refit,
    "nuts": _prog_nuts,
    "vi": _prog_vi,
    "mice_score": _prog_mice_score,
    "mice_fit": _prog_mice_fit,
    "hm_topk_sweep": _prog_hm_topk,
    "gkdr": _prog_gkdr,
    "maximin_score": _prog_maximin,
    "smc_implausibility": _prog_smc_implausibility,
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_contractions_pinned_highest(name):
    found = []
    for closed in PROGRAMS[name]():
        found.extend(unpinned_dots(closed.jaxpr))
    if name in ALLOWLIST:
        return
    assert not found, "unpinned dot_general in {}: {}".format(name, found)


def test_audit_detects_an_unpinned_product():
    """The audit itself: a plain ``x @ y`` is flagged, a pinned one not."""
    x = jnp.ones((3, 3))
    plain = jax.make_jaxpr(lambda a: a @ a)(x)
    pinned = jax.make_jaxpr(
        lambda a: jnp.dot(a, a, precision=lax.Precision.HIGHEST))(x)
    assert len(unpinned_dots(plain.jaxpr)) == 1
    assert unpinned_dots(pinned.jaxpr) == []
