"""Deep ExperimentalDesign tests.

Mirrors reference ``tests/test_ExperimentalDesign.py`` (303 LoC):
all five constructor conventions with scipy-PPF value oracles,
constructor failure grid, sampling contracts (range, shapes,
stratification), ``get_method``/``__str__``, and the MaxiMin
min-distance property.
"""

import numpy as np
import pytest
import scipy.spatial.distance
import scipy.stats
from numpy.testing import assert_allclose

from mogp_tpu.uq.experimental_design import (
    ExperimentalDesign,
    LatinHypercubeDesign,
    MaxiMinLHC,
    MonteCarloDesign,
)


# -- constructor conventions --------------------------------------------------


def test_init_count_only():
    ed = MonteCarloDesign(4)
    assert ed.get_n_parameters() == 4
    s = ed.sample(20)
    assert s.shape == (20, 4)
    assert np.all((s >= 0.0) & (s <= 1.0))  # default uniform [0,1]


def test_init_shared_bounds():
    ed = MonteCarloDesign(3, (-2.0, 6.0))
    s = ed.sample(200)
    assert np.all((s >= -2.0) & (s <= 6.0))
    # a uniform draw at u in {0, 1} maps to the bounds exactly
    assert ed.distributions[0](0.0) == pytest.approx(-2.0)
    assert ed.distributions[0](1.0) == pytest.approx(6.0)


def test_init_shared_ppf_callable():
    ppf = scipy.stats.norm(loc=1.0, scale=2.0).ppf
    ed = MonteCarloDesign(2, ppf)
    assert_allclose(ed.distributions[1](0.5), 1.0)
    assert_allclose(ed.distributions[0](0.841344746), 3.0, rtol=1e-6)


def test_init_spec_list_only():
    ed = MonteCarloDesign([(0.0, 1.0), scipy.stats.expon().ppf, None])
    assert ed.get_n_parameters() == 3
    s = ed.sample(50)
    assert np.all(s[:, 1] >= 0.0)  # exponential support
    assert np.all((s[:, 2] >= 0.0) & (s[:, 2] <= 1.0))


def test_init_count_plus_spec_list():
    ed = MonteCarloDesign(2, [(0.0, 2.0), (5.0, 9.0)])
    s = ed.sample(100)
    assert np.all((s[:, 0] >= 0.0) & (s[:, 0] <= 2.0))
    assert np.all((s[:, 1] >= 5.0) & (s[:, 1] <= 9.0))


def test_ppf_values_against_scipy():
    """PPF mapping must be exactly the scipy inverse CDF per column."""
    ed = MonteCarloDesign(
        [scipy.stats.lognorm(s=0.5).ppf, scipy.stats.gamma(a=2.0).ppf]
    )
    u = np.linspace(0.05, 0.95, 7)
    draws = np.stack([u, u], axis=1)
    vals = np.empty_like(draws)
    for j, dist in enumerate(ed.distributions):
        vals[:, j] = dist(draws[:, j])
    assert_allclose(vals[:, 0], scipy.stats.lognorm(s=0.5).ppf(u), rtol=1e-12)
    assert_allclose(vals[:, 1], scipy.stats.gamma(a=2.0).ppf(u), rtol=1e-12)


def test_init_failures():
    with pytest.raises(ValueError):
        ExperimentalDesign()
    with pytest.raises(ValueError):
        MonteCarloDesign(3, (0.0, 1.0), "extra")
    with pytest.raises(ValueError):
        MonteCarloDesign(0)
    with pytest.raises(ValueError):
        MonteCarloDesign(-2)
    with pytest.raises(TypeError):
        MonteCarloDesign("three")
    with pytest.raises(ValueError):
        MonteCarloDesign(3, [(0.0, 1.0), (0.0, 1.0)])  # length mismatch
    with pytest.raises(TypeError):
        MonteCarloDesign(2, 7.5)  # scalar is not a spec
    with pytest.raises((TypeError, ValueError)):
        MonteCarloDesign([(1.0,)])  # malformed bounds pair


def test_base_class_has_no_method():
    ed = ExperimentalDesign(2)
    with pytest.raises(NotImplementedError):
        ed.get_method()
    with pytest.raises(NotImplementedError):
        ed.sample(3)
    assert str(ed) == "Experimental Design with 2 parameters"


def test_method_names_and_str():
    assert MonteCarloDesign(2).get_method() == "Monte Carlo"
    assert LatinHypercubeDesign(2).get_method() == "Latin Hypercube"
    assert "Monte Carlo" in str(MonteCarloDesign(2))
    assert "Latin Hypercube" in str(LatinHypercubeDesign(3))


# -- sampling contracts -------------------------------------------------------


def test_sample_validation():
    ed = MonteCarloDesign(2)
    with pytest.raises(AssertionError):
        ed.sample(0)
    with pytest.raises(AssertionError):
        ed.sample(-5)


def test_sample_nonfinite_ppf_rejected():
    # a PPF producing inf must trip the finite check
    ed = MonteCarloDesign(1, scipy.stats.cauchy().ppf)
    np.random.seed(60)
    # cauchy ppf is finite away from 0/1 but this checks the guard wiring
    s = ed.sample(10)
    assert np.all(np.isfinite(s))
    bad = MonteCarloDesign(1, lambda u: np.inf)
    with pytest.raises(AssertionError):
        bad.sample(3)


def test_lhc_stratification_property():
    """Each parameter has exactly one sample per stratum."""
    np.random.seed(61)
    n = 16
    ed = LatinHypercubeDesign(3)
    s = ed.sample(n)
    for j in range(3):
        strata = np.floor(s[:, j] * n).astype(int)
        assert sorted(strata) == list(range(n))


def test_lhc_with_nonuniform_margins():
    np.random.seed(62)
    ed = LatinHypercubeDesign(2, scipy.stats.norm(loc=0.0, scale=1.0).ppf)
    s = ed.sample(40)
    # stratified normal draws: quantile-transform back must be stratified
    u = scipy.stats.norm.cdf(s)
    for j in range(2):
        strata = np.floor(u[:, j] * 40).astype(int)
        assert sorted(strata) == list(range(40))


def test_maximin_min_distance_at_least_lhc_median():
    """MaxiMin keeps the best of n_tries LHCs: its min pairwise distance
    should beat a typical single LHC draw."""
    np.random.seed(63)

    def min_dist(s):
        d = np.sqrt(((s[:, None] - s[None]) ** 2).sum(-1))
        return d[np.triu_indices_from(d, k=1)].min()

    mm = MaxiMinLHC(2)
    best = min_dist(mm.sample(12, n_tries=40))
    singles = []
    lhc = LatinHypercubeDesign(2)
    for _ in range(15):
        singles.append(min_dist(lhc.sample(12)))
    assert best >= np.median(singles)


def test_maximin_method_name():
    assert "MaxiMin" in MaxiMinLHC(2).get_method() or \
        "Latin" in MaxiMinLHC(2).get_method()


def test_maximin_scorer_choice(monkeypatch):
    """MaxiMin scoring runs on the device whenever an accelerator is
    active, on the native host scorer on a CPU backend, and on the
    device when the host scorer cannot be built; both give the same
    scores."""
    from mogp_tpu import compat, native
    from mogp_tpu.uq import experimental_design as ed

    monkeypatch.setattr(native, "native_usable", lambda: True)
    monkeypatch.setattr(compat, "gpu_usable", lambda: False)
    assert not ed._use_device_scorer()
    monkeypatch.setattr(compat, "gpu_usable", lambda: True)
    assert ed._use_device_scorer()
    monkeypatch.setattr(compat, "gpu_usable", lambda: False)
    monkeypatch.setattr(native, "native_usable", lambda: False)
    assert ed._use_device_scorer()


def test_maximin_device_scores_match_host():
    from mogp_tpu import native
    from mogp_tpu.uq import experimental_design as ed

    cand = np.random.RandomState(3).uniform(size=(40, 12, 3))
    dev = np.asarray(ed._min_pdist_batch(cand))
    ref = np.array([np.min(scipy.spatial.distance.pdist(c)) for c in cand])
    np.testing.assert_allclose(dev, ref, rtol=1e-10)
    if native.native_usable():
        np.testing.assert_allclose(native.maximin_score(cand), ref,
                                   rtol=1e-10)
