"""Additional single-GP examples on the projectile problem.

Capability counterpart of the reference's ``demos/gp_demos.py`` (basic
fit/predict, kernel + nugget choices, priors + mean function with a
fitted nugget) using this framework's API: every fit below is one batched
L-BFGS program over restarts, and predictions are jitted device
computations.

Run: ``python demos/gp_demos.py``
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import mogp_tpu
from projectile import print_predictions, simulator

n_samples = 20
n_preds = 10


def main():
    # design the simulator inputs: log10 drag in [-5, 1], velocity in
    # [0, 1000] (uniform via the bounds convention; any scipy ppf works)
    ed = mogp_tpu.LatinHypercubeDesign([(-5.0, 1.0), (0.0, 1000.0)])

    np.random.seed(857362)
    inputs = ed.sample(n_samples)
    targets = np.array([simulator(p) for p in inputs])
    predict_points = ed.sample(n_preds)

    # -- Example 1: defaults (squared exponential, adaptive nugget) ----
    print("Example 1: Basic GP")
    gp = mogp_tpu.GaussianProcess(inputs, targets)
    gp = mogp_tpu.fit_GP_MAP(gp)
    means, variances, _ = gp.predict(predict_points)
    print_predictions(predict_points, means, variances)

    # -- Example 2: Matern kernel, fixed nugget, fit-from-args --------
    # constructor arguments can go straight to the fitting entry point
    print("Example 2: Matern kernel")
    gp_matern = mogp_tpu.fit_GP_MAP(
        inputs, targets, kernel="Matern52", nugget=1.0e-8
    )
    res = gp_matern.predict(predict_points)
    print_predictions(predict_points, res.mean, res.unc)

    # -- Example 3: mean function + explicit priors, fitted nugget ----
    # linear mean (3 coefficients) with a normal prior; lognormal priors
    # on the correlation lengths; inverse-gamma on the covariance scale;
    # gamma on the fitted nugget
    print("Example 3: Mean function and priors")
    priors = mogp_tpu.Priors.GPPriors(
        mean=mogp_tpu.Priors.MeanPriors(
            mean=np.zeros(3), cov=np.ones(3)
        ),
        corr=[
            mogp_tpu.Priors.LogNormalPrior(1.0, 1.0),
            mogp_tpu.Priors.LogNormalPrior(1.0, 1.0),
        ],
        cov=mogp_tpu.Priors.InvGammaPrior(1.0, 1.0),
        nugget=mogp_tpu.Priors.GammaPrior(1.0, 1.0),
        nugget_type="fit",
    )
    gp_map = mogp_tpu.GaussianProcess(
        inputs, targets, mean="x[0]+x[1]", priors=priors, nugget="fit"
    )
    gp_map = mogp_tpu.fit_GP_MAP(gp_map)

    # calling the GP directly returns just the predictive means
    pred_means = gp_map(predict_points)
    print_predictions(predict_points, pred_means, [""] * n_preds)


if __name__ == "__main__":
    main()
