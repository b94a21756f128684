"""End-to-end UQ tutorial: design -> simulate -> fit -> validate -> calibrate.

Walks the same workflow as the reference tutorial
(``mogp_emulator/demos/tutorial.py``; docs ``docs/intro/overview.rst``)
on the projectile problem, using this framework:

1. Latin Hypercube experimental design over (log drag, launch velocity)
2. run the simulator at the design points
3. fit a GP surrogate by batched MAP (all restarts in one XLA program)
4. validate with standard errors
5. history-match against an observed distance (NROY set)
6. go beyond the reference: full NUTS posterior over the hyperparameters
   and an SMC sweep that samples the NROY region directly.

Run: ``python demos/tutorial.py``
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import mogp_tpu
import mogp_tpu.uq.validation as validation
from projectile import print_results, simulator


def main():
    np.random.seed(57)

    # 1. experimental design
    lhd = mogp_tpu.LatinHypercubeDesign([(-5.0, 1.0), (0.0, 1000.0)])
    n_simulations = 50
    simulation_points = lhd.sample(n_simulations)
    simulation_output = np.array([simulator(p) for p in simulation_points])

    # 2-3. fit surrogate with MAP (batched restarts)
    # standardize=True rescales targets to zero mean / unit variance
    # internally: the raw distances span ~1e4 m, which keeps the fit
    # well-conditioned in float32 (the default accelerator dtype)
    gp = mogp_tpu.GaussianProcess(
        simulation_points, simulation_output, nugget="fit", standardize=True
    )
    gp = mogp_tpu.fit_GP_MAP(gp, n_tries=10)

    print("Correlation lengths = {}".format(gp.theta.corr))
    print("Sigma = {}".format(np.sqrt(gp.theta.cov)))
    print("Nugget = {}".format(np.sqrt(gp.theta.nugget)))

    # 4. validation
    n_valid = 10
    validation_points = lhd.sample(n_valid)
    validation_output = np.array([simulator(p) for p in validation_points])
    _, var, _ = gp.predict(validation_points)
    errors, idx = validation.standard_errors(
        gp, validation_points, validation_output
    )
    print_results(validation_points[idx], errors, var[idx])

    # 5. history matching on a dense sweep
    n_predict = 10000
    prediction_points = lhd.sample(n_predict)
    hm = mogp_tpu.HistoryMatching(
        gp=gp, coords=prediction_points, obs=[2000.0, 400.0]
    )
    nroy_points = hm.get_NROY()
    print(
        "Ruled out {} of {} points".format(
            n_predict - len(nroy_points), n_predict
        )
    )

    # 6a. full posterior over hyperparameters (beyond the reference)
    from mogp_tpu.models.inference import sample_GP_MCMC

    mcmc = sample_GP_MCMC(
        gp, n_samples=200, n_warmup=200, n_chains=2,
        theta0=gp.theta.get_data(),
    )
    print(
        "NUTS hyperparameter posterior: R-hat = {}, ESS = {}".format(
            np.round(mcmc.rhat, 3), np.round(mcmc.ess, 0)
        )
    )

    # 6b. SMC sampling of the NROY region (beyond the reference)
    from mogp_tpu.uq.smc import smc_history_match

    smc = smc_history_match(
        gp,
        obs=[2000.0, 400.0],
        bounds=[[-5.0, 1.0], [0.0, 1000.0]],
        n_particles=2048,
        n_stages=8,
        seed=0,
    )
    print(
        "SMC: {} particles concentrated in NROY (fraction {:.2f})".format(
            len(smc.particles), smc.nroy_fraction
        )
    )


if __name__ == "__main__":
    main()
