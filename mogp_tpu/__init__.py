"""mogp_tpu: a JAX Gaussian-process emulation + UQ framework.

JAX/XLA re-design with the capabilities of
``mogp-emulator`` (reference: alan-turing-institute/mogp-emulator v0.7.2;
public API surface mirrors ``mogp_emulator/__init__.py:1-16``):

* GP emulators with marginalized-mean MAP fitting and full posterior
  inference (HMC/NUTS) over hyperparameters,
* batched multi-output fitting -- outputs x restarts vmapped into one XLA
  program and sharded over a device mesh,
* the UQ toolchain: experimental design, sequential (MICE) design,
  history matching, gKDR dimension reduction, validation diagnostics.
"""

__version__ = "0.1.0"

# Dtype and precision policy: stated once, in mogp_tpu/config.py --
# float32 by default (float64 under jax_enable_x64), and every contraction
# derived from the kernel matrix pinned to Precision.HIGHEST
# (tests/test_precision_audit.py enforces it).

# module-style aliases matching the reference package layout, where
# ``mogp_emulator.Priors`` / ``mogp_emulator.Kernel`` resolve to submodules
# (bound transitively by ``mogp_emulator/__init__.py:1-16``); user scripts
# written as ``mogp_emulator.Priors.GPPriors(...)`` port over unchanged
from .models import priors as Priors
from .ops import kernels as Kernel

from .models.gp import GaussianProcess, PredictResult
from .models.params import GPParams
from .models.priors import (
    GPPriors,
    GammaPrior,
    InvGammaPrior,
    LogNormalPrior,
    MeanPriors,
    NormalPrior,
    WeakPrior,
)
from .models.fitting import fit_GP_MAP
from .models.mogp import MultiOutputGP
from .models.meanfunction import MeanFunction
from .uq.experimental_design import (
    ExperimentalDesign,
    LatinHypercubeDesign,
    MaxiMinLHC,
    MonteCarloDesign,
)
from .uq.mice_device import DeviceMICEDesign
from .uq.sequential_design import MICEDesign, MICEFastGP, SequentialDesign
from .uq.history_matching import HistoryMatching
from .uq.dimension_reduction import gKDR
from .uq import validation

# beyond the reference: full hyperparameter-posterior inference and
# posterior-predictive utilities (BASELINE north star)
from .models.inference import (
    fit_GP_VI,
    predict_MCMC,
    sample_GP_MCMC,
    sample_MOGP_MCMC,
)
from .uq.smc import smc_history_match

__all__ = [
    "ExperimentalDesign",
    "MonteCarloDesign",
    "LatinHypercubeDesign",
    "MaxiMinLHC",
    "SequentialDesign",
    "DeviceMICEDesign",
    "MICEDesign",
    "MICEFastGP",
    "HistoryMatching",
    "gKDR",
    "validation",
    "GaussianProcess",
    "PredictResult",
    "GPParams",
    "GPPriors",
    "GammaPrior",
    "InvGammaPrior",
    "LogNormalPrior",
    "MeanPriors",
    "NormalPrior",
    "WeakPrior",
    "fit_GP_MAP",
    "MultiOutputGP",
    "MeanFunction",
    "fit_GP_VI",
    "predict_MCMC",
    "sample_GP_MCMC",
    "sample_MOGP_MCMC",
    "smc_history_match",
]
