"""History matching: implausibility computation and NROY/RO classification.

Parity re-implementation of ``mogp_emulator/HistoryMatching.py``.  The
expensive part of history matching is the emulator prediction over the
(potentially enormous) query-point set; that runs through the batched /
mesh-sharded predict path (``mogp_tpu.parallel.sharded_predict``) when a
``mesh`` is supplied.  The implausibility arithmetic itself is O(n_obs *
ncoords) elementwise work.

Known reference quirk handled differently: with explicit multi-output
``expectations``, the reference sets ``ncoords`` from
``expectations[0].shape[0]`` (``HistoryMatching.py:649``), which is the
number of *outputs*; here ``ncoords`` is always the number of query
points.
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..models.gp import GaussianProcessBase, PredictResult
from ..models.mogp import MultiOutputGPBase

__all__ = ["HistoryMatching"]

# query count above which a MultiOutputGP implausibility sweep fuses the
# prediction and the implausibility reduction ON DEVICE, streaming back
# only the per-point top-(rank+1) implausibilities.  Below this the
# plain predict-then-reduce path is clearer and transfer cost is
# irrelevant.  A 1e7 x 64-output sweep would move 10 GB of mean/variance
# host-ward; the fused reduction moves (rank+1) * n_query floats (~80 MB
# at rank=1).  The threshold is not yet measured on the GPU.
_DEVICE_SWEEP_MIN_COORDS = 1 << 20


@partial(
    jax.jit,
    static_argnames=("kernel", "nugget_type", "k", "tile"),
)
def _implausibility_topk_tiled(arts, data, testing, dmtest, obs_mean,
                               obs_var, disc, kernel, nugget_type, k, tile):
    """Per-query-point top-``k`` implausibilities over one emulator
    group, computed tile-by-tile on device (``lax.map``).

    Fuses ``gp_predict`` (vmapped over the group's outputs) with the
    variance sum and rank reduction (``HistoryMatching.py:275-286``), so
    the (G, n_query) mean/variance matrices never leave the device.

    :returns: ``(k, n_query)`` top-k per point (descending).
    """
    from ..models.gp import _gp_predict_impl, tiled_query_map

    def one_tile(args):
        t, dm = args
        mu, var = jax.vmap(
            lambda a, d: _gp_predict_impl(
                a, d, t, dm, kernel, nugget_type,
                unc=True, include_nugget=True, full_cov=False,
            )
        )(arts, data)                      # (G, tile) each
        Vs = var + disc[:, None] + obs_var[:, None]
        I = jnp.abs(obs_mean[:, None] - mu) / jnp.sqrt(Vs)
        top, _ = jax.lax.top_k(I.T, k)     # (tile, k) descending
        return top.T                       # (k, tile)

    tops, m = tiled_query_map(testing, dmtest, tile, one_tile)
    # (n_tiles, k, tile) -> (k, n_query)
    return jnp.moveaxis(tops, 1, 0).reshape(k, -1)[:, :m]


class HistoryMatching:
    """Implausibility-based calibration (``HistoryMatching.py:5-703``).

    ``I_i(x0) = |z_i - E(f_i(x0))| / sqrt(Var[z_i - E(f_i(x0))])``;
    query points whose rank-scored implausibility exceeds ``threshold``
    are Ruled Out (RO), the rest are Not Ruled Out Yet (NROY).
    """

    def __init__(self, gp=None, obs=None, coords=None, expectations=None,
                 threshold=3.0, mesh=None):
        self.gp = None
        self.obs = None
        self.coords = None
        self.expectations = None

        self.ndim = None
        self.ncoords = None
        self.threshold = None
        self.I = None
        self.NROY = None
        self.RO = None
        self.mesh = mesh

        if self.check_gp(gp):
            self.set_gp(gp)
        if self.check_obs(obs):
            self.set_obs(obs)
        if self.check_coords(coords):
            self.set_coords(coords)
        if self.check_expectations(expectations):
            self.set_expectations(expectations)
        if self.check_threshold(threshold):
            self.set_threshold(threshold)

        self.update()

    # -- core computation ---------------------------------------------------

    def get_n_obs(self):
        return len(self.obs[0])

    def _select_expectations(self):
        """Choose between provided expectations and GP predictions
        (``HistoryMatching.py:155-196``)."""
        use_coord_gp = self.check_coords(self.coords) and self.check_gp(self.gp)
        use_expectations = self.check_expectations(self.expectations)
        if use_coord_gp and use_expectations:
            raise ValueError(
                "Multiple valid parameter combinations are set. Previously set "
                "parameters can be removed by setting them to None"
            )
        if not use_coord_gp and not use_expectations:
            raise ValueError(
                "Expectations are not provided, nor is a GP and coordinates. "
                "Must set one in order to perform History Matching"
            )
        if self.ncoords is None:
            raise ValueError(
                "ncoords is not set despite a valid parameter combination being found."
            )
        if use_coord_gp:
            if self.mesh is not None:
                if isinstance(self.gp, GaussianProcessBase):
                    from ..parallel.sharded import sharded_predict

                    mu, var = sharded_predict(self.gp, self.coords, mesh=self.mesh)
                    return PredictResult(mean=mu, unc=var, deriv=None)
                if isinstance(self.gp, MultiOutputGPBase):
                    from ..parallel.sharded import sharded_predict_mogp

                    mu, var = sharded_predict_mogp(
                        self.gp, self.coords, mesh=self.mesh
                    )
                    return PredictResult(mean=mu, unc=var, deriv=None)
            return self.gp.predict(self.coords)
        return self.expectations

    def get_implausibility(self, discrepancy=0.0, rank=1):
        """Implausibility for all query points
        (``HistoryMatching.py:197-289``).

        ``rank`` selects the rank-th largest per-output implausibility as
        the multi-output score (0 = maximum, 1 = second largest, ...).
        """
        if not self.check_obs(self.obs):
            raise ValueError(
                "implausibility calculation requires that the observation "
                "value is set. This can be done using the set_obs method."
            )
        assert np.all(np.asarray(discrepancy) >= 0.0), (
            "Model discrepancy variance cannot be negative"
        )
        discrepancy = np.atleast_1d(discrepancy)

        I_dev = self._device_implausibility(discrepancy, rank)
        if I_dev is not None:
            self.I = I_dev
            return self.I

        expectations = self._select_expectations()

        n_obs = self.get_n_obs()
        assert n_obs == np.atleast_2d(expectations[0]).shape[0]
        assert n_obs == np.atleast_2d(expectations[1]).shape[0]

        if n_obs == 1:
            rank = 0
        assert rank >= 0, "rank must be a non-negative integer"
        assert rank < n_obs, "rank must be less than the number of observations"

        means = np.atleast_2d(np.asarray(expectations[0]))
        variances = np.atleast_2d(np.asarray(expectations[1]))

        Vs = np.zeros((n_obs, self.ncoords))
        Vs += variances
        Vs += discrepancy[:, np.newaxis]
        Vs += self.obs[1][:, np.newaxis]
        I = np.abs(self.obs[0][:, np.newaxis] - means) / np.sqrt(Vs)
        # rank-k selection in O(n) via partition (HistoryMatching.py:279-286)
        self.I = np.partition(I, n_obs - rank - 1, axis=0)[n_obs - rank - 1]
        return self.I

    def _device_implausibility(self, discrepancy, rank):
        """Fused device sweep for very large MultiOutputGP coords sets,
        or ``None`` when the plain predict-then-reduce path applies.

        Streams back only each group's per-point top-(rank+1)
        implausibilities (``_implausibility_topk_tiled``); the global
        rank selection over the union of group top-k's equals the
        reference's full ``np.partition`` because the global
        (rank+1)-th largest is always within some group's top-(rank+1).
        With a ``mesh``, the query axis is additionally sharded over
        devices (``shard_map``: each device tiles its own coord shard
        against replicated fit artifacts -- no collectives).
        """
        gp = self.gp
        if not isinstance(gp, MultiOutputGPBase):
            return None
        if not (self.check_coords(self.coords) and self.check_gp(gp)):
            return None
        if self.check_expectations(self.expectations):
            return None
        if self.ncoords is None or self.ncoords < _DEVICE_SWEEP_MIN_COORDS:
            return None
        if gp.get_indices_not_fit():
            return None  # NaN-fill semantics stay on the host path

        n_obs = self.get_n_obs()
        if n_obs != gp.n_emulators:
            return None  # let the host path raise its shape assertion
        if n_obs == 1:
            rank = 0
        assert rank >= 0, "rank must be a non-negative integer"
        assert rank < n_obs, "rank must be less than the number of observations"

        from ..models.gp import _predict_tile_size
        from ..models.mogp import _stack_pytrees

        disc_full = np.broadcast_to(
            np.atleast_1d(discrepancy), (n_obs,)
        ).astype(np.float64)
        coords = gp._process_inputs(self.coords)
        k = rank + 1

        tops = []
        for sig, rel in gp._groups().items():
            ems = [gp.emulators[i] for i in rel]
            em0 = ems[0]
            dtype = em0._data.inputs.dtype
            arts = _stack_pytrees([em._artifacts for em in ems])
            data = _stack_pytrees([em._data for em in ems])
            k_g = min(k, len(ems))
            if self.mesh is None:
                dmtest = em0.get_design_matrix(coords)
                tile = _predict_tile_size(
                    coords.shape[0], None, n_train=em0.n, n_lanes=len(ems)
                ) or min(coords.shape[0], 32768)
                top = _implausibility_topk_tiled(
                    arts, data,
                    jnp.asarray(coords, dtype=dtype),
                    jnp.asarray(dmtest, dtype=dtype),
                    jnp.asarray(self.obs[0][rel], dtype=dtype),
                    jnp.asarray(self.obs[1][rel], dtype=dtype),
                    jnp.asarray(disc_full[rel], dtype=dtype),
                    em0.kernel, em0.nugget_type,
                    k_g, tile,
                )
            else:
                top = self._sharded_group_topk(
                    ems, arts, data, coords, rel, disc_full, k_g, dtype
                )
            tops.append(np.asarray(top, dtype=np.float64)[:, : coords.shape[0]])
        allk = np.concatenate(tops, axis=0)
        return np.partition(allk, allk.shape[0] - rank - 1, axis=0)[
            allk.shape[0] - rank - 1
        ]

    def _sharded_group_topk(self, ems, arts, data, coords, rel, disc_full,
                            k_g, dtype):
        """Mesh-sharded fused sweep for one group: the query axis is
        split over devices with ``shard_map``; each device runs the
        tiled top-k kernel on its shard against replicated artifacts."""
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        from ..models.gp import _predict_tile_size

        mesh = self.mesh
        ax = mesh.axis_names[0]
        n_dev = mesh.shape[ax]
        em0 = ems[0]
        m = coords.shape[0]
        per_dev = -(-m // n_dev)
        tile = _predict_tile_size(
            per_dev, None, n_train=em0.n, n_lanes=len(ems)
        ) or min(per_dev, 32768)
        from ..parallel.sharded import _pad_rows

        padded = n_dev * (-(-per_dev // tile)) * tile
        coords_p = _pad_rows(coords, padded)
        dm_p = em0.get_design_matrix(coords_p)

        kernel, nugget_type = em0.kernel, em0.nugget_type

        def body(a, d, t, dm, om, ov, dc):
            return _implausibility_topk_tiled(
                a, d, t, dm, om, ov, dc, kernel, nugget_type, k_g, tile,
            )

        rep = jax.tree_util.tree_map(lambda _: P(), arts)
        rep_d = jax.tree_util.tree_map(lambda _: P(), data)
        fn = shard_map(
            body, mesh=mesh,
            in_specs=(rep, rep_d, P(ax, None), P(ax, None), P(), P(), P()),
            out_specs=P(None, ax),
            check_vma=False,
        )
        return fn(
            arts, data,
            jnp.asarray(coords_p, dtype=dtype),
            jnp.asarray(dm_p, dtype=dtype),
            jnp.asarray(self.obs[0][rel], dtype=dtype),
            jnp.asarray(self.obs[1][rel], dtype=dtype),
            jnp.asarray(disc_full[rel], dtype=dtype),
        )

    def get_NROY(self, discrepancy=0.0, rank=1):
        """Indices not yet ruled out (``HistoryMatching.py:291-316``)."""
        if self.I is None:
            self.get_implausibility(discrepancy, rank)
        self.NROY = list(np.where(self.I <= self.threshold)[0])
        return self.NROY

    def get_RO(self, discrepancy=0.0, rank=1):
        """Indices ruled out (``HistoryMatching.py:317-342``)."""
        if self.I is None:
            self.get_implausibility(discrepancy, rank)
        self.RO = list(np.where(self.I > self.threshold)[0])
        return self.RO

    # -- setters (``HistoryMatching.py:343-631``) ---------------------------

    def set_gp(self, gp):
        if not self.check_gp(gp):
            raise TypeError("bad input for set_gp - expects a GaussianProcess object.")
        self.gp = gp

    def set_obs(self, obs):
        if not self.check_obs(obs):
            raise TypeError("bad input for set_obs")
        if isinstance(obs, (float, int)):
            self.obs = [np.array([float(obs)]), np.array([0.0])]
        else:
            obs = list(obs)
            if len(obs) == 1:
                self.obs = [np.atleast_1d(np.asarray(obs[0], dtype=np.float64)),
                            np.zeros(np.atleast_1d(obs[0]).shape)]
            else:
                self.obs = [
                    np.atleast_1d(np.asarray(a, dtype=np.float64)) for a in obs
                ]
                assert self.obs[0].shape == self.obs[1].shape, (
                    "observation means and variances must have the same shape"
                )

    def set_coords(self, coords):
        if not self.check_coords(coords) and coords is not None:
            raise TypeError(
                "bad input for set_coords - expected coords in the form of a "
                "list or 1D or 2D ndarray of numerical values"
            )
        if isinstance(coords, np.ndarray):
            if coords.ndim == 1:
                self.coords = np.reshape(coords, [-1, 1])
            else:
                self.coords = coords
        elif isinstance(coords, list):
            self.coords = np.reshape(np.asarray(coords, dtype=np.float64), [-1, 1])
        else:
            self.coords = None
        self.update()

    def set_expectations(self, expectations):
        if not self.check_expectations(expectations) and expectations is not None:
            raise TypeError(
                "bad input for set_expectations - expected a Tuple of 3 ndarrays."
            )
        self.expectations = expectations
        self.update()

    def set_threshold(self, threshold):
        if not self.check_threshold(threshold):
            raise TypeError("bad input for set_threshold - expected a float")
        self.threshold = float(threshold)

    def status(self):
        print(str(self))

    # -- checks -------------------------------------------------------------

    def check_gp(self, gp):
        return isinstance(gp, (GaussianProcessBase, MultiOutputGPBase))

    def check_obs(self, obs):
        if obs is None:
            return False
        if isinstance(obs, (float, int)):
            return True
        try:
            obs_list = list(obs)
        except TypeError:
            raise TypeError(
                "bad input type for HistoryMatching - the specified observations "
                "must be a float or a list of up to two floats/arrays"
            )
        if len(obs_list) > 2 or len(obs_list) == 0:
            raise ValueError(
                "bad input for HistoryMatching, the obs parameter must be a "
                "float or a list of up to two entries"
            )
        if len(obs_list) == 2:
            var = np.atleast_1d(np.asarray(obs_list[1], dtype=np.float64))
            assert np.all(var >= 0.0), "variance in observations cannot be negative"
        return True

    def check_coords(self, coords):
        if coords is None:
            return False
        if isinstance(coords, np.ndarray):
            return coords.ndim <= 2
        if isinstance(coords, list):
            return True
        return False

    def check_expectations(self, expectations):
        if expectations is None:
            return False
        if not isinstance(expectations, (PredictResult, tuple)):
            return False
        if not all(
            (
                isinstance(np.asarray(expectations[0]), np.ndarray),
                isinstance(np.asarray(expectations[1]), np.ndarray),
            )
        ):
            raise TypeError(
                "bad input type for HistoryMatching - expected expectation "
                "values in the form of a PredictResult object with mean and "
                "uncertainty set."
            )
        if not np.asarray(expectations[0]).shape == np.asarray(expectations[1]).shape:
            raise ValueError(
                "bad input for HistoryMatching - mean and variance "
                "expectations do not match"
            )
        assert np.all(np.asarray(expectations[1]) >= 0.0), (
            "all variances must be non-negative"
        )
        return True

    def check_threshold(self, threshold):
        if threshold is None:
            return False
        try:
            test = float(threshold)
            assert test >= 0.0, "threshold must be non-negative"
            return True
        except TypeError:
            return False

    def update(self):
        """Recompute derived ndim/ncoords (``HistoryMatching.py:633-650``)."""
        if self.check_coords(self.coords):
            self.ndim = self.coords.shape[1]
            self.ncoords = self.coords.shape[0]
        elif self.check_expectations(self.expectations):
            # number of query points (last axis for multi-output)
            self.ncoords = np.atleast_2d(np.asarray(self.expectations[0])).shape[-1]

    def __str__(self):
        return (
            "History Matching tools created with:\n"
            + "Gaussian Process: {}\n".format(self.gp)
            + "Observations: {}\n".format(self.obs)
            + "Coords: {}\n".format(
                None if self.coords is None else self.coords.shape
            )
            + "Expectations: {}\n".format(
                None
                if self.expectations is None
                else np.asarray(self.expectations[0]).shape
            )
            + "No. of Input Dimensions: {}\n".format(self.ndim)
            + "No. of Descrete Expectation Values: {}\n".format(self.ncoords)
            + "I_threshold: {}".format(self.threshold)
        )
