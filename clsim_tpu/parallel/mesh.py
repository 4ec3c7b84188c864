"""Multi-device / multi-host scale-out: photon sharding over a jax Mesh.

This replaces the reference's entire distributed stack -- the ZMQ
client/server (private/clsim/I3CLSimServer.cxx), the multi-GPU round-robin
fan-out (I3CLSimModule.cxx:611-636) and the per-device host threads -- with a
single SPMD program: the step batch is sharded along a "photons" mesh axis,
every device propagates its shard independently (zero communication in the
hot loop), and the per-DOM hit-time histograms (and, in the fit path, the
ice-parameter gradients) are combined with a single psum.  The cards of one
host are joined all to all (NVLink), so the mesh is one flat "photons" axis
shaped by the algorithm alone.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..geometry import DetectorGeometry
from ..medium.properties import MediumProperties
from ..ops.spectrum import SpectrumTable
from ..propagate.engine import PropagationResult, propagate
from ..types import PropagationConfig, StepBatch

PHOTON_AXIS = "photons"


def make_mesh(devices=None, axis: str = PHOTON_AXIS) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def make_sharded_propagate(mesh: Mesh, cfg: PropagationConfig,
                           axis: str = PHOTON_AXIS):
    """Build a jitted SPMD propagate: steps sharded over `axis`, histograms
    psum-reduced, result replicated.

    The per-shard RNG key is decorrelated with the device index, so the
    result is deterministic for a fixed (key, mesh size) regardless of how
    the steps were produced.
    """
    def _shard_body(steps, medium, geo, spectra, key):
        key = jax.random.fold_in(key, jax.lax.axis_index(axis))
        res = propagate(steps, medium, geo, spectra, key, cfg)
        return PropagationResult(
            hist=jax.lax.psum(res.hist, axis),
            n_generated=jax.lax.psum(res.n_generated, axis),
            n_hits=jax.lax.psum(res.n_hits, axis),
            weight_hits=jax.lax.psum(res.weight_hits, axis),
            n_iterations=jax.lax.pmax(res.n_iterations, axis))

    sharded = jax.shard_map(
        _shard_body, mesh=mesh,
        in_specs=(P(axis), P(), P(), P(), P()),
        out_specs=P(), check_vma=False)
    return jax.jit(sharded)


def shard_steps(batch: StepBatch, mesh: Mesh, axis: str = PHOTON_AXIS) -> StepBatch:
    """Device-put a slot-assigned step batch with the photon axis sharded."""
    sharding = NamedSharding(mesh, P(axis))
    return StepBatch(*[jax.device_put(jnp.asarray(f), sharding) for f in batch])


# ---------------------------------------------------------------------------
# differentiable ice-model fit (BASELINE config #5)
# ---------------------------------------------------------------------------

class IceFit:
    """Gradient-descent fit of per-layer ice parameters against target hit
    histograms, photons sharded over the mesh and d(loss)/d(params)
    all-reduced by the shard_map transpose (overlapped with the backward
    pass by XLA's scheduler).
    """

    # MediumProperties fields whose perturbation changes the SAMPLING
    # distribution of scatter events: gradients through them need the
    # score-function (likelihood-ratio) term -- the detached estimator is
    # not just noisy but WRONG-SIGNED on the beam workload
    # (test_diff.py:217-229: detached +29.6k vs FD -105.0k)
    SCATTERING_FIT_PARAMS = frozenset({"b400", "anisotropy", "scattering"})

    def __init__(self, mesh: Mesh, cfg: PropagationConfig,
                 geo: DetectorGeometry, spectra: SpectrumTable,
                 learning_rate: float = 1e-3, axis: str = PHOTON_AXIS,
                 max_iterations: int = 64,
                 score_function: Optional[bool] = None,
                 optimizer=None, param_transform=None,
                 loss: str = "chi2", two_sample: bool = False):
        """The loss's forward pass is the engine's expected estimator over a
        bounded, reverse-differentiable loop of `max_iterations`; its
        gradient is engine AD.  `score_function` adds the
        likelihood-ratio term so scattering-parameter gradients are
        unbiased (types.PropagationConfig.score_function; costs sampling
        variance, use larger photon batches per step).  The default (None)
        resolves AUTOMATICALLY on the first step(): ON when fit_params
        contains a scattering parameter (SCATTERING_FIT_PARAMS), OFF for
        absorption-only fits; passing score_function=False while fitting
        scattering parameters emits a loud warning (the detached estimator
        has the wrong sign there).

        `optimizer`: None for plain SGD with `learning_rate`, or any optax
        GradientTransformation (e.g. optax.adam(1e-2)); its state is
        carried across step() calls.  `param_transform`: optional
        jit-traceable callable mapping the fit-parameter dict to
        MediumProperties field overrides -- fit in log-space, fit a layer
        band with the rest pinned to a reference, or build compound fields
        (e.g. an AnisotropyParams from a scalar).

        `loss`: 'chi2' (sum (h-t)^2 / sum t) or 'poisson' (per-bin
        1/(t+1) weights -- approximates the Poisson deviance curvature,
        so weak absorption-dominated tail bins are not drowned by the
        scattering-dominated peak).  `two_sample=True` evaluates the
        residual and the differentiated forward on two INDEPENDENT
        sub-streams of the step key: the gradient becomes an unbiased
        estimator of grad ||E[hist] - target||_w^2, removing the
        Var(hist) penalty term that otherwise biases an
        expectation-matching fit (fresh keys against an averaged target)
        away from truth.  The reported loss stays the plain residual of
        the differentiated sample."""
        self.mesh = mesh
        self.axis = axis
        self.max_iterations = max_iterations
        cfg_grad = cfg if cfg.estimator == "expected" else \
            _replace_cfg(cfg, estimator="expected", soft_binning=True)
        self._cfg_base = cfg_grad
        self._score_function = score_function
        self.cfg = cfg_grad if not score_function else \
            _replace_cfg(cfg_grad, score_function=True)
        self.geo = geo
        self.spectra = spectra
        self.lr = learning_rate
        self.optimizer = optimizer
        self.param_transform = param_transform
        if loss not in ("chi2", "poisson"):
            raise ValueError(f"unknown loss {loss!r}")
        self.loss = loss
        self.two_sample = two_sample
        self._opt_state = None
        # built lazily on the first step(), once fit_params is known, so
        # score_function=None can resolve against the actual parameter set
        self._step = None if score_function is None else self._build()

    def _build(self):
        cfg = self.cfg
        geo = self.geo
        spectra = self.spectra
        axis = self.axis
        lr = self.lr
        max_iter = self.max_iterations

        transform = self.param_transform or (lambda p: p)
        opt = self.optimizer
        loss_kind = self.loss
        two_sample = self.two_sample

        def one_forward(medium, steps, key):
            res = propagate(steps, medium, geo, spectra, key, cfg,
                            max_iterations=max_iter)
            return res.hist

        def loss_fn(fit_params, medium, steps, key, target_hist):
            medium = medium._replace(**transform(fit_params))
            key = jax.random.fold_in(key, jax.lax.axis_index(axis))
            hist = jax.lax.psum(one_forward(medium, steps, key), axis)
            if loss_kind == "poisson":
                w = 1.0 / (target_hist + 1.0)
                scale = 1.0
            else:
                w = 1.0
                scale = jnp.maximum(jnp.sum(target_hist), 1.0)
            r1 = hist - target_hist
            monitor = jnp.sum(w * r1 * r1) / scale
            if not two_sample:
                return monitor
            # independent second sample for the residual factor: grad of
            # sum(w * stop_grad(r2) * r1) is unbiased for
            # grad ||E hist - target||_w^2 (no Var(hist) penalty term)
            key2 = jax.random.fold_in(key, 0x74776f)
            hist2 = jax.lax.stop_gradient(
                jax.lax.psum(one_forward(medium, steps, key2), axis))
            surrogate = jnp.sum(w * jax.lax.stop_gradient(
                hist2 - target_hist) * r1) * (2.0 / scale)
            # value = monitor, gradient = grad(surrogate)
            return surrogate + jax.lax.stop_gradient(monitor - surrogate)

        if opt is None:
            def shard_body(fit_params, medium, steps, key, target_hist):
                loss, grads = jax.value_and_grad(loss_fn)(
                    fit_params, medium, steps, key, target_hist)
                # grads of replicated params are already psum-ed by the
                # shard_map transpose; plain SGD update
                new_params = jax.tree.map(lambda p, g: p - lr * g,
                                          fit_params, grads)
                return new_params, loss

            sharded = jax.shard_map(
                shard_body, mesh=self.mesh,
                in_specs=(P(), P(), P(axis), P(), P()),
                out_specs=(P(), P()), check_vma=False)
            return jax.jit(sharded)

        import optax

        def shard_body_opt(fit_params, opt_state, medium, steps, key,
                           target_hist):
            loss, grads = jax.value_and_grad(loss_fn)(
                fit_params, medium, steps, key, target_hist)
            updates, new_state = opt.update(grads, opt_state, fit_params)
            return optax.apply_updates(fit_params, updates), new_state, loss

        sharded = jax.shard_map(
            shard_body_opt, mesh=self.mesh,
            in_specs=(P(), P(), P(), P(axis), P(), P()),
            out_specs=(P(), P(), P()), check_vma=False)
        return jax.jit(sharded)

    def step(self, fit_params: dict, medium: MediumProperties,
             steps: StepBatch, key, target_hist):
        """One optimizer step; fit_params is a dict of MediumProperties
        field overrides (e.g. {'b400': ..., 'a_dust400': ...}), or -- with
        `param_transform` -- whatever the transform maps to overrides."""
        try:
            eff = self.param_transform(fit_params) \
                if self.param_transform else fit_params
            eff_keys = set(eff)
        except Exception:
            eff_keys = set(fit_params)
        scat = self.SCATTERING_FIT_PARAMS & eff_keys
        if self._step is None:
            # score_function=None: resolve against the actual fit params
            use_sf = bool(scat)
            self.cfg = _replace_cfg(self._cfg_base, score_function=True) \
                if use_sf else self._cfg_base
            self._score_function = use_sf
            self._step = self._build()
        elif scat and not self._score_function \
                and not getattr(self, "_warned_scat", False):
            self._warned_scat = True
            import warnings
            warnings.warn(
                f"fitting scattering parameters {sorted(scat)} with "
                "score_function=False: the detached pathwise estimator's "
                "scattering gradient is biased (wrong-signed on the beam "
                "benchmark, test_diff.py) -- pass score_function=True or "
                "leave it None for auto-selection", UserWarning,
                stacklevel=2)
        if self.optimizer is not None:
            import jax.numpy as _jnp
            if self._opt_state is None:
                self._opt_state = self.optimizer.init(
                    jax.tree.map(_jnp.asarray, fit_params))
            new_params, self._opt_state, loss = self._step(
                fit_params, self._opt_state, medium, steps, key, target_hist)
            return new_params, loss
        return self._step(fit_params, medium, steps, key, target_hist)


def _replace_cfg(cfg: PropagationConfig, **kw) -> PropagationConfig:
    import dataclasses
    return dataclasses.replace(cfg, **kw)
