"""Photon -> MCPE (photoelectron hit) conversion.

Equivalent of I3PhotonToMCPEConverter
(private/clsim/dom/I3PhotonToMCPEConverter.cxx:330-510):

  hitProbability = photon.weight
                 * wavelengthAcceptance(lambda)
                 * angularAcceptance(cos eta)          (eta vs the PMT axis,
                                                        IceCube: straight down)
                 * relative DOM efficiency (calibration)

then accept if hitProbability > U (Bernoulli), MCPE time = photon arrival.
Because the wavelength bias pre-applied the lambda-dependent QE during
sampling, weights stay O(1) (the importance-sampling contract of
SURVEY.md section 2.5).

Two modes:
  * sample_mcpes: faithful accept/reject on photon records
  * expected_hist: multiply the per-DOM time histogram by the expectation of
    the acceptance factors (differentiable path; the angular factor is
    folded in at propagation time via cfg.expected_angular_poly)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..medium.functions import TableParams, eval_polynomial, eval_table


class MCPEBatch(NamedTuple):
    """Accepted photoelectrons (validity-masked fixed capacity)."""
    valid: jnp.ndarray      # (P,) bool
    dom: jnp.ndarray        # (P,) flat DOM index
    time: jnp.ndarray       # (P,) [ns]
    identifier: jnp.ndarray  # (P,) source identifier (particle ref)


def hit_probability(weight, wavelength, cos_impact,
                    wlen_acceptance: TableParams,
                    angular_coeffs, efficiency=1.0):
    """The product formula of I3PhotonToMCPEConverter.cxx:466-475."""
    from .acceptance import angular_factor
    p = weight
    p = p * eval_table(wlen_acceptance, wavelength)
    # plain polynomial (IceCube hole ice) or a cutoff AngularSensitivity
    # (Antares, GetAntaresOMAngularSensitivity.py)
    p = p * angular_factor(angular_coeffs, cos_impact)
    p = p * efficiency
    return p


def sample_mcpes(rec: dict, rec_count, key,
                 wlen_acceptance: TableParams, angular_coeffs,
                 efficiency=1.0, pmt_axis=(0.0, 0.0, -1.0),
                 dom_efficiency=None) -> MCPEBatch:
    """Accept/reject photon records into MCPEs.

    `rec`/`rec_count` are the propagation result's record rings (flattened
    over slots x capacity).  cos(impact) is computed from the photon
    direction against the PMT axis only, matching the reference's standard
    path (position unused when pancaked, …cxx:410-445).

    `efficiency` is the global scale; `dom_efficiency` is an optional
    per-DOM calibration vector (n_doms,) -- the RDE x SPE-compensation
    factor the reference reads from I3Calibration per module
    (I3PhotonToMCPEConverter.cxx:340-387); both multiply the hit
    probability.
    """
    n_slots, cap = rec["time"].shape
    flat = {k: v.reshape(-1) for k, v in rec.items()}
    slot_idx = jnp.repeat(jnp.arange(n_slots), cap)
    pos_in_slot = jnp.tile(jnp.arange(cap), n_slots)
    valid = pos_in_slot < jnp.minimum(rec_count, cap)[slot_idx]

    theta = flat["dir_theta"]
    phi = flat["dir_phi"]
    dx = jnp.sin(theta) * jnp.cos(phi)
    dy = jnp.sin(theta) * jnp.sin(phi)
    dz = jnp.cos(theta)
    ax, ay, az = pmt_axis
    cos_impact = -(dx * ax + dy * ay + dz * az)

    dom = flat["dom"].astype(jnp.int32)
    p = hit_probability(flat["weight"], flat["wavelength"], cos_impact,
                        wlen_acceptance, angular_coeffs, efficiency)
    if dom_efficiency is not None:
        from ..ops.lookup import onehot_gather
        p = p * onehot_gather(jnp.asarray(dom_efficiency, jnp.float32), dom)
    u = jax.random.uniform(key, p.shape)
    accept = valid & (p > u)
    return MCPEBatch(valid=accept,
                     dom=dom,
                     time=flat["time"],
                     identifier=flat["identifier"].astype(jnp.int32))


def sample_mcpes_from_batch(batch, dom_index, key,
                            wlen_acceptance: TableParams, angular_coeffs,
                            efficiency=1.0, pmt_axis=(0.0, 0.0, -1.0),
                            dom_efficiency=None) -> MCPEBatch:
    """Accept/reject a (possibly file-loaded) PhotonBatch into MCPEs: the
    I3CLSimMakeHitsFromPhotons half of the two-phase flow.  `dom_index` is
    the flat DOM index per photon (hits/photons.photon_batch_dom_index)."""
    theta = jnp.asarray(batch.dir_theta)
    phi = jnp.asarray(batch.dir_phi)
    dx = jnp.sin(theta) * jnp.cos(phi)
    dy = jnp.sin(theta) * jnp.sin(phi)
    dz = jnp.cos(theta)
    ax, ay, az = pmt_axis
    cos_impact = -(dx * ax + dy * ay + dz * az)
    p = hit_probability(jnp.asarray(batch.weight),
                        jnp.asarray(batch.wavelength), cos_impact,
                        wlen_acceptance, angular_coeffs, efficiency)
    dom = jnp.asarray(dom_index, jnp.int32)
    if dom_efficiency is not None:
        from ..ops.lookup import onehot_gather
        p = p * onehot_gather(jnp.asarray(dom_efficiency, jnp.float32), dom)
    u = jax.random.uniform(key, p.shape)
    accept = jnp.asarray(batch.valid) & (p > u)
    return MCPEBatch(valid=accept, dom=dom,
                     time=jnp.asarray(batch.time),
                     identifier=jnp.asarray(batch.identifier, jnp.int32))


def merge_mcpes(dom, time, ident, window_ns: float):
    """Merge MCPEs on the same DOM closer than `window_ns` into one entry
    with summed npe, keeping the earliest time (the reference's optional
    hit time-merging, I3PhotonToMCPEConverter.cxx:520+).

    Inputs are host numpy arrays sorted however; returns
    (dom, time, npe, ident) sorted by (dom, time).  The merged entry keeps
    the first contributing photon's identifier.
    """
    dom = np.asarray(dom)
    time = np.asarray(time)
    ident = np.asarray(ident)
    order = np.lexsort((time, dom))
    dom, time, ident = dom[order], time[order], ident[order]
    if len(dom) == 0:
        return dom, time, np.zeros(0, np.int32), ident
    # a new group starts when the DOM changes or the gap exceeds the window
    # (gap measured to the previous hit, matching the reference's sequential
    # coalescing of time-sorted hits)
    new_group = np.ones(len(dom), bool)
    new_group[1:] = (dom[1:] != dom[:-1]) | \
        ((time[1:] - time[:-1]) > window_ns)
    gid = np.cumsum(new_group) - 1
    n_groups = gid[-1] + 1
    npe = np.bincount(gid, minlength=n_groups).astype(np.int32)
    first = np.nonzero(new_group)[0]
    return dom[first], time[first], npe, ident[first]


def expected_mcpe_factor(wlen_acceptance: TableParams, spectrum_x,
                         spectrum_pdf):
    """Spectrum-averaged wavelength acceptance (for scaling per-DOM time
    histograms in the differentiable path, where per-photon wavelengths are
    already marginalized into the histogram).  The angular factor is folded
    in at propagation time via cfg.expected_angular_poly
    (engine.py expected-deposit block), not here."""
    acc = eval_table(wlen_acceptance, spectrum_x)
    w = spectrum_pdf / jnp.sum(spectrum_pdf)
    return jnp.sum(acc * w)


def mcpes_to_numpy(m: MCPEBatch):
    """Compact the accepted hits to host numpy arrays sorted by time (the
    reference sorts MCPE series by time, I3PhotonToMCPEConverter.cxx:520)."""
    valid = np.asarray(m.valid)
    dom = np.asarray(m.dom)[valid]
    time = np.asarray(m.time)[valid]
    ident = np.asarray(m.identifier)[valid]
    order = np.argsort(time, kind="stable")
    return dom[order], time[order], ident[order]


def check_photon_positions(rec, rec_count, collision_radius: float,
                           pancake_factor: float, tolerance_m: float = 0.03,
                           only_warn: bool = True):
    """Spherical-DOM sanity check (I3PhotonToMCPEConverter.cxx:415-455):
    with pancake_factor == 1 every recorded photon must sit ON the
    (oversized) DOM sphere within 3 cm; flattened pancake DOMs skip the
    check.  Record positions here are DOM-relative, so the distance is
    simply |pos|.  Returns the number of off-sphere photons; warns (or
    raises, matching the reference's log_fatal default) when nonzero."""
    if pancake_factor != 1.0:
        return 0
    n_slots, cap = np.asarray(rec["time"]).shape
    count = np.asarray(rec_count)
    valid = (np.arange(cap)[None, :] < np.minimum(count, cap)[:, None])
    px = np.asarray(rec["pos_x"])[valid]
    py = np.asarray(rec["pos_y"])[valid]
    pz = np.asarray(rec["pos_z"])[valid]
    dist = np.sqrt(px * px + py * py + pz * pz)
    bad = int((np.abs(dist - collision_radius) > tolerance_m).sum())
    if bad:
        msg = (f"{bad} recorded photons are not on the DOM sphere "
               f"(radius {collision_radius:.4f} m +- {tolerance_m} m); "
               "worst |dist-R| = "
               f"{np.abs(dist - collision_radius).max():.4f} m")
        if only_warn:
            import warnings
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        else:
            raise RuntimeError(msg)
    return bad
