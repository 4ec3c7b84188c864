"""The medium-property container: layered ice (or single-layer water) with
differentiable per-layer parameters.

Equivalent of the reference's I3CLSimMediumProperties
(public/clsim/I3CLSimMediumProperties.h:51-135).  Instead of holding abstract
function objects that emit OpenCL code, this is a flat pytree of parameter
leaves; the propagation engine evaluates the closed-form property functions
directly, and all per-layer leaves (b400, a_dust400, delta_tau, anisotropy
magnitudes, ...) are differentiable.

Layer convention (identical to the reference): uniform-height layers in
ascending z, layer index = floor((z_eff - layers_z_start)/layer_height)
clamped to [0, n_layers-1] (propagation_kernel.c.cl:73-76).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from ..constants import C_LIGHT
from ..pytree import register_static_fields
from . import functions as F
from .anisotropy import AnisotropyParams
from .tilt import TiltParams, disabled_tilt


class ScatteringAngleDist(NamedTuple):
    """Mixed simplified-Liu / Henyey-Greenstein scattering angle model
    (IceCube), or pure tabulated phase function mixed with Rayleigh (water).

    For the IceCube model (reference python/MakeIceCubeMediumProperties.py:183):
      cos(theta) ~ liu_fraction * SimplifiedLiu(g) + (1-liu_fraction) * HG(g)
    For water, `table_*` hold a tabulated CDF-inverted distribution instead and
    liu_fraction is the fraction of the *tabulated* component.
    """
    mean_cos: jnp.ndarray       # <cos theta>, shared by Liu and HG parts
    liu_fraction: jnp.ndarray   # fraction of the first (Liu / tabulated) part
    kind: str = "icecube"       # static: "icecube" | "water"
    # water only: tabulated phase function as inverse-CDF table over cos(theta)
    table_cos: Optional[jnp.ndarray] = None    # (n,) support points
    table_cdf: Optional[jnp.ndarray] = None    # (n,) CDF values


register_static_fields(ScatteringAngleDist, ["kind"])


class MediumProperties(NamedTuple):
    # layer geometry (static floats wrapped as arrays; n_layers is static)
    layers_z_start: jnp.ndarray     # z of the bottom of layer 0 [m]
    layer_height: jnp.ndarray       # uniform layer height [m]
    n_layers: int                   # static

    # global absorption/scattering shape parameters (differentiable)
    alpha: jnp.ndarray
    kappa: jnp.ndarray
    abs_A: jnp.ndarray
    abs_B: jnp.ndarray
    abs_D: jnp.ndarray
    abs_E: jnp.ndarray

    # per-layer parameters, shape (n_layers,) (differentiable)
    b400: jnp.ndarray           # geometric scattering coefficient at 400nm [1/m]
    a_dust400: jnp.ndarray      # dust absorption coefficient at 400nm [1/m]
    delta_tau: jnp.ndarray      # temperature correction

    # refractive index (layer-independent, as in every shipped ice model --
    # the reference kernel even #errors out if the group velocity depends on
    # the layer, propagation_kernel.c.cl:525-527)
    ref_index: F.RefIndexParams

    scattering: ScatteringAngleDist
    anisotropy: AnisotropyParams
    tilt: TiltParams

    # misc
    density: jnp.ndarray            # [g/cm^3]
    efficiency: jnp.ndarray         # ice-model efficiency correction
    min_wlen: float = 265.0         # static [nm]
    max_wlen: float = 675.0         # static [nm]

    # water media ("water" kind): the whole wavelength dependence lives in
    # uniform tables and the per-layer coefficients are unit/zero, so the
    # same separable interface serves both medium families
    medium_kind: str = "icecube"    # static: "icecube" | "water" |
                                    #         "separable_table"
    water_wlen_first: float = 290.0  # static [nm]
    water_wlen_step: float = 10.0    # static [nm]
    water_scat_inv: Optional[jnp.ndarray] = None   # (nw,) 1/m
    water_abs_inv: Optional[jnp.ndarray] = None    # (nw,) 1/m

    # "separable_table" media (photonics-format ice, medium/photonics.py):
    # the separable wavelength factors gs/pa/qa/ra are uniform-grid tables
    # on the water_wlen grid instead of the closed-form icecube formulas;
    # the per-layer arrays b400/a_dust400/delta_tau hold the layer modes of
    # the rank decomposition
    fac_gs: Optional[jnp.ndarray] = None    # (nw,)
    fac_pa: Optional[jnp.ndarray] = None
    fac_qa: Optional[jnp.ndarray] = None
    fac_ra: Optional[jnp.ndarray] = None

    # optional tabulated refractive index override (photonics N_PHASE /
    # N_GROUP tables) on the same uniform wavelength grid
    ref_n_table: Optional[jnp.ndarray] = None   # (nw,) phase index
    ref_g_table: Optional[jnp.ndarray] = None   # (nw,) group index

    # ------------------------------------------------------------------
    # property evaluation
    # ------------------------------------------------------------------
    def layer_for_z(self, z_eff):
        idx = jnp.floor((z_eff - self.layers_z_start) / self.layer_height)
        return jnp.clip(idx.astype(jnp.int32), 0, self.n_layers - 1)

    def layer_bottom_z(self, layer):
        return self.layers_z_start + layer.astype(jnp.float32) * self.layer_height

    def _water_table(self, table, wlen_nm):
        """Uniform-grid table eval via ops.lookup.onehot_gather."""
        from ..ops.lookup import onehot_gather
        nw = table.shape[0]
        xi = (wlen_nm - self.water_wlen_first) / self.water_wlen_step
        i0 = jnp.clip(jnp.floor(xi).astype(jnp.int32), 0, nw - 2)
        frac = jnp.clip(xi - i0.astype(jnp.float32), 0.0, 1.0)
        pair = jnp.stack([table[:-1], table[1:]], axis=1)
        rows = onehot_gather(pair, i0)
        return rows[..., 0] + frac * (rows[..., 1] - rows[..., 0])

    def abs_coeffs(self, wlen_nm):
        """Separable wavelength factors (pa, qa, ra) of the inverse absorption
        length: 1/l_abs[layer] = pa*a_dust400[layer] + qa + ra*delta_tau[layer].
        Water media: (0, table(lambda), 0).  Separable-table media (photonics
        format): tabulated rank factors on the uniform wavelength grid."""
        if self.medium_kind == "water":
            zero = jnp.zeros_like(jnp.asarray(wlen_nm))
            return zero, self._water_table(self.water_abs_inv, wlen_nm), zero
        if self.medium_kind == "separable_table":
            return (self._water_table(self.fac_pa, wlen_nm),
                    self._water_table(self.fac_qa, wlen_nm),
                    self._water_table(self.fac_ra, wlen_nm))
        return F.abs_separable_coeffs(self.kappa, self.abs_A, self.abs_B,
                                      self.abs_D, self.abs_E, wlen_nm)

    def scat_coeff(self, wlen_nm):
        """Wavelength factor gs of 1/l_sca[layer] = gs*b400[layer].
        Water media: the particulate+water table (b400 == 1)."""
        if self.medium_kind == "water":
            return self._water_table(self.water_scat_inv, wlen_nm)
        if self.medium_kind == "separable_table":
            return self._water_table(self.fac_gs, wlen_nm)
        return F.scat_separable_coeff(self.alpha, wlen_nm)

    def inv_scattering_length(self, layer, wlen_nm):
        return self.scat_coeff(wlen_nm) * self.b400[layer]

    def inv_absorption_length(self, layer, wlen_nm):
        pa, qa, ra = self.abs_coeffs(wlen_nm)
        return pa * self.a_dust400[layer] + qa + ra * self.delta_tau[layer]

    def phase_ref_index(self, wlen_nm):
        if self.ref_n_table is not None:
            return self._water_table(self.ref_n_table, wlen_nm)
        return F.phase_ref_index(self.ref_index, wlen_nm)

    def group_ref_index(self, wlen_nm):
        if self.ref_g_table is not None:
            return self._water_table(self.ref_g_table, wlen_nm)
        return F.group_ref_index(self.ref_index, wlen_nm)

    def group_velocity(self, wlen_nm):
        return C_LIGHT / self.group_ref_index(wlen_nm)


register_static_fields(MediumProperties,
                       ["n_layers", "min_wlen", "max_wlen", "medium_kind",
                        "water_wlen_first", "water_wlen_step"])


def make_homogeneous_ice(n_layers: int = 2,
                         z_start: float = -1000.0,
                         layer_height: float = 1000.0,
                         b400: float = 0.04,
                         a_dust400: float = 0.006,
                         delta_tau: float = 1.0,
                         mean_cos: float = 0.9,
                         liu_fraction: float = 0.45,
                         alpha: float = 0.90,
                         kappa: float = 1.08,
                         abs_A: float = 6954.0,
                         abs_B: float = 6618.0) -> MediumProperties:
    """A simple uniform ice model (BASELINE config #1's 'homogeneous 2-layer
    ice').  Defaults are representative mid-depth SPICE values."""
    f32 = lambda v: jnp.asarray(v, jnp.float32)
    wv0 = 400.0
    return MediumProperties(
        layers_z_start=f32(z_start),
        layer_height=f32(layer_height),
        n_layers=n_layers,
        alpha=f32(alpha), kappa=f32(kappa),
        abs_A=f32(abs_A), abs_B=f32(abs_B),
        abs_D=f32(wv0 ** kappa), abs_E=f32(0.0),
        b400=jnp.full((n_layers,), b400, jnp.float32),
        a_dust400=jnp.full((n_layers,), a_dust400, jnp.float32),
        delta_tau=jnp.full((n_layers,), delta_tau, jnp.float32),
        ref_index=F.DEFAULT_ICE_REF_INDEX,
        scattering=ScatteringAngleDist(mean_cos=f32(mean_cos),
                                       liu_fraction=f32(liu_fraction)),
        anisotropy=AnisotropyParams(azimuth=f32(0.0), mag_along=f32(0.0),
                                    mag_perp=f32(0.0), enabled=False),
        tilt=disabled_tilt(),
        density=f32(0.9216),
        efficiency=f32(1.0),
    )
