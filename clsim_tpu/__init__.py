"""clsim_tpu: a JAX differentiable photon-propagation framework with the
capabilities of clsim (IceCube's OpenCL photon tracker).

See SURVEY.md at the repository root for the structural map of the reference
this framework re-implements.
"""

__version__ = "0.1.0"

from .types import PhotonBatch, PropagationConfig, StepBatch  # noqa: F401
from .geometry import (DetectorGeometry, build_geometry,  # noqa: F401
                       hexagonal_geometry, single_string_geometry)
from .medium.properties import MediumProperties, make_homogeneous_ice  # noqa: F401
from .medium.ice_parser import parse_ppc_ice_model  # noqa: F401
from .medium.antares import make_antares_water  # noqa: F401
