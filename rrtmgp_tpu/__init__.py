"""rrtmgp_tpu — RTE+RRTMGP radiative transfer in JAX.

A from-scratch JAX/XLA implementation with the capabilities of
CliMA/RRTMGP.jl (reference mounted at /root/reference): RRTMGP k-distribution
gas optics, cloud/aerosol optics, and RTE longwave/shortwave solvers — pure
functions over pytree states, batched (g-point x column) compute,
``lax.scan`` vertical recurrences, and column sharding over device meshes.
"""

from .parameters import RRTMGPParameters, pow_fast
from .angular import angular_discretization
from .models.gray import (
    GrayAtmosphericState,
    GrayOpticalThicknessOGorman2008,
    GrayOpticalThicknessSchneider2004,
    compute_gray_heating_rate,
    gray_lw_equilibrium,
    setup_gray_as_pr_grid,
    solve_gray_lw,
    solve_gray_sw,
    update_profile_lw,
)

from .states import (
    AerosolState,
    AtmosphericState,
    CloudState,
    LwBCs,
    SwBCs,
    Vmr,
    VmrGM,
    compute_col_gas,
    compute_relative_humidity,
    get_vmr,
)
from .models.rrtmgp import (
    FluxLW,
    FluxSW,
    solve_chunked,
    solve_lw,
    solve_sw,
)
from .api import (
    AllSkyRadiation,
    AllSkyRadiationWithClearSkyDiagnostics,
    ClearSkyRadiation,
    GrayRadiation,
    LookupBundle,
    RRTMGPGridParams,
    RRTMGPSolver,
    aerosol_names,
    domain_view,
    gas_names_sw,
    lookup_tables,
)

__version__ = "0.1.0"
