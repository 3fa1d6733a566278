"""Host-side data tools (the port's copy of ``hydragnn_tpu/tools/``'s
LSMS preparation)."""

from hydragnn_tpu_torch.tools.lsms_tools import (
    compositional_histogram_cutoff,
    compute_formation_enthalpy,
    convert_raw_data_energy_to_gibbs,
)

__all__ = [
    "compositional_histogram_cutoff",
    "compute_formation_enthalpy",
    "convert_raw_data_energy_to_gibbs",
]
