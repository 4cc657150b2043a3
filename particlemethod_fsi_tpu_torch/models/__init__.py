"""Case builders of the port (counterpart of
``particlemethod_fsi_tpu/models/``): the scenario builders of
``models/cases.py``, the bench scene and the Turek-Hron channel."""

from particlemethod_fsi_tpu_torch.models.bench_case import (
    bench_config,
    bench_grid,
    build_case,
)
from particlemethod_fsi_tpu_torch.models.cases import (
    cantilever_bar,
    dam_break,
    dam_break_3d,
    dam_break_on_elastic_gate,
    hydroelastic_slab,
    reference_dam,
    rolling_tank,
    turek_hron_channel,
)
from particlemethod_fsi_tpu_torch.models.turek import (
    build_turek,
    turek_config,
    turek_grid,
)

__all__ = ["bench_config", "bench_grid", "build_case", "build_turek",
           "cantilever_bar", "dam_break", "dam_break_3d",
           "dam_break_on_elastic_gate", "hydroelastic_slab", "reference_dam",
           "rolling_tank", "turek_config", "turek_grid",
           "turek_hron_channel"]
