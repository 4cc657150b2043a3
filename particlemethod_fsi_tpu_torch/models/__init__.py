"""Case builders of the port (counterpart of
``particlemethod_fsi_tpu/models/``): the bench scene and the Turek-Hron
channel."""

from particlemethod_fsi_tpu_torch.models.bench_case import (
    bench_config,
    bench_grid,
    build_case,
)
from particlemethod_fsi_tpu_torch.models.turek import (
    build_turek,
    turek_config,
    turek_grid,
)

__all__ = ["bench_config", "bench_grid", "build_case", "build_turek",
           "turek_config", "turek_grid"]
