"""Case builders of the port (counterpart of
``particlemethod_fsi_tpu/models/``; only the bench scene so far)."""

from particlemethod_fsi_tpu_torch.models.bench_case import (
    bench_config,
    bench_grid,
    build_case,
)

__all__ = ["bench_config", "bench_grid", "build_case"]
