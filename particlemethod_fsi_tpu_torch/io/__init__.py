"""File formats of the port (counterpart of ``particlemethod_fsi_tpu/io/``)."""

from particlemethod_fsi_tpu_torch.io.data_file import parse_data_file, write_data_file
from particlemethod_fsi_tpu_torch.io.grid_file import (
    GridData,
    read_grid_file,
    write_grid_file,
)
from particlemethod_fsi_tpu_torch.io.vtk_writer import write_vtk_file

__all__ = [
    "GridData",
    "parse_data_file",
    "read_grid_file",
    "write_data_file",
    "write_grid_file",
    "write_vtk_file",
]
