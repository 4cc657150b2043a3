from particlemethod_fsi_tpu_torch.io.grid_file import GridData

__all__ = ["GridData"]
