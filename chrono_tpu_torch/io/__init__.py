"""Output, export and checkpoint I/O (the ported part of
``chrono_tpu/io``)."""

from chrono_tpu_torch.io.checkpoint import (
    load_checkpoint, load_metadata, save_checkpoint,
)
from chrono_tpu_torch.io.dem_checkpoint import (
    dem_system_from_checkpoint, parse_dem_checkpoint,
)
from chrono_tpu_torch.io.export import (
    export_particle_sequence, write_obj_mesh, write_ply_points,
    write_vtk_structured_grid,
)
from chrono_tpu_torch.io.writers import CSVWriter, FrameWriter, HDF5Writer
