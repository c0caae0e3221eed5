"""Model files, output, export, checkpoints and archives (counterpart of
``chrono_tpu/io``): the URDF, OpenSim and ADAMS parsers, the YAML spec
layer behind ``python -m chrono_tpu_torch.run``, the JSON archive of
carriers, the writers, exporters and checkpoints.  ``fmi.py`` is not
ported yet."""

from chrono_tpu_torch.io.adams import load_adm, parse_adm
from chrono_tpu_torch.io.archive import archive_in, archive_out
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
from chrono_tpu_torch.io.opensim import load_osim, parse_osim
from chrono_tpu_torch.io.urdf import build_from_urdf, parse_urdf
from chrono_tpu_torch.io.writers import CSVWriter, FrameWriter, HDF5Writer
from chrono_tpu_torch.io.yaml_spec import (
    build_dem, build_mbs, load_spec, run_spec,
)
