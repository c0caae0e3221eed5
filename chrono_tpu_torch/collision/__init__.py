"""Collision: the uniform grid, the analytic and MPR narrowphases, the NSC
contact pipeline (spheres, boxes, general convex shapes, triangle meshes),
2-D profiles, ray tests and the box decomposition."""

from chrono_tpu_torch.collision.cell_list import (
    GridSpec, build_cell_list, cell_index,
)
from chrono_tpu_torch.collision.pipeline import (
    SphereShapes, BoxShapes, ConvexShapes, MeshShapes, CollisionModel,
    Contacts, detect_contacts, contact_rows, nsc_step,
)
from chrono_tpu_torch.collision import mpr
from chrono_tpu_torch.collision import narrowphase
from chrono_tpu_torch.collision import ray
