"""Collision: the uniform grid, the analytic narrowphase and the NSC contact
pipeline (spheres, boxes, triangle meshes; convex shapes wait for
``collision/mpr.py``)."""

from chrono_tpu_torch.collision.cell_list import GridSpec, cell_index
from chrono_tpu_torch.collision.pipeline import (
    SphereShapes, BoxShapes, ConvexShapes, MeshShapes, CollisionModel,
    Contacts, detect_contacts, contact_rows, nsc_step,
)
from chrono_tpu_torch.collision import narrowphase
