"""Postprocessing exporters: PLY / VTK / OBJ for external visualisation.

Counterpart of ``chrono_tpu/io/export.py``: particle clouds as ASCII PLY
(Blender, MeshLab, Houdini read these directly), grids and heightmaps as
legacy VTK (ParaView), meshes as OBJ, and a PLY frame sequence with its
index file.  Tensors are written through the host; the text is the JAX
package's, character for character.
"""

from __future__ import annotations

import os

import numpy as np

from chrono_tpu_torch.io.writers import _host


def write_ply_points(path: str, points, colors=None, values=None):
    """ASCII PLY point cloud; optional per-point RGB or scalar attribute."""
    points = _host(points).astype(np.float32)
    colors = None if colors is None else _host(colors)
    values = None if values is None else _host(values)
    n = len(points)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        if values is not None:
            f.write("property float value\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i,0]:.6g} {points[i,1]:.6g} {points[i,2]:.6g}"
            if colors is not None:
                c = np.asarray(colors[i]).astype(int)
                row += f" {c[0]} {c[1]} {c[2]}"
            if values is not None:
                row += f" {float(values[i]):.6g}"
            f.write(row + "\n")


def write_obj_mesh(path: str, verts, faces):
    """Wavefront OBJ triangle mesh."""
    verts = _host(verts)
    faces = _host(faces)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6g} {v[1]:.6g} {v[2]:.6g}\n")
        for fc in faces:
            f.write(f"f {fc[0]+1} {fc[1]+1} {fc[2]+1}\n")


def write_vtk_structured_grid(path: str, heights, origin, spacing,
                              name="height"):
    """Legacy-VTK structured points file of a 2-D scalar field (e.g. the SCM
    terrain grid) for ParaView."""
    z = _host(heights)
    nx, ny = z.shape
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\nchrono_tpu grid\nASCII\n")
        f.write("DATASET STRUCTURED_POINTS\n")
        f.write(f"DIMENSIONS {nx} {ny} 1\n")
        f.write(f"ORIGIN {origin[0]} {origin[1]} 0\n")
        f.write(f"SPACING {spacing} {spacing} 1\n")
        f.write(f"POINT_DATA {nx * ny}\n")
        f.write(f"SCALARS {name} float 1\nLOOKUP_TABLE default\n")
        for j in range(ny):
            for i in range(nx):
                f.write(f"{float(z[i, j]):.6g}\n")


def export_particle_sequence(directory: str, frames, prefix="particles"):
    """Write a PLY sequence from a list of (time, positions) pairs and an
    index file."""
    import json

    os.makedirs(directory, exist_ok=True)
    index = []
    for k, (t, pos) in enumerate(frames):
        fname = f"{prefix}_{k:06d}.ply"
        write_ply_points(os.path.join(directory, fname), pos)
        index.append({"index": k, "time": float(t), "file": fname})
    with open(os.path.join(directory, "index.json"), "w") as f:
        json.dump(index, f)
