"""Fluid–solid interaction (counterpart of ``chrono_tpu.fsi``).

Ported: ``sph`` (WCSPH, ISPH and CRM on the gather backend, and the
cell-sorted CUDA engines), ``bce`` (wall, rigid-body and scene-builder
markers, their kinematics and the force reduction), ``active`` (active
domains and the moving patch), ``crm_terrain`` (the terrain patch and its
coupling to a multibody vehicle, on either CRM engine) and ``system``
(rigid bodies in WCSPH or ISPH: ``fsi_step``, ``make_fsi_advance_fn``).
``flex``, ``tdpf`` and ``surface`` wait for FEA and the long tail
(ROADMAP Queue 1 item 8).
"""
