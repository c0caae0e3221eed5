"""Fluid–solid interaction (counterpart of ``chrono_tpu.fsi``).

Ported so far: ``sph`` (the WCSPH dam break and CRM terrain), ``bce``
(wall and rigid-body markers, their kinematics and the force reduction),
``active`` (active domains and the moving patch) and ``crm_terrain`` (the
terrain patch and its coupling to a multibody vehicle).  ``system``
(rigid bodies in WCSPH), ``flex``, ``tdpf`` and ``surface`` wait for
ROADMAP Queue 1 items 3 and 8.
"""
