"""Smoothed particle hydrodynamics (counterpart of ``chrono_tpu.fsi.sph``).

Ported so far: the WCSPH dam break's path -- ``kernels``, ``state``,
``system`` (state assembly with fluid, wall and rigid-body BCE markers,
and time-step bounds) and ``pencil`` (``make_sph_advance_pencil``); CRM
terrain -- ``crm`` (parameters, state, stress update) and ``crm_pencil``
(the engine, ``make_crm_substeps_pencil``, ``make_crm_advance_pencil``);
``wcsph.particle_mass``.
"""
