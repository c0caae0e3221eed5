"""Smoothed particle hydrodynamics (counterpart of ``chrono_tpu.fsi.sph``).

Ported: ``kernels``, ``state``; the gather backend on the neighbour lists
of ``dem.neighbors`` -- ``wcsph`` (the WCSPH passes), ``system`` (the
list rebuild, ``sph_substep`` with its three schemes and shiftings,
``make_sph_advance_fn``, state assembly and time-step bounds), ``isph``
(the pressure projection) and ``crm`` (CRM's parameters, state, stress
update and its gather step); the cell-sorted CUDA engines ``pencil``
(``make_sph_advance_pencil``) and ``crm_pencil``
(``make_crm_substeps_pencil``, ``make_crm_advance_pencil``).  Not ported:
``pencil``'s flat cells (``PencilGrid``, ``bin_to_flat*``) and the
non-cubic kernels in the CUDA sweeps (ROADMAP Queue 1 item 6).
"""
