"""Smoothed particle hydrodynamics (counterpart of ``chrono_tpu.fsi.sph``).

Ported so far: the WCSPH dam break's path -- ``kernels``, ``state``,
``system`` (state assembly and time-step bounds) and ``pencil``
(``make_sph_advance_pencil``); CRM terrain alone -- ``crm`` (parameters,
state, stress update) and ``crm_pencil`` (``make_crm_advance_pencil``).
"""
