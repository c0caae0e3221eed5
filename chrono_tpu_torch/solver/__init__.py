"""Solvers: the NSC/DVI many-body stepper (``nsc_pencil``) and the
multibody core's dense direct Schur solve (``direct``, ``descriptor``)."""
