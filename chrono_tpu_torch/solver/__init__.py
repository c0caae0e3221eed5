"""Solvers: the NSC/DVI many-body stepper (``nsc_pencil``)."""
