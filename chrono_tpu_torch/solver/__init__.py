"""Solvers: the NSC/DVI many-body stepper (``nsc_pencil``), the multibody
core's dense direct Schur solve (``direct``), the VI solvers (``vi``:
APGD, BB, ADMM, projected Jacobi), the Krylov solvers (``krylov``: CG,
BiCGStab, MINRES, GMRES), the cone projector (``projection``) and the
Schur-complement operators (``descriptor``)."""
