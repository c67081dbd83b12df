"""Application case studies of the port (the paper's PETSc SpMV)."""
