"""Mixed-precision plans."""
