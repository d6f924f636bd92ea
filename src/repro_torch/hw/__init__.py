"""Hardware profiles for the analytic gain tables."""
