"""Analytic accounting of the model zoo: parameter counts and model FLOPs
(``model_stats``), and per-cell FLOP and byte counts from the op registry
(``analytic``)."""
