"""Layers, parameter specs and losses."""
