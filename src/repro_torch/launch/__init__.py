"""Serving steps and the serving launcher."""
