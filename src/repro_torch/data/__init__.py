"""Synthetic calibration data."""
