"""Quantization formats, scaled casts and quantizable ops."""
