"""Quantization parameters and requantization numerics."""
