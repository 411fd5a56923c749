"""Quantized models."""
