"""Functional quantized operators: packing, GEMM, conv, pooling."""
