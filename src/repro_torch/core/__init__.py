"""Quantization primitives, precision policy and knapsack selection."""
