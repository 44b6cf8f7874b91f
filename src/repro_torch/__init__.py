"""PyTorch/CUDA port of the SIMPLE reproduction (reference: ``repro``).

Imports torch and numpy only — never JAX and never the reference package.
"""
