"""Numeric ops of the port (torch; CUDA kernels under ``kernels/``)."""
