"""Ops of the port: patch extraction, the MHLA window formulations and the
band op with its CUDA kernel."""
