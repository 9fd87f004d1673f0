"""PyTorch port of the OOCO co-located serving system for NVIDIA Hopper.

The package mirrors ``repro``'s layout module for module. It imports torch,
numpy and the standard library only: never JAX and nothing of ``repro``.
Entry points run on a CUDA card unless the caller passes ``device="cpu"``.
"""
