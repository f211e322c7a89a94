"""PyTorch/CUDA port of the Softermax serving stack.

Mirrors the JAX package ``repro`` module for module; the JAX package stays
the reference. Entry points run on the CUDA card unless the caller passes
``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version.
"""
