"""GeoFF reproduction, PyTorch/CUDA port: federated serverless workflows
whose steps run on NVIDIA GPUs.

Mirrors ``repro`` (the JAX package) module for module; imports neither
``jax`` nor ``repro``.
"""
