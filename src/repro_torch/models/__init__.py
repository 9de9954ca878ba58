"""Declarative params + the backbone (PyTorch port)."""
