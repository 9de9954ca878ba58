"""Meshes, the multi-pod dry-run, and FLOP accounting tools (port of
``repro/launch``)."""
