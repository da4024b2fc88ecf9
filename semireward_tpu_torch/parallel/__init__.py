"""Meshes of ranks over ``torch.distributed`` (``parallel/mesh.py``)."""
