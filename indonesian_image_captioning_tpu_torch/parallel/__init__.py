"""Data-parallel training over ``torch.distributed`` (``core/meshes.py``)."""
