"""Data parallel over `torch.distributed` (`mesh.py`)."""
