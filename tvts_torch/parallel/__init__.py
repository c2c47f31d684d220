"""Data-parallel training over torch.distributed (counterpart of
tvts_tpu/parallel/): process groups (`mesh.py`), the contrastive loss's
collectives (`collectives.py`) and parameter / batch placement
(`partition.py`)."""
