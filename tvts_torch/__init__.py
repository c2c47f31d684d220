"""PyTorch + CUDA port of tvts_tpu (TVTSv2 video tower, B/16 feature extraction).

Module names mirror `tvts_tpu`, so each file's counterpart is found by path.
The package imports torch and numpy only, never JAX or `tvts_tpu`.
"""
