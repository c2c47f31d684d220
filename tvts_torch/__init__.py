"""PyTorch + CUDA port of tvts_tpu (TVTSv2: feature extraction, zero-shot
retrieval, recognition and SSV2 multiple choice, and the pretraining step).

Module names mirror `tvts_tpu`, so each file's counterpart is found by path.
The package imports torch, numpy and scipy only, never JAX, `tvts_tpu`,
`regex` or `pandas`.
"""
