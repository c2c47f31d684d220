"""PyTorch + CUDA port of tvts_tpu (TVTSv2 towers: feature extraction and
zero-shot retrieval, recognition and SSV2 multiple choice).

Module names mirror `tvts_tpu`, so each file's counterpart is found by path.
The package imports torch, numpy and scipy only, never JAX, `tvts_tpu`,
`regex` or `pandas`.
"""
