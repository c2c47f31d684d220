"""PyTorch + CUDA port of tvts_tpu (TVTSv2: feature extraction, zero-shot
retrieval, recognition and SSV2 multiple choice, from config files and video
files through the CLIs of `tvts_torch.cli`, and the pretraining step).

Module names mirror `tvts_tpu`, so each file's counterpart is found by path.
The package imports torch, numpy and scipy only, never JAX, `tvts_tpu`,
`regex`, `pandas` or PIL; OpenCV only inside the cv2 decode backend.
"""
