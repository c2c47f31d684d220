"""The v1 SSV2 downstream stack (counterpart of tvts_tpu/downstream/): the
fine-tuning classifier, its layer-decayed optimizer and steps, the
classification dataset with RandAugment, mixup and random erasing, and
zero-shot video-to-video retrieval, as scripts/run_class_finetuning.py runs
them (tvts_torch/cli/run_class_finetuning.py)."""
