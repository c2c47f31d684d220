"""The plain reference: TVTSv2 in plain PyTorch (model.py) and its
pretraining step with AdamW (train.py). It imports nothing of the program and
takes nothing the program made: the benchmark hands it the seeded weights and
inputs that it hands the program."""
