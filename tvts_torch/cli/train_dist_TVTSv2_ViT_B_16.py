"""The alias of scripts/train_dist_TVTSv2_ViT_B_16.py: the config names the arch."""

from tvts_torch.cli.train_dist_TVTSv2 import main

if __name__ == "__main__":
    main()
