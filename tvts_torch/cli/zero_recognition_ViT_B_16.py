"""The alias of scripts/zero_recognition_TVTSv2_ViT_B_16.py: the config names the arch."""

from tvts_torch.cli.zero_recognition import main

if __name__ == "__main__":
    main()
