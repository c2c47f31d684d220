"""The alias of scripts/zero_ret_TVTSv2_ViT_H_14.py: the config names the arch."""

from tvts_torch.cli.zero_ret import main

if __name__ == "__main__":
    main()
