"""The alias of scripts/zero_ssv2_mc_TVTSv2_ViT_B_32.py: the config names the arch."""

from tvts_torch.cli.zero_ssv2_mc import main

if __name__ == "__main__":
    main()
