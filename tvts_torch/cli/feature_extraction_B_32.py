"""feature_extraction with --arch TVTSv2_B_32 (the alias of
scripts/feature_extraction_TVTSv2_B_32.py)."""

import sys

from tvts_torch.cli import feature_extraction


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    return feature_extraction.main(["--arch", "TVTSv2_B_32", *argv])


if __name__ == "__main__":
    main()
