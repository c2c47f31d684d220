"""The alias of scripts/run_class_zero.py: tvts_torch.cli.run_class_finetuning
with `--mode zero` (a later `--mode` overrides it, as in the JAX alias)."""

import sys

from tvts_torch.cli.run_class_finetuning import main as _main


def main(argv=None) -> dict:
    return _main(["--mode", "zero", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    main()
