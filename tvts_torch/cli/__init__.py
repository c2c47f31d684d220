"""Command-line twins of the JAX package's scripts/: feature extraction and
the three zero-shot evals, each with `main(argv=None)`, run as
`python -m tvts_torch.cli.<name>`. Each takes the JAX script's flags plus
`--device` (the card by default; `--device cpu` asks for the CPU)."""
