"""CPU tests of the benchmark (and one that needs the card, marked gpu)."""
