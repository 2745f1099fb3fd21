"""The port's benchmark: a harness driven by data (see bench/README.md)."""
