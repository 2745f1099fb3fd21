"""Operation and byte counts, and the chip's peaks, that the per-layer
metrics divide by. Frozen here, apart from the program."""
