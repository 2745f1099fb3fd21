"""Plain references: float32 PyTorch, no kernel, cache or batching of the
program under test. Nothing here imports the program."""
