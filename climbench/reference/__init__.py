"""The plain reference the benchmark holds the program's answers against:
plain PyTorch and numpy, importing nothing of the program."""
