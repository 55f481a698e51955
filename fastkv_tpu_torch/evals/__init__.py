"""Accuracy evals of the PyTorch port: LongBench, RULER, needle in a haystack."""
