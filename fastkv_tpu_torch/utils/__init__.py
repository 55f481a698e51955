"""Helpers of the PyTorch port: checkpoint fixtures, timing, profiling, guards."""
