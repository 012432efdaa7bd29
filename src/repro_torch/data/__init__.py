"""Synthetic data series of the port."""
from repro_torch.data.series import make_dataset, make_queries, random_walk

__all__ = ["make_dataset", "make_queries", "random_walk"]
