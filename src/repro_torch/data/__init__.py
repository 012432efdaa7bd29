"""Synthetic data of the port: data series, and the token pipeline of the
model plane."""
from repro_torch.data.series import (GENERATORS, dna_like, eeg_like,
                                     make_dataset, make_queries, random_walk,
                                     seismic_like, sift_like)
from repro_torch.data.tokens import TokenDraws, TokenPipeline

__all__ = ["GENERATORS", "make_dataset", "make_queries", "random_walk",
           "sift_like", "dna_like", "eeg_like", "seismic_like",
           "TokenDraws", "TokenPipeline"]
