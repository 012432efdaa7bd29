"""Synthetic data series of the port."""
from repro_torch.data.series import (GENERATORS, dna_like, eeg_like,
                                     make_dataset, make_queries, random_walk,
                                     seismic_like, sift_like)

__all__ = ["GENERATORS", "make_dataset", "make_queries", "random_walk",
           "sift_like", "dna_like", "eeg_like", "seismic_like"]
