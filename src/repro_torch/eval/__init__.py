"""Recall evaluation plane on PyTorch — the counterpart of ``repro.eval``.

* :mod:`repro_torch.eval.datasets` — seeded tenant-sharded corpora and
  hard/easy query splits;
* :mod:`repro_torch.eval.ground_truth` — exact-kNN answers (Dss through the
  ``pairwise_l2`` kernel) cached on disk, readable by either package;
* :mod:`repro_torch.eval.metrics` — tie-aware recall@k, MAP, frontier AUC;
* :mod:`repro_torch.eval.target` — the partitions→recall calibration.

The frontier sweep (``run_frontier``, ``build_eval_fleet``) and
``install_recall_target`` need the fleet and wait for its slice.
"""
from repro_torch.eval.datasets import (TenantCorpus, hardness_split,
                                       perturbed_queries, tenant_corpus)
from repro_torch.eval.ground_truth import GroundTruthCache
from repro_torch.eval.metrics import (frontier_auc, mean_average_precision,
                                      recall_at_k)
from repro_torch.eval.target import RecallCalibration

__all__ = [
    "TenantCorpus", "tenant_corpus", "perturbed_queries", "hardness_split",
    "GroundTruthCache", "recall_at_k", "mean_average_precision",
    "frontier_auc", "RecallCalibration",
]
