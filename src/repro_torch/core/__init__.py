"""CLIMBER core on PyTorch — the counterpart of ``repro.core``."""
from repro_torch.core.paa import paa, znormalize
from repro_torch.core.pivots import select_pivots, select_pivots_maxmin
from repro_torch.core.signatures import (compute_signatures, decay_weights,
                                         pivot_distances, rank_signature,
                                         set_onehot, set_signature,
                                         weighted_onehot)
from repro_torch.core.distances import (euclidean, overlap_distance,
                                        squared_l2_pairwise, total_weight,
                                        weight_distance)
from repro_torch.core.centroids import CentroidSet, compute_centroids
from repro_torch.core.assignment import assign_groups, assignment_distances
from repro_torch.core.trie import TrieForest, build_forest
from repro_torch.core.packing import ffd_pack
from repro_torch.core.traversal import (TrieDevice, descend, pad_trie,
                                        route_records)
from repro_torch.core.index import (ClimberIndex, PartitionStore, build_index,
                                    build_store, index_from_arrays)
from repro_torch.core.query import (QueryPlan, ShardPlanContext,
                                    candidates_scanned, compact_plan,
                                    default_slot_budget, device_planner_names,
                                    get_device_planner, get_planner, knn_query,
                                    make_recall_target_planner, plan,
                                    plan_adaptive, plan_exhaustive, plan_knn,
                                    plan_od_smallest, planner_names,
                                    register_device_planner, register_planner,
                                    register_recall_target)
from repro_torch.core.refine import (PAD_DIST, default_use_kernel,
                                     dispatch_refine, merge_topk, refine,
                                     refine_sharded, resolve_use_kernel)

__all__ = [
    "paa", "znormalize", "select_pivots", "select_pivots_maxmin",
    "compute_signatures",
    "rank_signature", "set_signature", "set_onehot", "decay_weights",
    "weighted_onehot", "pivot_distances", "euclidean", "squared_l2_pairwise",
    "overlap_distance", "weight_distance", "total_weight",
    "compute_centroids", "CentroidSet", "assign_groups",
    "assignment_distances", "build_forest", "TrieForest", "ffd_pack",
    "TrieDevice", "descend", "pad_trie", "route_records", "ClimberIndex",
    "PartitionStore", "build_index", "build_store", "index_from_arrays",
    "QueryPlan", "ShardPlanContext", "knn_query", "plan", "plan_knn", "plan_adaptive",
    "plan_exhaustive", "plan_od_smallest", "register_planner", "get_planner",
    "planner_names", "make_recall_target_planner", "register_recall_target",
    "register_device_planner", "get_device_planner", "device_planner_names",
    "compact_plan", "default_slot_budget",
    "candidates_scanned", "dispatch_refine", "refine", "refine_sharded",
    "merge_topk",
    "PAD_DIST", "default_use_kernel", "resolve_use_kernel",
]
