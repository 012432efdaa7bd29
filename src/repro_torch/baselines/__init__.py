"""The paper's baselines on PyTorch — the counterpart of ``repro.baselines``."""
from repro_torch.baselines.dss import exact_knn, exact_knn_sharded, recall
from repro_torch.baselines.isax import isax_bits, sax_breakpoints, sax_word
from repro_torch.baselines.dpisax import (DPiSAXIndex, build_dpisax,
                                          dpisax_from_arrays, dpisax_knn)
from repro_torch.baselines.tardis import (TardisIndex, build_tardis,
                                          tardis_from_arrays, tardis_knn)

__all__ = ["exact_knn", "exact_knn_sharded", "recall", "sax_word", "sax_breakpoints", "isax_bits",
           "DPiSAXIndex", "build_dpisax", "dpisax_from_arrays", "dpisax_knn",
           "TardisIndex", "build_tardis", "tardis_from_arrays", "tardis_knn"]
