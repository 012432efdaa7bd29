"""Hand-written CUDA kernels for Hopper, each beside its plain version.

| module          | replaces (JAX package)                  | source              |
|-----------------|-----------------------------------------|---------------------|
| refine_topk     | repro/kernels/refine_topk.py::refine_topk | csrc/refine_topk.cu |
| pivot_rank      | repro/kernels/pivot_rank.py::pivot_rank | csrc/pivot_rank.cu  |
| paa_kernel      | repro/kernels/paa_kernel.py::paa        | csrc/paa.cu         |
| l2              | repro/kernels/l2.py::pairwise_l2        | csrc/l2.cu          |
| l2              | repro/kernels/l2.py::qdots              | csrc/l2.cu          |

The sources build at first use into one ``libclimber_kernels.so``
(``kernels/_lib.py``).  ``ops`` holds the public wrappers, ``ref`` the
oracles.
"""
