"""The benchmark of the PyTorch and CUDA port of CLIMBER++ (``repro_torch``):
one command runs one cell once (``python3 climbench/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>``); see ``README.md``."""
