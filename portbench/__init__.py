"""The benchmark of ``rlo_tpu_torch`` on NVIDIA GPUs: one cell a run.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

See ``portbench/README.md``.
"""
