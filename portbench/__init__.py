"""Benchmark of the PyTorch/CUDA port (``rsvd_kamaneh_raganato_terrana_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once; ``BENCHMARK.json`` at the repository
root lists the cells and metrics.  Everything that defines the
yardstick (operand generators, trace reduction, peaks and byte counts,
the plain references and the comparison) lives in this folder.
"""
