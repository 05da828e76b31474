"""The benchmark of ``gantron_tpu_torch`` on one CUDA card, or on four.

Run from the root of a checkout:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` names the configurations, cells and metrics; each lives in
a file of its own here, found by its name (``configs/``, ``workloads/``,
``traffic/``, ``metrics/``), and each configuration names the adapter
through which the traffic reaches its program (``programs/``, the only
files here that import a program). ``reference/`` is the plain PyTorch
reference that decides ``correct``; ``counts/`` holds the operation and
byte counts and the card's peaks; ``group.py`` the exchanges of a cell that
runs one process a card. Nothing here imports JAX or the JAX package.
"""
