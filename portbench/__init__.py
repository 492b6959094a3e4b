"""The benchmark of block_lanczos_tpu_torch: whole solves on CUDA cards.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

`BENCHMARK.json` at the checkout's root lists the cells (a configuration
under a traffic mix) and the metrics; the harness finds each configuration
in `configs/<name>.json`, each traffic mix in `traffic/<name>.json` and
each metric's reader in `metrics/<name>.py`.  `reference/` is the plain
NumPy and PyTorch check of every kernel block, `roofline.py` the frozen
byte counts.
Nothing here imports JAX or the JAX package.
"""
