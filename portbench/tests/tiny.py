"""Tiny configurations for the CPU tests: the cells' shapes in miniature,
run through the program's plain PyTorch path."""

NARROW = {"name": "tiny-narrow", "prime": 1073741789,
          "nrows": 300, "ncols": 200, "row_draws": 6, "value_low": 1,
          "value_high": 1 << 20,
          "solver": "block_lanczos_tpu_torch.models.lanczos:BlockLanczos"}
GF2 = {"name": "tiny-gf2", "prime": 2, "nrows": 600,
       "ncols": 400, "row_draws": 9, "value_low": 1, "value_high": 1 << 20,
       "solver": "block_lanczos_tpu_torch.models.lanczos_gf2:BlockLanczosGF2"}
TRAFFIC = {NARROW["name"]: {"n": 4}, GF2["name"]: {"n": 32}}
CONFIGS = (NARROW, GF2)


def run(config, seed=2**31 + 11, seconds=0.0):
    """One untraced run of the tiny cell on the CPU."""
    import time

    from portbench import harness
    return harness.run_cell(config, TRAFFIC[config["name"]], seed, seconds,
                            False, "cpu", time.perf_counter())
