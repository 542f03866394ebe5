"""slambench: the benchmark of the port `orbslam2_tpu_torch` on one card.

    python -m slambench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the root of the checkout names the cells; each cell's
configuration, traffic mix, per-layer metric readers and limits are files
of their own under `slambench/` (`configs/`, `traffic/`, `metrics/`,
`limits/`), found by name.
"""
