"""The benchmark of deepreadmapper_tpu_torch: `python3 -m drm_bench.run
--workload <cell> --seed <n> --seconds <s> --trace <0|1>` from the root of
a checkout (see harness.py)."""
