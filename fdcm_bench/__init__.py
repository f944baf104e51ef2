"""The benchmark of openfdcm_tpu_torch on NVIDIA GPUs: ``python3
fdcm_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
(see ``README.md``)."""
