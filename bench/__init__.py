"""The benchmark of the PyTorch and CUDA port (`repro_torch`): one
command runs one cell of `BENCHMARK.json` once (`python3 bench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`)."""
