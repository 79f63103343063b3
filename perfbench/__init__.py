"""The benchmark of the PyTorch and CUDA port (``repro_torch``): training
cells on one H100, driven by ``BENCHMARK.json`` and the data files under
this folder.  ``python3 perfbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once."""
