"""The benchmark of fullycnnspeechenhancement_torch on NVIDIA H100 cards.

Run a cell of BENCHMARK.json from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""
