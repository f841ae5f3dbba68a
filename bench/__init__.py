"""The serving benchmark of `repro_torch` on one NVIDIA H100.

`python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>` runs one cell of `BENCHMARK.json` once and prints one JSON line.
Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by its name: `configs/<name>.json`,
`traffic/<name>.json`, `metrics/<name>.py`, `limits/<cell>.json`, and
the model family's weight maker and plain reference in
`models/<family>.py`.
"""
