"""The benchmark of the PyTorch and CUDA port (`diffusion_llm_rs_tpu_torch`).

`BENCHMARK.json` at the root names the cells; each pairs a configuration
(`configs/<name>.json`) with a traffic mix (`traffic/<name>.json`), and
each metric is read by `metrics/<name>.py`. `python3 -m bench_port.run`
runs one cell once on the card. The yardstick lives here: the traffic
generator (`traffic.py`), the seeded inputs (`seeds.py`, `model.py`), the
plain reference and the comparison that decides `correct` (`reference.py`,
`check.py`, `limits/<cell>.json`), the operation and byte counts with the
H100's peaks (`counts.py`) and the reading of the device trace
(`trace.py`). `system.py` alone imports the program. `calibrate.py` reads
the program's and the control's numbers for the limits, and `sweep.py`
finds an open-loop cell's rate; the benchmark's runs run neither.
CPU tests: `python -m pytest bench_port/tests -q`.
"""
