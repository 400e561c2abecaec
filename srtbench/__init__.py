"""srtbench: the benchmark of the PyTorch and CUDA port (``srt_tpu_torch``).

``python3 -m srtbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that measures (traffic, statistics, peaks, work
counts, trace reading, the plain reference and the comparison that
decides ``correct``) lives here and imports nothing of the JAX package;
from the port it takes only the system under test and its kernel names.
"""
