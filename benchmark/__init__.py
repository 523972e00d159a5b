"""The port's benchmark: ``python3 -m benchmark.run --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json``
(see benchmark/run.py).  It imports nothing of JAX or of the JAX package."""
