"""The benchmark of predictionio_tpu_torch on one NVIDIA H100 card.

``python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; README.md says
how the files fit together."""
