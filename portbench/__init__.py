"""The benchmark of ``bulklmm_tpu_torch`` on one NVIDIA card.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line. Every piece that belongs to one configuration, traffic mix, cell,
per-layer metric or kernel is a file of its own, found by its name:

- ``configs/<config>.json``: the deployment's sizes and settings;
- ``traffic/<mix>.json``: the entry point, its arguments and the call
  stream, read by the general generator in ``core/cell.py``;
- ``checks/<workload>.json``: what the comparison samples and each
  number's limit;
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``flops/<kernel>.py``: a kernel's operations and bytes from its shapes;
- ``reference/``: the plain float64 reference, which imports nothing of the
  program.
"""
