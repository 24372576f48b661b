"""The benchmark of `eigentrajectory_tpu_torch` on one NVIDIA H100.

`python3 etbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` and prints one JSON line. Everything that
belongs to one configuration, traffic mix, cell or metric sits in a file of
its own that the harness finds by name:

  configs/<config>.json          the configuration as it is run
  traffic/<mix>.json             a traffic mix, read by `generator.py` and
                                 driven by `loops/<loop>.py`
  workloads/<cell>.json          the limits of the cell's correctness checks
  end_to_end/<metric>.py         an end-to-end metric from the window's records
  layer_metrics/<metric>.py      a per-layer metric from the traced window
  reference/                     the plain reference (imports nothing of the
                                 program), its checkpoint reader and the FLOP
                                 counts of each model

Nothing here imports JAX or the JAX package.
"""
