"""The benchmark of the PyTorch and CUDA port (fastdnn_tpu_torch).

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json once on one CUDA device and prints its
result line (run.py).  Everything that belongs to one configuration, one
traffic mix, one cell or one metric is a file of its own, found by name:

  configs/<config>.json     the net's sizes, source and assumptions
  traffic/<mix>.json        a mix's parameters, read by generate.py: its
                            entry and its input parts
  entries/<entry>.py        the closed-loop caller of one public entry of
                            the program (caller.py holds what they share)
  inputs/<part>.py          one part of a mix's inputs, made from the seed
  checks/<cell>.json        the limits of the cell's comparison, with the
                            readings they were set from (controls.py)
  metrics/<metric>.py       a reader, `read(run) -> float | None`

A new cell is a BENCHMARK.json entry, a checks file and, for a new mix, a
traffic file; a new entry, input part or metric is a new module (and, for
a metric, an entry).  The shared yardsticks live once: the plain
reference and the comparison (reference/), the kernel-to-layer table
(kernel_table.py), the roofline and peak arithmetic (roofline.py), the
trace's interval arithmetic (timeline.py), and the seeds, features,
lengths and masks (generate.py).  Only program.py imports the program.
"""
