"""The benchmark of the PyTorch and CUDA port (fastdnn_tpu_torch).

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json once on one CUDA device and prints its
result line (run.py).  Everything that belongs to one configuration, one
traffic mix, one cell or one metric is a file of its own, found by name:

  configs/<config>.json     the net's sizes, source and assumptions, and
                            under "net" the net module it names
  nets/<net>.py             a net: its weights' draw, the program's
                            set-up, the plain reference and the work of
                            each layer (spec.net; feedforward by default)
  kernels/<kernel>.json     a kernel the built-in table does not name:
                            its symbol and layer (kernel_table.py)
  traffic/<mix>.json        a mix's parameters, read by generate.py: its
                            entry and its input parts
  entries/<entry>.py        the closed-loop caller of one public entry of
                            the program (caller.py holds what they share)
  inputs/<part>.py          one part of a mix's inputs, made from the seed
  checks/<cell>.json        the limits of the cell's comparison, with the
                            readings they were set from (controls.py)
  metrics/<metric>.py       a reader, `read(run) -> float | None`

A new cell is a BENCHMARK.json entry, a checks file and, for a new mix, a
traffic file; a new net, entry, input part or metric is a new module (and,
for a metric, an entry); a new kernel's name is a kernel file.  The shared
yardsticks live once: the feed-forward net's plain reference and the
comparison (reference/), the kernel-to-layer table (kernel_table.py), the
roofline and peak arithmetic (roofline.py), the trace's interval
arithmetic (timeline.py), and the seeds, features, lengths and masks
(generate.py).  Only program.py and the net modules import the program;
no reference imports anything of it.
"""
