"""The port's benchmark programs and their hc-test runs (copies of the
repository's examples/ package over dacapo_tpu_torch): benchmarks/<Name>.py
traces a program (`trace`), tests/<Name>.py runs it encrypted against its
plaintext golden (`run`). The CLI (dacapo_tpu_torch/cli.py) finds them by
name."""
