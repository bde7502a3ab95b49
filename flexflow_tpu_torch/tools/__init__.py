"""The repo's command-line tools (tools/*.py) on the port, run as
``python -m flexflow_tpu_torch.tools.<name>``: ``ffobs`` (telemetry
reports), ``fflint`` (artifact and rewrite-registry lints), and the
card-only ``mfu_probe`` and ``mfu_variants`` experiments.
``tools/benchdiff.py`` has no copy: it imports nothing of either
package and runs as it is."""
