"""Observability for the port's serving path — the jax-free part of
flexflow_tpu/obs/: the event bus (``events``), the flight recorder
(``flight``), the metrics registry (``metrics``), request span trees
(``tracing``), drift reports (``drift``) and phase annotations for
``torch.profiler``/NVTX (``annotate``).  ``trace_ingest``,
``exposition``, ``slo`` and ``trace`` come with a later slice."""
