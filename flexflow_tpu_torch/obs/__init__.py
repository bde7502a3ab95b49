"""Observability for the port — the jax-free part of
flexflow_tpu/obs/: the event bus (``events``), the flight recorder
(``flight``), the metrics registry (``metrics``), request span trees
(``tracing``), drift reports (``drift``), SLO burn rates (``slo``:
``burn_rates`` and ``first_fire_indices``, exported here) and phase
annotations for ``torch.profiler``/NVTX (``annotate``).
``trace_ingest``, ``exposition`` and ``trace`` come with a later
slice."""

from flexflow_tpu_torch.obs.slo import burn_rates, first_fire_indices

__all__ = ["burn_rates", "first_fire_indices"]
