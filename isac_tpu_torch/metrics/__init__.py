"""Metrics and observability surfaces: per-cell KPIs (kpi.py), the grant /
CSI / BLER logs and the MAC PCAP writer (logger.py), and result persistence
(persist.py: save_result / load_result, the JAX package's file schema). The
figures are in isac_tpu_torch/viz.py, which alone imports matplotlib."""

from isac_tpu_torch.metrics.persist import load_result, save_result

__all__ = ["save_result", "load_result"]
