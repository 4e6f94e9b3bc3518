"""Metrics and observability surfaces: per-cell KPIs (kpi.py), the grant /
CSI / BLER logs and the MAC PCAP writer (logger.py). Result persistence
(the reference's persist.py) is not ported yet."""
