"""KPI accumulation and reporting — the metricsVisualizer equivalent (the same
host code as isac_tpu/metrics/kpi.py).

Capability parity with +visualizationTools/metricsVisualizer.m:627-674 (SURVEY
§5.5): per-UE & cell UL/DL throughput, goodput, BLER, peak & achieved spectral
efficiency per 3GPP TR 37.910, plus ECDF extraction (tools/plotECDF.m,
networkSimulation.m:173-232). Counters are plain host integers (metrics are
per-slot scalars; the heavy math stays on device).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class LinkCounters:
    """One direction (DL or UL) of one UE."""

    tx_bits: int = 0  # MAC TB bits transmitted (incl. retransmissions)
    new_tx_bits: int = 0  # first-transmission TB bits (throughput numerator)
    ack_bits: int = 0  # TB bits that passed CRC (MAC throughput)
    goodput_bytes: int = 0  # app-level SDU bytes delivered by RLC
    blk_total: int = 0  # transport blocks transmitted
    blk_err: int = 0  # CRC failures
    harq_drops: int = 0  # TBs abandoned after max retransmissions


@dataclass
class CellMetrics:
    """Per-cell metric collector; finalize() emits the reference KPI surface."""

    n_ues: int
    bandwidth_hz: float
    duration_s: float = 0.0
    dl: list = field(default_factory=list)
    ul: list = field(default_factory=list)
    # optional per-slot traces (log.enable_traces)
    trace: list = field(default_factory=list)

    def __post_init__(self):
        if not self.dl:
            self.dl = [LinkCounters() for _ in range(self.n_ues)]
        if not self.ul:
            self.ul = [LinkCounters() for _ in range(self.n_ues)]

    def _link(self, direction: str, ue: int) -> LinkCounters:
        return (self.dl if direction == "DL" else self.ul)[ue]

    def on_tx(self, direction: str, ue: int, tbs_bits: int, is_retx: bool):
        c = self._link(direction, ue)
        c.tx_bits += tbs_bits
        c.blk_total += 1
        if not is_retx:
            c.new_tx_bits += tbs_bits

    def on_crc(self, direction: str, ue: int, tbs_bits: int, ok: bool):
        c = self._link(direction, ue)
        if ok:
            c.ack_bits += tbs_bits
        else:
            c.blk_err += 1

    def on_sdu_delivered(self, direction: str, ue: int, n_bytes: int):
        self._link(direction, ue).goodput_bytes += n_bytes

    def on_harq_drop(self, direction: str, ue: int):
        self._link(direction, ue).harq_drops += 1

    def log_slot(self, slot: int, **fields):
        self.trace.append({"slot": slot, **fields})

    def finalize(self, peak_se_dl: float = 0.0, peak_se_ul: float = 0.0) -> dict:
        """KPI dict mirroring metricsVisualizer savePerformanceIndicators
        (metricsVisualizer.m:627-674): throughput = ALL MAC TB bits transmitted
        incl. retransmissions (MACTxBytes), goodput = first-transmission MAC
        bits (MACNewTxBytes), achieved SE = sum(goodput)/BW. The ack-based and
        app-level counters are exposed under distinct keys."""
        t = max(self.duration_s, 1e-12)

        def per_ue(cs):
            thr = np.array([c.tx_bits / t / 1e6 for c in cs])  # Mbps
            good = np.array([c.new_tx_bits / t / 1e6 for c in cs])
            acked = np.array([c.ack_bits / t / 1e6 for c in cs])
            app = np.array([c.goodput_bytes * 8 / t / 1e6 for c in cs])
            bler = np.array(
                [c.blk_err / c.blk_total if c.blk_total else 0.0 for c in cs]
            )
            return thr, good, acked, app, bler

        dl_thr, dl_good, dl_ack, dl_app, dl_bler = per_ue(self.dl)
        ul_thr, ul_good, ul_ack, ul_app, ul_bler = per_ue(self.ul)
        bw_mhz = self.bandwidth_hz / 1e6
        return {
            "ueDLThroughputMbps": dl_thr,
            "ueULThroughputMbps": ul_thr,
            "ueDLGoodputMbps": dl_good,
            "ueULGoodputMbps": ul_good,
            "ueDLAckedMbps": dl_ack,  # CRC-passed MAC bits (not in the reference surface)
            "ueULAckedMbps": ul_ack,
            "ueDLAppGoodputMbps": dl_app,  # RLC-delivered SDU bytes (not in the reference surface)
            "ueULAppGoodputMbps": ul_app,
            "ueDLBLER": dl_bler,
            "ueULBLER": ul_bler,
            "cellDLThroughputMbps": float(dl_thr.sum()),
            "cellULThroughputMbps": float(ul_thr.sum()),
            "cellDLGoodputMbps": float(dl_good.sum()),
            "cellULGoodputMbps": float(ul_good.sum()),
            # TR 37.910 achieved SE uses goodput (metricsVisualizer.m:654-671)
            "achievedSEDL": float(dl_good.sum() / bw_mhz) if bw_mhz else 0.0,  # bit/s/Hz
            "achievedSEUL": float(ul_good.sum() / bw_mhz) if bw_mhz else 0.0,
            "peakSEDL": peak_se_dl,
            "peakSEUL": peak_se_ul,
            "harqDropsDL": int(sum(c.harq_drops for c in self.dl)),
            "harqDropsUL": int(sum(c.harq_drops for c in self.ul)),
            "trace": self.trace,
        }


def peak_spectral_efficiency(
    n_layers: int, qm_max: int, duplex_dl_ratio: float, overhead: float = 0.14
) -> float:
    """TR 37.910 §5-style peak SE (bit/s/Hz): layers x Qm x Rmax x (1-OH),
    scaled by the TDD duplex ratio (metricsVisualizer.m:733+)."""
    r_max = 948.0 / 1024.0
    return n_layers * qm_max * r_max * (1.0 - overhead) * duplex_dl_ratio


def ecdf(values: np.ndarray) -> tuple:
    """(sorted values, cumulative probabilities) — plotECDF.m equivalent."""
    v = np.sort(np.asarray(values, np.float64).reshape(-1))
    p = np.arange(1, v.size + 1) / max(v.size, 1)
    return v, p
