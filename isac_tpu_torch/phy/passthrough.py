"""Statistical pass-through PHY (counterpart of isac_tpu/phy/passthrough.py;
numpy only, the same draws from the same Generator).

Capability parity with +communication/+phyLayer/gNBPassThroughPhy.m:1-352 and
uePassThroughPhy.m:1-526 : a no-waveform
PHY backend conforming to the same grant/TB interface as the full chain, with
probabilistic block error and emulated CQI variation, so MAC/RLC/scheduler
logic runs at protocol speed (no LDPC, no channel, no device work).

Error model: the link-adaptation design point is BLER 0.1 when the picked MCS
exactly matches the reported CQI (setupSINRtoCQIMappingTable.m — the tables
are BLER-0.1 by construction). The DL table steps ~2 dB per CQI and the BLER
waterfall is about a decade per CQI step at these code rates, so

    BLER = 0.1 * 10^(-(avg_cqi - cqi_required(mcs)))      (new transmission)

clipped to [1e-6, 1]. Each prior HARQ transmission adds ~3 dB of soft-combining
gain => x0.03 per retransmission (gNBPassThroughPhy's fixed packet-error knob,
made CQI/MCS-aware)."""

from __future__ import annotations

import numpy as np

from isac_tpu_torch.mac.tables import cqi_to_mcs

_RETX_GAIN = 0.03


def cqi_required(mcs: int, table: str = "qam64") -> int:
    """Smallest CQI whose scheduler mapping reaches `mcs` (inverse of
    getMCSIndex, schedulerEntity.m:2587-2602)."""
    for cqi in range(1, 16):
        if cqi_to_mcs(cqi, table) >= mcs:
            return cqi
    return 15


def passthrough_bler(mcs: int, avg_cqi: float, tx_count: int,
                     table: str = "qam64") -> float:
    margin = avg_cqi - cqi_required(mcs, table)
    bler = 0.1 * 10.0 ** (-margin) * _RETX_GAIN ** max(tx_count - 1, 0)
    return float(np.clip(bler, 1e-6, 1.0))


def passthrough_crc(rng: np.random.Generator, mcs: int, avg_cqi: float,
                    tx_count: int, table: str = "qam64") -> bool:
    """One Bernoulli CRC draw (gNBPassThroughPhy probabilistic packet error)."""
    return bool(rng.random() >= passthrough_bler(mcs, avg_cqi, tx_count, table))


class CQIWalk:
    """uePassThroughPhy's emulated periodic CQI variation: a bounded per-UE
    random walk around a mean (uePassThroughPhy.m:1-8 'emulates periodic CQI
    variation'), wideband across RBs."""

    def __init__(self, n_ues: int, n_rb: int, mean_cqi: int = 9,
                 lo: int = 2, hi: int = 15, seed: int = 0):
        self.n_rb = n_rb
        self.lo, self.hi = lo, hi
        self.cqi = np.full(n_ues, mean_cqi, np.int32)
        self.rng = np.random.default_rng(seed)

    def report(self, ue: int) -> np.ndarray:
        self.cqi[ue] = np.clip(
            self.cqi[ue] + self.rng.integers(-1, 2), self.lo, self.hi
        )
        return np.full(self.n_rb, self.cqi[ue], np.int32)
