"""Carrier numerology: PRB tables, OFDM info, TDD pattern parsing.

Capability parity with (reference file:line):
- +communication/determinePRB.m:1-72   — TS 38.101 Table 5.3.2-1/2 BW x SCS -> NRB
- +parameters/+baseStation/gNBParameters.m:131-182 — derived numRBs / slotDuration /
  numSlotsFrame / tddConfig ('DDDSU' regex parse)
- MATLAB nrOFDMInfo — Nfft / sample rate / per-symbol CP lengths (TS 38.211 §5.3.1)
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

# TS 38.101-1 Table 5.3.2-1 (FR1) / 38.101-2 Table 5.3.2-1 (FR2): {BW_MHz: {SCS_kHz: NRB}}
PRB_TABLE_FR1 = {
    5: {15: 25, 30: 11},
    10: {15: 52, 30: 24, 60: 11},
    15: {15: 79, 30: 38, 60: 18},
    20: {15: 106, 30: 51, 60: 24},
    25: {15: 133, 30: 65, 60: 31},
    30: {15: 160, 30: 78, 60: 38},
    40: {15: 216, 30: 106, 60: 51},
    50: {15: 270, 30: 133, 60: 65},
    60: {30: 162, 60: 79},
    70: {30: 189, 60: 93},
    80: {30: 217, 60: 107},
    90: {30: 245, 60: 121},
    100: {30: 273, 60: 135},
}
PRB_TABLE_FR2 = {
    50: {60: 66, 120: 32},
    100: {60: 132, 120: 66},
    200: {60: 264, 120: 132},
    400: {120: 264},
}


def frequency_range(fc_hz: float) -> str:
    """FR band classification (determinePRB.m:11-17)."""
    if 0.450e6 < fc_hz <= 6.00e9:
        return "FR1"
    if 24.00e9 <= fc_hz <= 52.00e9:
        return "FR2"
    raise ValueError(f"carrier frequency {fc_hz} Hz does not fit 5G NR FR1/FR2")


def determine_prb(fc_hz: float, bandwidth_hz: float, scs_khz: int) -> int:
    """BW x SCS -> number of PRBs per TS 38.101 (determinePRB.m)."""
    fr = frequency_range(fc_hz)
    bw_mhz = int(round(bandwidth_hz / 1e6))
    table = PRB_TABLE_FR1 if fr == "FR1" else PRB_TABLE_FR2
    if bw_mhz not in table:
        raise ValueError(f"bandwidth {bw_mhz} MHz unsupported in {fr}")
    if scs_khz not in table[bw_mhz]:
        raise ValueError(f"SCS {scs_khz} kHz unsupported for {bw_mhz} MHz in {fr}")
    return table[bw_mhz][scs_khz]


@dataclass(frozen=True)
class TDDConfig:
    """Parsed TDD pattern (gNBParameters.m:152-182). Pattern chars: D / S / U."""

    pattern: str
    num_dl_slots: int
    num_ul_slots: int
    num_dl_syms: int  # DL symbols in the special slot
    num_ul_syms: int  # UL symbols in the special slot
    periodicity: int  # slots per DL-UL period

    @property
    def has_special(self) -> bool:
        return "S" in self.pattern

    def slot_type(self, slot: int) -> str:
        """'D' / 'S' / 'U' for absolute slot index (determineSlotType.m)."""
        return self.pattern[slot % len(self.pattern)]

    def dl_ratio(self) -> float:
        return self.pattern.count("D") / len(self.pattern)


def parse_tdd_pattern(pattern: str, num_dl_syms: int = 10, num_ul_syms: int = 2) -> TDDConfig:
    """Parse e.g. 'DDDSU' into slot counts (gNBParameters.m:152-182).

    The special-slot symbol split defaults to 10 DL / 2 UL / 2 guard as in the
    reference's special-slot handling.
    """
    if not re.fullmatch(r"[DSU]+", pattern):
        raise ValueError(f"invalid TDD pattern '{pattern}' (chars must be D/S/U)")
    return TDDConfig(
        pattern=pattern,
        num_dl_slots=pattern.count("D"),
        num_ul_slots=pattern.count("U"),
        num_dl_syms=num_dl_syms if "S" in pattern else 0,
        num_ul_syms=num_ul_syms if "S" in pattern else 0,
        periodicity=len(pattern),
    )


@dataclass(frozen=True)
class OFDMInfo:
    """Equivalent of MATLAB nrOFDMInfo (TS 38.211 §5.3.1, normal CP).

    The long CP occurs on the first symbol of every 0.5 ms half-subframe
    (symbol indices 0 and 7*2^mu within a subframe). For mu >= 1 that is the
    first symbol of slots 0 and 2^(mu-1) of the subframe; for mu = 0 it is
    symbols 0 and 7 of the single 14-symbol slot.
    """

    nfft: int
    sample_rate: float
    scs_hz: float
    symbols_per_slot: int
    slots_per_subframe: int
    cp_short: int  # samples
    cp_long: int  # samples

    @property
    def symbols_per_subframe(self) -> int:
        return self.symbols_per_slot * self.slots_per_subframe

    @property
    def subframe_samples(self) -> int:
        return int(round(self.sample_rate * 1e-3))

    def cp_lengths_slots(self, num_slots: int, first_slot: int = 0) -> np.ndarray:
        """Per-symbol CP lengths, [num_slots, symbols_per_slot], starting at
        absolute slot index `first_slot`."""
        syms_half_sf = 7 * self.slots_per_subframe  # == symbols_per_subframe / 2
        out = np.full((num_slots, self.symbols_per_slot), self.cp_short, dtype=np.int64)
        for s in range(num_slots):
            abs_sym0 = (first_slot + s) * self.symbols_per_slot
            for l in range(self.symbols_per_slot):
                if (abs_sym0 + l) % syms_half_sf == 0:
                    out[s, l] = self.cp_long
        return out

    def symbol_lengths_slots(self, num_slots: int, first_slot: int = 0) -> np.ndarray:
        return self.cp_lengths_slots(num_slots, first_slot) + self.nfft

    def slot_samples(self, slot: int = 0) -> int:
        """Samples in one slot (slot-dependent at mu >= 1 due to the long CP)."""
        return int(self.symbol_lengths_slots(1, first_slot=slot).sum())

    def symbol_starts(self, num_slots: int, first_slot: int = 0) -> np.ndarray:
        """Sample offsets of each OFDM symbol over `num_slots` consecutive slots."""
        lens = self.symbol_lengths_slots(num_slots, first_slot).reshape(-1)
        return np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)


def ofdm_info(n_rb: int, scs_khz: int, nfft: int | None = None) -> OFDMInfo:
    """Compute OFDM numerology the way nrOFDMInfo does.

    Nfft = max(128, 2^ceil(log2(nSC / 0.85))) (85% max occupancy), sample rate
    = Nfft * SCS. Normal CP: 144*Nfft/2048 samples, with the first symbol of
    each half-subframe extended so a half-subframe is exactly 0.5 ms.
    """
    n_sc = n_rb * 12
    if nfft is None:
        nfft = max(128, int(2 ** np.ceil(np.log2(n_sc / 0.85))))
    if nfft < n_sc:
        raise ValueError(f"nfft {nfft} < occupied subcarriers {n_sc}")
    scs_hz = scs_khz * 1e3
    sample_rate = nfft * scs_hz
    mu = int(np.log2(scs_khz // 15))
    slots_per_subframe = 1 << mu
    symbols_per_slot = 14
    cp_short = int(144 * nfft / 2048)
    # Long CP absorbs the residual so each half-subframe is exactly 0.5 ms:
    half_sf_samples = int(round(sample_rate * 5e-4))
    syms_half_sf = 7 * slots_per_subframe
    cp_long = cp_short + (half_sf_samples - syms_half_sf * (nfft + cp_short))
    return OFDMInfo(
        nfft=nfft,
        sample_rate=sample_rate,
        scs_hz=scs_hz,
        symbols_per_slot=symbols_per_slot,
        slots_per_subframe=slots_per_subframe,
        cp_short=cp_short,
        cp_long=cp_long,
    )


@dataclass(frozen=True)
class CarrierConfig:
    """Aggregate carrier config = nrCarrierConfig + derived OFDM info.

    Mirrors gNBParameters derived properties (numRBs :131-139, slotDuration,
    numSlotsFrame) plus the wave info consumed throughout the reference stack.
    """

    fc_hz: float = 3.5e9
    bandwidth_hz: float = 100e6
    scs_khz: int = 30
    n_cell_id: int = 1
    cyclic_prefix: str = "normal"
    nfft_override: int | None = None
    n_rb_override: int | None = None

    _ofdm: OFDMInfo = field(init=False, repr=False, compare=False, default=None)

    def __post_init__(self):
        object.__setattr__(self, "_ofdm", ofdm_info(self.n_rb, self.scs_khz, self.nfft_override))

    @property
    def n_rb(self) -> int:
        if self.n_rb_override is not None:
            return self.n_rb_override
        return determine_prb(self.fc_hz, self.bandwidth_hz, self.scs_khz)

    @property
    def n_sc(self) -> int:
        return self.n_rb * 12

    @property
    def ofdm(self) -> OFDMInfo:
        return self._ofdm

    @property
    def mu(self) -> int:
        return int(np.log2(self.scs_khz // 15))

    @property
    def slots_per_frame(self) -> int:
        return 10 * (1 << self.mu)

    @property
    def slot_duration_s(self) -> float:
        return 1e-3 / (1 << self.mu)

    @property
    def symbols_per_slot(self) -> int:
        return 14

    @property
    def wavelength(self) -> float:
        from isac_tpu_torch.utils.geometry import SPEED_OF_LIGHT

        return SPEED_OF_LIGHT / self.fc_hz
