"""Parameter system — frozen dataclasses mirroring the reference's +parameters tree.

Capability parity (reference file:line):
- +parameters/simulationParameters.m:44-66  — aggregate container, per-cell maps
- +parameters/time.m, log.m, +regionOfInterest/region.m
- +parameters/+baseStation/gNBParameters.m  — incl. derived type/numRBs/tddConfig
- +parameters/+baseStation/+antenna/{ula,upa}.m
- +parameters/+baseStation/+sensing/radar.m
- +parameters/+user/ueParameters.m, +target/targetParameters.m
- +parameters/+schedulingStrategies/parameters.m, +trafficModels/parameters.m,
  +pathLossModels/parameters.m, +channelModels/+communication/cdl.m,
  +city/parameters.m, +building/parameters.m, +wallBlockage/parameters.m
- +simulation/assignCellSimulationParameters.m — flattening into CellParams
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np

from isac_tpu_torch.config.carrier import CarrierConfig, TDDConfig, parse_tdd_pattern

# ----------------------------------------------------------------------------- antennas


@dataclass(frozen=True)
class ULA:
    """Uniform linear array (+antenna/ula.m). num_elements = n_v * polarizations."""

    n_v: int = 8
    spacing: float = 0.5  # in wavelengths unless spacing_meters set
    polarizations: int = 2  # 1 or 2
    spacing_meters: Optional[float] = None  # overrides wavelength-relative spacing

    @property
    def num_elements(self) -> int:
        return self.n_v * self.polarizations

    def element_spacing(self, wavelength: float) -> float:
        return self.spacing_meters if self.spacing_meters is not None else self.spacing * wavelength

    def element_positions(self, wavelength: float) -> np.ndarray:
        """Element coordinates [n, 3] along the y axis (broadside = +x)."""
        d = self.element_spacing(wavelength)
        n = self.num_elements
        y = np.arange(n) * d
        return np.stack([np.zeros(n), y, np.zeros(n)], axis=-1)


@dataclass(frozen=True)
class UPA:
    """Uniform planar array per TS 38.901 panel model (+antenna/upa.m)."""

    n_v: int = 2
    n_h: int = 2
    d_v: float = 0.5
    d_h: float = 0.5
    n_pv: int = 1  # panels vertical
    n_ph: int = 1  # panels horizontal
    d_pv: float = 2.0
    d_ph: float = 2.0
    polarizations: int = 2

    @property
    def num_elements(self) -> int:
        return self.n_v * self.n_h * self.n_pv * self.n_ph * self.polarizations

    def element_positions(self, wavelength: float) -> np.ndarray:
        dv = self.d_v * wavelength
        dh = self.d_h * wavelength
        pos = []
        for pv in range(self.n_pv):
            for ph in range(self.n_ph):
                for v in range(self.n_v):
                    for h in range(self.n_h):
                        for _ in range(self.polarizations):
                            pos.append(
                                [
                                    0.0,
                                    ph * self.d_ph * wavelength + h * dh,
                                    pv * self.d_pv * wavelength + v * dv,
                                ]
                            )
        return np.asarray(pos)


# ----------------------------------------------------------------------------- entities


@dataclass(frozen=True)
class RadarConfig:
    """Sensing detector config (+baseStation/+sensing/radar.m:5-20)."""

    detection_area: tuple = ((50.0, 500.0), (-50.0, 50.0))  # range [m]; velocity [m/s]
    pfa: float = 1e-9
    est_algorithm: str = "FFT"  # 'FFT' | 'MUSIC' (the reference configures but ignores this)
    cfar_guard: tuple = (2, 2)
    cfar_training: tuple = (1, 1)
    # DoA scan sector (radarParams.m:121-125). A ULA is unambiguous only over
    # +-90 deg (mirror az <-> 180-az): scan the full unambiguous front sector
    # and fold truth azimuths in RMSE scoring (ops/sensing/metrics.py).
    azimuth_scan: tuple = (180.0, 1.0)  # (scale deg, granularity deg)
    elevation_scan: tuple = (180.0, 1.0)


@dataclass(frozen=True)
class GNBParams:
    """gNB configuration (+baseStation/gNBParameters.m)."""

    cell_id: int = 1
    position: tuple = (0.0, 0.0, 30.0)
    duplex_mode: str = "TDD"  # 'FDD' | 'TDD'
    scheduling_type: str = "slot"  # 'slot' | 'symbol'
    dl_carrier_freq: float = 3.5e9
    ul_carrier_freq: float = 3.5e9
    dl_bandwidth: float = 100e6
    ul_bandwidth: float = 100e6
    scs_khz: int = 30
    tdd_pattern: str = "DDDSU"
    tdd_special_slot: tuple = (10, 2, 2)  # DL syms, guard, UL syms
    tx_power_dbm: float = 44.0
    rx_gain_db: float = 25.5
    noise_figure_db: float = 6.0
    temperature_k: float = 290.0
    antenna: object = field(default_factory=lambda: ULA(n_v=8, polarizations=2))
    num_harq: int = 16
    radar: RadarConfig = field(default_factory=RadarConfig)

    # An omni TRxP: no boresight, no tilt, no element pattern. A sector's
    # TRxP is SectorGNBParams, which makes these two fields; here they are
    # class attributes, so that the fields of an omni TRxP stay the upstream
    # set one for one.
    boresight_deg = None
    downtilt_deg = 0.0

    @property
    def num_tx_ants(self) -> int:
        return self.antenna.num_elements

    @property
    def num_rx_ants(self) -> int:
        return self.antenna.num_elements

    @property
    def bs_type(self) -> str:
        """Macro/Micro by band (gNBParameters.m:119-129)."""
        return "Macro" if self.dl_carrier_freq <= 6e9 else "Micro"

    @property
    def carrier(self) -> CarrierConfig:
        return CarrierConfig(
            fc_hz=self.dl_carrier_freq,
            bandwidth_hz=self.dl_bandwidth,
            scs_khz=self.scs_khz,
            n_cell_id=self.cell_id,
        )

    @property
    def tdd(self) -> TDDConfig:
        return parse_tdd_pattern(
            self.tdd_pattern, self.tdd_special_slot[0], self.tdd_special_slot[2]
        )


@dataclass(frozen=True)
class SectorGNBParams(GNBParams):
    """One sector's TRxP of a multi-sector site (TR 38.901 §7.1.3, §7.3):
    its array turned to `boresight_deg` (azimuth from +x, counter-clockwise)
    and tilted down mechanically by `downtilt_deg`, with the Table 7.3-1
    element pattern at the gNB end of every link (ops/cdl.py GnbSector). Its
    UEs are dropped within +-60 deg of the boresight."""

    boresight_deg: float = 30.0
    downtilt_deg: float = 12.0


SECTOR_WEDGE_DEG = 120.0  # the azimuth span a sector's UEs are dropped in


@dataclass(frozen=True)
class UEParams:
    """UE population config (+user/ueParameters.m)."""

    num_ues: int = 5
    height: float = 1.5
    tx_power_dbm: float = 23.0
    rx_gain_db: float = 11.5
    noise_figure_db: float = 9.0
    temperature_k: float = 290.0
    num_ants: int = 2
    position_mode: str = "poisson"  # 'poisson' | 'predefined'
    positions: Optional[tuple] = None  # for predefined
    drop_radius: float = 200.0
    seed: int = 0


@dataclass(frozen=True)
class TargetParams:
    """Sensing target config (+target/targetParameters.m)."""

    num_targets: int = 1
    height: float = 1.5
    rcs_m2: tuple = (1.0,)
    velocity_ms: tuple = (5.0,)  # radial velocity
    position_mode: str = "poisson"
    positions: Optional[tuple] = None
    drop_radius: float = 200.0
    seed: int = 1


@dataclass(frozen=True)
class SchedulingParams:
    """(+schedulingStrategies/parameters.m)."""

    strategy: str = "PF"  # 'RR' | 'PF' | 'BestCQI'
    mcs_table: str = "qam64"  # 'qam64' | 'qam256' (TS 38.214 T5.1.3.1-1/2)
    tti_granularity: int = 4  # {2, 4, 7} symbols, for symbol-based scheduling
    rb_allocation_limit_ul: Optional[int] = None
    rb_allocation_limit_dl: Optional[int] = None
    rbg_size_config: int = 1  # TS 38.214 Table 5.1.2.2.1-1 config 1/2
    pf_moving_avg_weight: float = 0.5
    bsr_periodicity_slots: int = 5
    csi_report_period_ms: float = 2.0


@dataclass(frozen=True)
class TrafficParams:
    """(+trafficModels/parameters.m)."""

    model: str = "On-Off"  # 'On-Off' | 'FTP' | 'VoIP' | 'VideoConference'
    dl_app_data_rate_kbps: float = 40e3
    ul_app_data_rate_kbps: float = 10e3
    on_time_s: float = 1.0
    off_time_s: float = 0.0
    packet_size_bytes: int = 1500
    seed: int = 2


@dataclass(frozen=True)
class PathlossParams:
    """(+pathLossModels/parameters.m). model in {'fspl','UMa','UMi','RMa','InH','InF-SL','InF-DL','InF-SH','InF-DH'}"""

    model: str = "UMa"
    shadow_fading: bool = False  # log-normal shadowing on top of the model
    shadow_sigma_db: float = 6.0  # TR 38.901 UMa NLoS-ish sigma_SF
    seed: int = 3


@dataclass(frozen=True)
class CDLParams:
    """(+channelModels/+communication/cdl.m): per-link CDL fading config."""

    delay_profile: str = "CDL-D"  # selected per LoS: D if LoS, A if NLoS (updateCDLModels.m)
    delay_spread_ns: float = 300.0
    max_doppler_shift_hz: float = 5.0
    num_paths_cap: int = 23
    seed: int = 4


@dataclass(frozen=True)
class CityParams:
    """OSM city scenario params (+city/parameters.m, +city/openStreetMap.m)."""

    bbox_lonlat: tuple = (116.3575, 116.3675, 39.9000, 39.9100)  # minLon,maxLon,minLat,maxLat
    street_width: float = 10.0
    min_building_height: float = 10.0
    max_building_height: float = 40.0
    wall_loss_db: float = 20.0
    height_seed: int = 5
    load_cache: bool = True
    cache_path: Optional[str] = None  # JSON cache (dataFiles/blockages/OSM_city.json format)


@dataclass(frozen=True)
class RegionOfInterest:
    """(+regionOfInterest/region.m)."""

    x_span: float = 1000.0
    y_span: float = 1000.0
    z_span: float = 100.0

    @property
    def x_min(self) -> float:
        return -self.x_span / 2

    @property
    def x_max(self) -> float:
        return self.x_span / 2

    @property
    def y_min(self) -> float:
        return -self.y_span / 2

    @property
    def y_max(self) -> float:
        return self.y_span / 2


@dataclass(frozen=True)
class TimeParams:
    """(+parameters/time.m): numFrames -> numSlots."""

    num_frames: int = 1

    def num_slots(self, scs_khz: int) -> int:
        return self.num_frames * 10 * (scs_khz // 15)


@dataclass(frozen=True)
class LogParams:
    """(+parameters/log.m)."""

    enable_traces: bool = False
    cqi_visualization: bool = False
    rb_visualization: bool = False


# ----------------------------------------------------------------------------- aggregate


@dataclass
class SimulationParameters:
    """Aggregate container (simulationParameters.m:44-66). Keyed per-cell dicts
    allow heterogeneous multi-cell configs exactly like the reference's
    containers.Map fields."""

    time: TimeParams = field(default_factory=TimeParams)
    roi: RegionOfInterest = field(default_factory=RegionOfInterest)
    log: LogParams = field(default_factory=LogParams)
    bs: dict = field(default_factory=dict)  # name -> GNBParams
    ue: dict = field(default_factory=dict)  # name -> UEParams
    target: dict = field(default_factory=dict)  # name -> TargetParams
    scheduling: dict = field(default_factory=dict)  # name -> SchedulingParams
    traffic: dict = field(default_factory=dict)  # name -> TrafficParams
    pathloss: dict = field(default_factory=dict)  # name -> PathlossParams
    com_channel: dict = field(default_factory=dict)  # name -> CDLParams
    sen_channel: dict = field(default_factory=dict)  # name -> RadarConfig (override)
    city: dict = field(default_factory=dict)  # name -> CityParams

    def cell_names(self):
        return list(self.bs.keys())

    def validate(self):
        """Cross-map cardinality check (networkSimulation.m:69-77)."""
        n = len(self.bs)
        for fname in ("ue", "target", "scheduling", "traffic", "pathloss", "com_channel"):
            m = getattr(self, fname)
            if m and len(m) != n:
                raise ValueError(
                    f"parameter map '{fname}' has {len(m)} entries but {n} cells configured"
                )


# ----------------------------------------------------------------------------- flattened cell


@dataclass(frozen=True)
class CellParams:
    """Flat per-cell parameter bundle (assignCellSimulationParameters.m:26-102).

    Everything the per-cell pipeline consumes, with positions/LoS resolved.
    """

    name: str
    gnb: GNBParams
    ue: UEParams
    target: TargetParams
    scheduling: SchedulingParams
    traffic: TrafficParams
    pathloss: PathlossParams
    cdl: CDLParams
    time: TimeParams
    log: LogParams
    ue_positions: np.ndarray  # [num_ues, 3]
    target_positions: np.ndarray  # [num_targets, 3]
    ue_los: np.ndarray  # bool [num_ues]
    target_los: np.ndarray  # bool [num_targets]

    @property
    def num_slots(self) -> int:
        return self.time.num_slots(self.gnb.scs_khz)

    def with_(self, **kw) -> "CellParams":
        return replace(self, **kw)


def assign_cell_parameters(sim: SimulationParameters) -> list:
    """Flatten per-cell parameter objects; positions dropped, LoS defaults True
    until topology resolves it (assignCellSimulationParameters.m)."""
    from isac_tpu_torch.utils.geometry import poisson_points_2d

    sim.validate()
    cells = []
    for name in sim.cell_names():
        gnb = sim.bs[name]
        ue = sim.ue.get(name, UEParams())
        tgt = sim.target.get(name, TargetParams())
        rng_ue = np.random.default_rng(ue.seed)
        rng_tg = np.random.default_rng(tgt.seed)
        center = np.asarray(gnb.position[:2])
        if ue.position_mode == "predefined" and ue.positions is not None:
            ue_pos = np.asarray(ue.positions, dtype=np.float64)
        else:
            wedge = (None if gnb.boresight_deg is None
                     else (gnb.boresight_deg, SECTOR_WEDGE_DEG))  # a sector's UEs: its wedge
            ue_pos = poisson_points_2d(rng_ue, center, ue.drop_radius, ue.num_ues, ue.height,
                                       wedge=wedge)
        if tgt.position_mode == "predefined" and tgt.positions is not None:
            tg_pos = np.asarray(tgt.positions, dtype=np.float64)
        else:
            tg_pos = poisson_points_2d(rng_tg, center, tgt.drop_radius, tgt.num_targets, tgt.height)
        cells.append(
            CellParams(
                name=name,
                gnb=gnb,
                ue=ue,
                target=tgt,
                scheduling=sim.scheduling.get(name, SchedulingParams()),
                traffic=sim.traffic.get(name, TrafficParams()),
                pathloss=sim.pathloss.get(name, PathlossParams()),
                cdl=sim.com_channel.get(name, CDLParams()),
                time=sim.time,
                log=sim.log,
                ue_positions=ue_pos,
                target_positions=tg_pos,
                ue_los=np.ones(ue_pos.shape[0], dtype=bool),
                target_los=np.ones(tg_pos.shape[0], dtype=bool),
            )
        )
    return cells
