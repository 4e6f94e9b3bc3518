from isac_tpu_torch.config.carrier import (
    CarrierConfig,
    OFDMInfo,
    TDDConfig,
    determine_prb,
    frequency_range,
    ofdm_info,
    parse_tdd_pattern,
)
from isac_tpu_torch.config.params import (
    CDLParams,
    CellParams,
    CityParams,
    GNBParams,
    LogParams,
    PathlossParams,
    RadarConfig,
    RegionOfInterest,
    SchedulingParams,
    SectorGNBParams,
    SimulationParameters,
    TargetParams,
    TimeParams,
    TrafficParams,
    UEParams,
    ULA,
    UPA,
    assign_cell_parameters,
)

__all__ = [
    "CarrierConfig", "OFDMInfo", "TDDConfig", "determine_prb", "frequency_range",
    "ofdm_info", "parse_tdd_pattern", "CDLParams", "CellParams", "CityParams",
    "GNBParams", "LogParams", "PathlossParams", "RadarConfig", "RegionOfInterest",
    "SchedulingParams", "SectorGNBParams", "SimulationParameters", "TargetParams", "TimeParams",
    "TrafficParams", "UEParams", "ULA", "UPA", "assign_cell_parameters",
]
