"""MCS / CQI tables per TS 38.214 (reference: macEntity.m:359-433,
schedulerEntity.m:2427-2471, 2874-2950).

Table entries: (modulation, target_code_rate_x1024, spectral_efficiency).

numpy copy of isac_tpu/mac/tables.py, kept so the port never imports isac_tpu.
"""

from __future__ import annotations

import numpy as np

# TS 38.214 Table 5.1.3.1-1 (qam64)
MCS_TABLE_64QAM = [
    ("QPSK", 120, 0.2344), ("QPSK", 157, 0.3066), ("QPSK", 193, 0.3770),
    ("QPSK", 251, 0.4902), ("QPSK", 308, 0.6016), ("QPSK", 379, 0.7402),
    ("QPSK", 449, 0.8770), ("QPSK", 526, 1.0273), ("QPSK", 602, 1.1758),
    ("QPSK", 679, 1.3262), ("16QAM", 340, 1.3281), ("16QAM", 378, 1.4766),
    ("16QAM", 434, 1.6953), ("16QAM", 490, 1.9141), ("16QAM", 553, 2.1602),
    ("16QAM", 616, 2.4063), ("16QAM", 658, 2.5703), ("64QAM", 438, 2.5664),
    ("64QAM", 466, 2.7305), ("64QAM", 517, 3.0293), ("64QAM", 567, 3.3223),
    ("64QAM", 616, 3.6094), ("64QAM", 666, 3.9023), ("64QAM", 719, 4.2129),
    ("64QAM", 772, 4.5234), ("64QAM", 822, 4.8164), ("64QAM", 873, 5.1152),
    ("64QAM", 910, 5.3320), ("64QAM", 948, 5.5547),
]

# TS 38.214 Table 5.1.3.1-2 (qam256)
MCS_TABLE_256QAM = [
    ("QPSK", 120, 0.2344), ("QPSK", 193, 0.3770), ("QPSK", 308, 0.6016),
    ("QPSK", 449, 0.8770), ("QPSK", 602, 1.1758), ("16QAM", 378, 1.4766),
    ("16QAM", 434, 1.6953), ("16QAM", 490, 1.9141), ("16QAM", 553, 2.1602),
    ("16QAM", 616, 2.4063), ("16QAM", 658, 2.5703), ("64QAM", 466, 2.7305),
    ("64QAM", 517, 3.0293), ("64QAM", 567, 3.3223), ("64QAM", 616, 3.6094),
    ("64QAM", 666, 3.9023), ("64QAM", 719, 4.2129), ("64QAM", 772, 4.5234),
    ("64QAM", 822, 4.8164), ("64QAM", 873, 5.1152), ("256QAM", 682.5, 5.3320),
    ("256QAM", 711, 5.5547), ("256QAM", 754, 5.8906), ("256QAM", 797, 6.2266),
    ("256QAM", 841, 6.5703), ("256QAM", 885, 6.9141), ("256QAM", 916.5, 7.1602),
    ("256QAM", 948, 7.4063),
]


def mcs_info(mcs: int, table: str = "qam64") -> tuple:
    """(modulation, target_code_rate [0..1], efficiency) for an MCS row."""
    tab = MCS_TABLE_64QAM if table == "qam64" else MCS_TABLE_256QAM
    mod, r1024, eff = tab[mcs]
    return mod, r1024 / 1024.0, eff


def max_mcs(table: str = "qam64") -> int:
    return len(MCS_TABLE_64QAM if table == "qam64" else MCS_TABLE_256QAM) - 1


# CQI (table 1) efficiency — used by the scheduler's CQI->MCS mapping
CQI_EFFICIENCY = np.array(
    [0.0, 0.1523, 0.2344, 0.3770, 0.6016, 0.8770, 1.1758, 1.4766,
     1.9141, 2.4063, 2.7305, 3.3223, 3.9023, 4.5234, 5.1152, 5.5547]
)


def cqi_to_mcs(cqi: int, table: str = "qam64") -> int:
    """Highest MCS whose efficiency does not exceed the CQI's efficiency
    (schedulerEntity.m getMCSIndex:2587-2602)."""
    cqi = int(np.clip(cqi, 0, 15))
    if cqi <= 0:
        return 0
    eff = CQI_EFFICIENCY[cqi]
    tab = MCS_TABLE_64QAM if table == "qam64" else MCS_TABLE_256QAM
    best = 0
    for i, (_, _, e) in enumerate(tab):
        if e <= eff + 1e-9:
            best = i
    return best


# TS 38.214 Table 5.1.2.2.1-1: nominal RBG size P by BWP size, configs 1/2
def rbg_size(n_prb: int, config: int = 1) -> int:
    bounds = [(36, 2, 4), (72, 4, 8), (144, 8, 16), (275, 16, 16)]
    for hi, p1, p2 in bounds:
        if n_prb <= hi:
            return p1 if config == 1 else p2
    return 16
