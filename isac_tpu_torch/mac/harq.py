"""HARQ process management (ref: +communication/+harq/harqEntity.m,
newHARQProcesses.m, updateHARQProcess.m; scheduler context at
schedulerEntity.m:2274-2335, 2838-2873).

Vectorized over [n_ues, n_harq]: parallel stop-and-wait processes with NDI
toggling and RV sequence [0 3 2 1] on block error.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

RV_SEQUENCE = np.array([0, 3, 2, 1])


@dataclass
class HarqState:
    """Per-direction HARQ state for all UEs of a cell."""

    n_ues: int
    n_harq: int = 16
    ndi: np.ndarray = field(default=None)  # toggles on new data
    rv_idx: np.ndarray = field(default=None)  # index into RV_SEQUENCE
    pending: np.ndarray = field(default=None)  # awaiting feedback
    need_retx: np.ndarray = field(default=None)  # NACKed, waiting for re-grant
    tbs: np.ndarray = field(default=None)  # bits of the stored TB
    mcs: np.ndarray = field(default=None)
    n_prb: np.ndarray = field(default=None)
    n_sym: np.ndarray = field(default=None)  # TTI duration of the stored TB
    tx_count: np.ndarray = field(default=None)
    payload: dict = field(default_factory=dict)  # (ue, pid) -> bit array
    buffers: dict = field(default_factory=dict)  # (ue, pid) -> decoder soft buffers

    def __post_init__(self):
        z = lambda dt=np.int32: np.zeros((self.n_ues, self.n_harq), dt)
        self.ndi = z() if self.ndi is None else self.ndi
        self.rv_idx = z() if self.rv_idx is None else self.rv_idx
        self.pending = z(bool) if self.pending is None else self.pending
        self.need_retx = z(bool) if self.need_retx is None else self.need_retx
        self.tbs = z(np.int64) if self.tbs is None else self.tbs
        self.mcs = z() if self.mcs is None else self.mcs
        self.n_prb = z() if self.n_prb is None else self.n_prb
        self.n_sym = z() if self.n_sym is None else self.n_sym
        self.tx_count = z() if self.tx_count is None else self.tx_count

    def free_process(self, ue: int) -> int | None:
        """First idle process (findFreeUEHarqProcess:2274)."""
        idle = ~(self.pending[ue] | self.need_retx[ue])
        ids = np.nonzero(idle)[0]
        return int(ids[0]) if ids.size else None

    def new_tx(self, ue: int, pid: int, tbs: int, mcs: int, n_prb: int, payload,
               n_sym: int = 14):
        self.ndi[ue, pid] ^= 1  # NDI toggle (schedulerEntity.m:2139)
        self.rv_idx[ue, pid] = 0
        self.pending[ue, pid] = True
        self.need_retx[ue, pid] = False
        self.tbs[ue, pid] = tbs
        self.mcs[ue, pid] = mcs
        self.n_prb[ue, pid] = n_prb
        self.n_sym[ue, pid] = n_sym
        self.tx_count[ue, pid] = 1
        self.payload[(ue, pid)] = payload
        self.buffers.pop((ue, pid), None)

    def retx(self, ue: int, pid: int):
        """Advance RV for a retransmission; returns the RV value."""
        self.rv_idx[ue, pid] = (self.rv_idx[ue, pid] + 1) % 4
        self.pending[ue, pid] = True
        self.need_retx[ue, pid] = False
        self.tx_count[ue, pid] += 1
        return int(RV_SEQUENCE[self.rv_idx[ue, pid]])

    def rv(self, ue: int, pid: int) -> int:
        return int(RV_SEQUENCE[self.rv_idx[ue, pid]])

    def feedback(self, ue: int, pid: int, ack: bool, max_retx: int = 3):
        """ACK -> free; NACK -> mark for retransmission (or drop at max)."""
        self.pending[ue, pid] = False
        if ack:
            self.need_retx[ue, pid] = False
            self.rv_idx[ue, pid] = 0
            self.payload.pop((ue, pid), None)
            self.buffers.pop((ue, pid), None)
            return "ack"
        if self.tx_count[ue, pid] > max_retx:
            self.need_retx[ue, pid] = False
            self.payload.pop((ue, pid), None)
            self.buffers.pop((ue, pid), None)
            return "drop"
        self.need_retx[ue, pid] = True
        return "retx"
