"""RLC Unacknowledged Mode per TS 38.322 (ref: +rlcLayer/umEntity.m:169-924).

Host-side byte-level state machine (control plane). UMD PDU format:
- full SDU: 1-byte header [SI=00 | R...] + data (no SN)
- first segment: [SI=01 | SN(6b)] + data
- middle/last: [SI=11/10 | SN(6b)] + SO(2 bytes) + data
Rx keeps a per-SN reassembly store with a t-Reassembly timer
(umEntity.m receivePDU:428, updateRxState:629, reassemblyTimerExpiry:712).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

SI_FULL, SI_FIRST, SI_LAST, SI_MIDDLE = 0, 1, 2, 3


@dataclass
class UMStats:
    tx_sdus: int = 0
    tx_bytes: int = 0
    tx_pdus: int = 0
    rx_pdus: int = 0
    rx_sdus: int = 0
    rx_bytes: int = 0
    dropped: int = 0


class UMEntity:
    """One direction pair of an RLC UM bearer (tx + rx halves)."""

    def __init__(self, sn_bits: int = 6, t_reassembly_ms: int = 20, header_overhead: int = 3):
        self.sn_bits = sn_bits
        self.sn_mod = 1 << sn_bits
        self.t_reassembly = t_reassembly_ms
        self.header_overhead = header_overhead
        self.tx_queue: deque = deque()  # (sdu_bytes, next_offset)
        self.tx_next = 0  # SN for segmented SDUs
        self.rx_store: dict = {}  # sn -> {so: bytes}, plus 'last_so' when SI_LAST seen
        self.rx_timer: dict = {}  # sn -> ms remaining
        self.stats = UMStats()

    # ------------------------------------------------------------------- TX

    def enqueue_sdu(self, sdu: bytes):
        self.tx_queue.append([sdu, 0])
        self.stats.tx_sdus += 1

    def buffer_status(self) -> int:
        """Pending bytes incl. estimated headers (umEntity.m getBufferStatus:408)."""
        total = 0
        for sdu, off in self.tx_queue:
            total += len(sdu) - off + self.header_overhead
        return total

    def send_pdus(self, grant_bytes: int) -> list:
        """Build UMD PDUs up to grant_bytes (umEntity.m sendPDU:293-407)."""
        pdus = []
        budget = int(grant_bytes)
        while self.tx_queue and budget > 2:
            sdu, off = self.tx_queue[0]
            remaining = len(sdu) - off
            if off == 0 and remaining + 1 <= budget:
                pdus.append(bytes([SI_FULL << 6]) + sdu)  # full SDU
                budget -= remaining + 1
                self.tx_queue.popleft()
            else:
                hdr_len = 1 if off == 0 else 3
                room = budget - hdr_len
                if room <= 0:
                    break
                take = min(room, remaining)
                seg = sdu[off : off + take]
                sn = self.tx_next % self.sn_mod
                if off == 0:
                    si = SI_FIRST
                    hdr = bytes([(si << 6) | (sn & 0x3F)])
                else:
                    si = SI_LAST if off + take == len(sdu) else SI_MIDDLE
                    hdr = bytes([(si << 6) | (sn & 0x3F), (off >> 8) & 0xFF, off & 0xFF])
                pdus.append(hdr + seg)
                budget -= hdr_len + take
                if off + take == len(sdu):
                    self.tx_queue.popleft()
                    self.tx_next = (self.tx_next + 1) % self.sn_mod
                else:
                    self.tx_queue[0][1] = off + take
        self.stats.tx_pdus += len(pdus)
        self.stats.tx_bytes += sum(len(p) for p in pdus)
        return pdus

    # ------------------------------------------------------------------- RX

    def receive_pdu(self, pdu: bytes) -> list:
        """Process one UMD PDU; returns list of delivered SDUs
        (umEntity.m receivePDU:428 + reassembly)."""
        self.stats.rx_pdus += 1
        si = (pdu[0] >> 6) & 0x3
        delivered = []
        if si == SI_FULL:
            delivered.append(pdu[1:])
        else:
            sn = pdu[0] & 0x3F
            if si == SI_FIRST:
                so, data = 0, pdu[1:]
            else:
                so = (pdu[1] << 8) | pdu[2]
                data = pdu[3:]
            store = self.rx_store.setdefault(sn, {})
            store[so] = data
            if si == SI_LAST:
                store["last_end"] = so + len(data)
            self.rx_timer.setdefault(sn, self.t_reassembly)
            sdu = self._try_reassemble(sn)
            if sdu is not None:
                delivered.append(sdu)
                self.rx_store.pop(sn, None)
                self.rx_timer.pop(sn, None)
        for s in delivered:
            self.stats.rx_sdus += 1
            self.stats.rx_bytes += len(s)
        return delivered

    def _try_reassemble(self, sn: int):
        store = self.rx_store.get(sn, {})
        if "last_end" not in store:
            return None
        end = store["last_end"]
        segs = sorted((k, v) for k, v in store.items() if isinstance(k, int))
        pos = 0
        out = bytearray()
        for so, data in segs:
            if so > pos:
                return None  # gap
            if so + len(data) <= pos:
                continue  # duplicate overlap
            out += data[pos - so :]
            pos = so + len(data)
        return bytes(out) if pos == end else None

    def tick_1ms(self):
        """Advance reassembly timers; discard expired partial SDUs
        (umEntity.m reassemblyTimerExpiry:712)."""
        expired = []
        for sn in list(self.rx_timer):
            self.rx_timer[sn] -= 1
            if self.rx_timer[sn] <= 0:
                expired.append(sn)
        for sn in expired:
            self.rx_store.pop(sn, None)
            self.rx_timer.pop(sn, None)
            self.stats.dropped += 1
