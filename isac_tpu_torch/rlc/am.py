"""RLC Acknowledged Mode per TS 38.322 (ref: +rlcLayer/amEntity.m:324-1854).

Host-side bidirectional state machine: one entity per END of an AM bearer
(gNB end transmits DL SDUs and receives UL; UE end the reverse), exactly like
the reference's per-node amEntity objects. TX side: SDU queue with
segmentation, tx window, polling (pollPDU/pollByte/t-PollRetransmit),
retransmission queue with per-SN segment ranges
(amEntity.m retransmitSegment:721, updateRetransmissionContext:1073).
RX side: per-SN segment reassembly, t-Reassembly, STATUS PDU construction with
ACK_SN + NACK_SN list incl. segment offsets (constructStatusPDU:1219,
decodeStatusPDU:1311), t-StatusProhibit.

STATUS PDUs are CONTROL PDUs carried in-band on the same logical channel of
the reverse link (D/C bit distinguishes them); the simulator routes every
received PDU of a bearer into this one entity and `receive_pdu` dispatches.

PDU framing (12-bit SN; compact, not the bit-exact 38.322 layout — documented
deviation, the semantics match):
- AMD:    [D/C=1 | P | SI(2) | SN(11:8)] [SN(7:0)] [SO(2B) if SI=MIDDLE/LAST]
- STATUS: [D/C=0 | 0 | 0 | ACK_SN(11:8)] [ACK_SN(7:0)]
          then per NACK: [hasSO | SN(11:8)<<0] [SN(7:0)] [+4B so_start,so_end]
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

SI_FULL, SI_FIRST, SI_LAST, SI_MIDDLE = 0, 1, 2, 3
SO_END_OF_SDU = 0xFFFF


@dataclass
class AMStats:
    tx_sdus: int = 0
    tx_pdus: int = 0
    tx_bytes: int = 0
    retx_pdus: int = 0
    rx_pdus: int = 0
    rx_sdus: int = 0
    rx_bytes: int = 0
    status_tx: int = 0
    status_rx: int = 0
    dropped: int = 0


class AMEntity:
    def __init__(
        self,
        sn_bits: int = 12,
        poll_pdu: int = 8,
        poll_byte: int = 25000,
        t_poll_retransmit_ms: int = 45,
        t_status_prohibit_ms: int = 5,
        t_reassembly_ms: int = 35,
        max_retx: int = 8,
        header_overhead: int = 4,
    ):
        self.sn_mod = 1 << sn_bits
        self.poll_pdu = poll_pdu
        self.poll_byte = poll_byte
        self.t_poll_retx = t_poll_retransmit_ms
        self.t_status_prohibit = t_status_prohibit_ms
        self.t_reassembly = t_reassembly_ms
        self.max_retx = max_retx
        self.header_overhead = header_overhead
        # ----- TX side -----
        self.tx_queue: deque = deque()  # [sdu, next_offset] new SDUs
        self.tx_next = 0
        self.tx_next_ack = 0
        self.tx_buffer: dict = {}  # sn -> sdu bytes (unacked)
        # retx queue entries: (sn, so_start, so_end) — so_end=SO_END_OF_SDU
        # means "to end of SDU" (whole-SDU NACKs use (sn, 0, SO_END_OF_SDU))
        self.retx_queue: deque = deque()
        self.retx_count: dict = {}
        self.pdu_since_poll = 0
        self.byte_since_poll = 0
        self.poll_retx_timer = -1
        # ----- RX side -----
        self.rx_next = 0  # lowest SN not fully reassembled & delivered
        self.rx_segs: dict = {}  # sn -> {"segs": {so: bytes}, "total": int|None}
        self.rx_timer = -1  # t-Reassembly (one timer, 38.322 §5.2.3.2.3)
        self.status_trigger = False
        self.status_prohibit = 0
        self.stats = AMStats()

    # ------------------------------------------------------------------- TX

    def enqueue_sdu(self, sdu: bytes):
        self.tx_queue.append([sdu, 0])
        self.stats.tx_sdus += 1

    def buffer_status(self) -> int:
        """Pending TX bytes incl. estimated headers (getBufferStatus analogue)."""
        n = sum(len(s) - off + self.header_overhead for s, off in self.tx_queue)
        for sn, so0, so1 in self.retx_queue:
            sdu = self.tx_buffer.get(sn)
            if sdu is not None:
                end = len(sdu) if so1 == SO_END_OF_SDU else min(so1 + 1, len(sdu))
                n += max(end - so0, 0) + self.header_overhead
        return n

    def _window_ok(self, sn: int) -> bool:
        return ((sn - self.tx_next_ack) % self.sn_mod) < self.sn_mod // 2

    def _amd_header(self, sn: int, si: int, so: int, poll: bool) -> bytes:
        b0 = 0x80 | (0x40 if poll else 0) | (si << 4) | ((sn >> 8) & 0xF)
        hdr = bytes([b0, sn & 0xFF])
        if si in (SI_MIDDLE, SI_LAST):
            hdr += bytes([(so >> 8) & 0xFF, so & 0xFF])
        return hdr

    def send_pdus(self, grant_bytes: int) -> list:
        """Retransmissions first (amEntity.m retx context :1073), then new
        data with segmentation (retransmitSegment:721 / sendPDU analogue)."""
        pdus: list = []
        budget = int(grant_bytes)

        # --- retransmissions (possibly byte ranges), segmenting to the grant
        while self.retx_queue and budget > 6:
            sn, so0, so1 = self.retx_queue[0]
            sdu = self.tx_buffer.get(sn)
            if sdu is None:
                self.retx_queue.popleft()
                continue
            end = len(sdu) if so1 == SO_END_OF_SDU else min(so1 + 1, len(sdu))
            if so0 >= end:
                self.retx_queue.popleft()
                continue
            full_sdu = so0 == 0 and end == len(sdu)
            # header size for the piece we are about to send
            hlen = 2 if (full_sdu or so0 == 0) else 4
            room = budget - hlen
            if room <= 0:
                break
            take = min(room, end - so0)
            is_last_piece = so0 + take == end
            if full_sdu and is_last_piece:
                si = SI_FULL
            elif so0 == 0:
                si = SI_FIRST
            elif so0 + take == len(sdu):
                si = SI_LAST
            else:
                si = SI_MIDDLE
            # TS 38.322 §5.3.3.2: force a poll when both buffers empty after
            # this PDU (otherwise the final ACK is never solicited)
            empty_after = is_last_piece and len(self.retx_queue) == 1 and not self.tx_queue
            poll = self._poll_due(take, force=empty_after)
            pdus.append(self._amd_header(sn, si, so0, poll) + sdu[so0 : so0 + take])
            budget -= hlen + take
            self.stats.retx_pdus += 1
            if is_last_piece:
                self.retx_queue.popleft()
            else:
                self.retx_queue[0] = (sn, so0 + take, so1)

        # --- new transmissions, segmenting the head SDU to the grant
        while self.tx_queue and budget > 6 and self._window_ok(self.tx_next):
            sdu, off = self.tx_queue[0]
            hlen = 2 if off == 0 else 4
            room = budget - hlen
            if room <= 0:
                break
            take = min(room, len(sdu) - off)
            done = off + take == len(sdu)
            if off == 0 and done:
                si = SI_FULL
            elif off == 0:
                si = SI_FIRST
            elif done:
                si = SI_LAST
            else:
                si = SI_MIDDLE
            sn = self.tx_next
            empty_after = done and len(self.tx_queue) == 1 and not self.retx_queue
            poll = self._poll_due(take, force=empty_after)
            pdus.append(self._amd_header(sn, si, off, poll) + sdu[off : off + take])
            budget -= hlen + take
            if done:
                self.tx_queue.popleft()
                self.tx_buffer[sn] = sdu
                self.tx_next = (self.tx_next + 1) % self.sn_mod
            else:
                self.tx_queue[0][1] = off + take
        self.stats.tx_pdus += len(pdus)
        self.stats.tx_bytes += sum(len(p) for p in pdus)
        return pdus

    def _poll_due(self, n_bytes: int, force: bool = False) -> bool:
        """pollPDU / pollByte / buffer-empty triggers (getPollStatus:809)."""
        self.pdu_since_poll += 1
        self.byte_since_poll += n_bytes
        if force or self.pdu_since_poll >= self.poll_pdu or self.byte_since_poll >= self.poll_byte:
            self.pdu_since_poll = 0
            self.byte_since_poll = 0
            self.poll_retx_timer = self.t_poll_retx
            return True
        return False

    # ------------------------------------------------------------------- RX

    def receive_pdu(self, pdu: bytes) -> list:
        """AMD or STATUS PDU in (D/C dispatch); returns delivered SDUs."""
        if pdu[0] & 0x80:
            return self._receive_amd(pdu)
        self._receive_status(pdu)
        return []

    def _receive_amd(self, pdu: bytes) -> list:
        self.stats.rx_pdus += 1
        poll = bool(pdu[0] & 0x40)
        si = (pdu[0] >> 4) & 0x3
        sn = ((pdu[0] & 0xF) << 8) | pdu[1]
        if si in (SI_MIDDLE, SI_LAST):
            so = (pdu[2] << 8) | pdu[3]
            data = pdu[4:]
        else:
            so = 0
            data = pdu[2:]
        # discard outside the rx window (already delivered)
        if ((sn - self.rx_next) % self.sn_mod) >= self.sn_mod // 2:
            if poll:
                self.status_trigger = True
            return []
        ent = self.rx_segs.setdefault(sn, {"segs": {}, "total": None})
        ent["segs"][so] = data
        if si in (SI_FULL, SI_LAST):
            ent["total"] = so + len(data)
        if poll:
            self.status_trigger = True

        delivered = []
        while self.rx_next in self.rx_segs and self._complete(self.rx_next):
            sdu = self._assemble(self.rx_next)
            self.rx_segs.pop(self.rx_next)
            delivered.append(sdu)
            self.rx_next = (self.rx_next + 1) % self.sn_mod
            self.stats.rx_sdus += 1
            self.stats.rx_bytes += len(sdu)
        # gap detected beyond rx_next -> reassembly timer + status
        if any(s != self.rx_next for s in self.rx_segs) or (
            self.rx_next in self.rx_segs and not self._complete(self.rx_next)
        ):
            if self.rx_timer < 0:
                self.rx_timer = self.t_reassembly
        else:
            self.rx_timer = -1
        dist = (sn - self.rx_next) % self.sn_mod
        if 0 < dist < self.sn_mod // 2:
            self.status_trigger = True  # out-of-order arrival
        return delivered

    def _complete(self, sn: int) -> bool:
        ent = self.rx_segs.get(sn)
        if ent is None or ent["total"] is None:
            return False
        have = 0
        for so in sorted(ent["segs"]):
            if so > have:
                return False
            have = max(have, so + len(ent["segs"][so]))
        return have >= ent["total"]

    def _assemble(self, sn: int) -> bytes:
        ent = self.rx_segs[sn]
        out = bytearray(ent["total"])
        for so, data in ent["segs"].items():
            out[so : so + len(data)] = data
        return bytes(out)

    def _missing_ranges(self, sn: int) -> list:
        """[(so_start, so_end_inclusive|SO_END_OF_SDU)] byte gaps of SN."""
        ent = self.rx_segs.get(sn)
        if ent is None:
            return [(0, SO_END_OF_SDU)]
        gaps = []
        have = 0
        for so in sorted(ent["segs"]):
            if so > have:
                gaps.append((have, so - 1))
            have = max(have, so + len(ent["segs"][so]))
        if ent["total"] is None:
            gaps.append((have, SO_END_OF_SDU))
        elif have < ent["total"]:
            gaps.append((have, ent["total"] - 1))
        return gaps

    # ------------------------------------------------------------- STATUS TX

    def status_pdu(self, budget: int | None = None, max_nack: int = 32) -> bytes | None:
        """Emit STATUS if triggered and not prohibited (constructStatusPDU:1219).

        NACKs list missing SNs and missing byte ranges of partially received
        SNs (SO-based NACK ranges, amEntity.m:1219-1311). `budget` bounds the
        encoded PDU size (the reference passes remainingGrant into
        constructStatusPDU). When the NACK scan is truncated — by `budget` or
        by the `max_nack` cap — ACK_SN is set to the SN where the scan
        stopped, NOT highest-seen+1: otherwise still-missing SNs beyond the
        cap would be implicitly ACKed and released from the peer's tx_buffer
        (amEntity.m constructStatusPDU: 'to avoid misinterpretation about
        NACK SN to ACK SN'). A truncated STATUS leaves the trigger armed so
        the remainder is reported once t-StatusProhibit expires."""
        if not self.status_trigger or self.status_prohibit > 0:
            return None
        if budget is not None and budget < 2:
            return None  # cannot even fit the ACK_SN header; keep trigger set
        pending = sorted(
            self.rx_segs, key=lambda s: (s - self.rx_next) % self.sn_mod
        )
        ack_limit = ((pending[-1] + 1) % self.sn_mod) if pending else self.rx_next
        nack_bytes = bytearray()
        sn = self.rx_next
        n_nack = 0
        truncated = False
        while sn != ack_limit:
            if sn not in self.rx_segs:
                if n_nack + 1 > max_nack or (
                    budget is not None and 2 + len(nack_bytes) + 2 > budget
                ):
                    truncated = True
                    break
                nack_bytes += bytes([(sn >> 8) & 0xF, sn & 0xFF])
                n_nack += 1
            elif not self._complete(sn):
                # an SN's missing-range info must be emitted whole or the
                # scan must stop BEFORE it: NACK_SN must stay < ACK_SN, so a
                # partially reported SN cannot become the ACK_SN boundary
                # (amEntity.m:1286-1289 'subStatusPDULen > grantLeft ->
                # break'). To guarantee progress under small grants, merge
                # trailing gaps into one wider range when the full list
                # doesn't fit — conservative over-NACKing, never loss.
                ranges = self._missing_ranges(sn)
                n_fit = max_nack - n_nack
                if budget is not None:
                    n_fit = min(n_fit, (budget - 2 - len(nack_bytes)) // 6)
                if n_fit <= 0:
                    truncated = True
                    break
                if len(ranges) > n_fit:
                    ranges = ranges[: n_fit - 1] + [
                        (ranges[n_fit - 1][0], ranges[-1][1])
                    ]
                for so0, so1 in ranges:
                    nack_bytes += bytes([0x80 | ((sn >> 8) & 0xF), sn & 0xFF,
                                         (so0 >> 8) & 0xFF, so0 & 0xFF,
                                         (so1 >> 8) & 0xFF, so1 & 0xFF])
                n_nack += len(ranges)
            sn = (sn + 1) % self.sn_mod
        ack_sn = sn if truncated else ack_limit
        self.status_trigger = truncated
        self.status_prohibit = self.t_status_prohibit
        self.stats.status_tx += 1
        return bytes([(ack_sn >> 8) & 0xF, ack_sn & 0xFF]) + bytes(nack_bytes)

    # ------------------------------------------------------------- STATUS RX

    def _receive_status(self, pdu: bytes):
        """decodeStatusPDU:1311 — release acked, queue NACKed ranges."""
        self.stats.status_rx += 1
        ack_sn = ((pdu[0] & 0xF) << 8) | pdu[1]
        nacks = []  # (sn, so0, so1)
        i = 2
        while i + 1 < len(pdu):
            has_so = bool(pdu[i] & 0x80)
            sn = ((pdu[i] & 0xF) << 8) | pdu[i + 1]
            i += 2
            if has_so:
                so0 = (pdu[i] << 8) | pdu[i + 1]
                so1 = (pdu[i + 2] << 8) | pdu[i + 3]
                i += 4
                nacks.append((sn, so0, so1))
            else:
                nacks.append((sn, 0, SO_END_OF_SDU))
        nack_sns = {n[0] for n in nacks}
        # release fully acked SNs in [tx_next_ack, ack_sn)
        sn = self.tx_next_ack
        guard = 0
        while sn != ack_sn and guard < self.sn_mod:
            if sn not in nack_sns:
                self.tx_buffer.pop(sn, None)
                self.retx_count.pop(sn, None)
            sn = (sn + 1) % self.sn_mod
            guard += 1
        # advance tx_next_ack to the earliest still-outstanding SN
        if nacks:
            self.tx_next_ack = min(
                nack_sns, key=lambda s: (s - self.tx_next_ack) % self.sn_mod
            )
        else:
            self.tx_next_ack = ack_sn
        # group ranges per SN: one STATUS may carry several ranges of one SN
        by_sn: dict = {}
        for sn, so0, so1 in nacks:
            by_sn.setdefault(sn, []).append((so0, so1))
        for sn, ranges in by_sn.items():
            if sn not in self.tx_buffer:
                continue
            # RETX_COUNT is incremented only for SNs waiting-for-ACK, NOT for
            # SNs already queued for retransmission and merely waiting on a
            # grant (updateRetransmissionContext:1073 waiting-for-ACK vs
            # retx-buffer split) — otherwise repeated t-Reassembly STATUSes
            # for a grant-starved SN hit max_retx without a single real retx.
            already_queued = any(e[0] == sn for e in self.retx_queue)
            if not already_queued:
                c = self.retx_count.get(sn, 0) + 1
                self.retx_count[sn] = c
                if c > self.max_retx:
                    self.tx_buffer.pop(sn, None)  # maxRetx reached -> drop
                    self.retx_queue = deque(
                        e for e in self.retx_queue if e[0] != sn
                    )
                    self.stats.dropped += 1
                    continue
            # replace any queued ranges for this SN with the latest report
            # (the reference replaces the retx context's segment ranges;
            # keeping stale entries would suppress non-overlapping NACKs)
            self.retx_queue = deque(e for e in self.retx_queue if e[0] != sn)
            for so0, so1 in ranges:
                self.retx_queue.append((sn, so0, so1))
        self.poll_retx_timer = -1

    # ---------------------------------------------------------------- timers

    def tick_1ms(self):
        if self.status_prohibit > 0:
            self.status_prohibit -= 1
        if self.rx_timer > 0:
            self.rx_timer -= 1
            if self.rx_timer == 0:
                # reassembly timer expiry: demand retransmission via STATUS
                self.status_trigger = True
                self.rx_timer = self.t_reassembly if self.rx_segs else -1
        if self.poll_retx_timer > 0:
            self.poll_retx_timer -= 1
            if self.poll_retx_timer == 0:
                # t-PollRetransmit expiry: retransmit highest unacked
                # (pollRetransmitTimerExpiry:860)
                if self.tx_buffer:
                    sn = max(
                        self.tx_buffer,
                        key=lambda s: (s - self.tx_next_ack) % self.sn_mod,
                    )
                    if not any(e[0] == sn for e in self.retx_queue):
                        self.retx_queue.append((sn, 0, SO_END_OF_SDU))
