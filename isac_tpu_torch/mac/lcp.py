"""Logical Channel Prioritization per TS 38.321 §5.4.3.1.3.

Ref: macEntity.m performLCP:229-317, performLCPRound1:437, performLCPRound2:486,
getEqualShareAmongLCH:548. Two rounds: (1) serve channels up to their Bj
token-bucket budget in priority order; (2) distribute leftover grant equally
among channels that still have data.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class LogicalChannel:
    lcid: int
    priority: int = 1
    pbr_bytes_per_ms: float = 8000.0  # prioritized bit rate (8 kBps default, setRLCChannelConfig.m)
    bsd_ms: float = 10.0  # bucket size duration
    bj: float = 0.0  # token bucket (bytes)

    @property
    def bucket_max(self) -> float:
        return self.pbr_bytes_per_ms * self.bsd_ms


@dataclass
class LCPState:
    channels: list = field(default_factory=list)  # LogicalChannel, sorted by priority

    def add(self, ch: LogicalChannel):
        self.channels.append(ch)
        self.channels.sort(key=lambda c: c.priority)

    def tick_1ms(self):
        """Bj += PBR each ms, capped at bucket size (TS 38.321 §5.4.3.1.1)."""
        for ch in self.channels:
            ch.bj = min(ch.bj + ch.pbr_bytes_per_ms, ch.bucket_max)

    def allocate(self, grant_bytes: int, buffer_bytes: dict) -> dict:
        """grant_bytes across channels. buffer_bytes: lcid -> pending bytes.
        Returns lcid -> bytes to serve."""
        served = {ch.lcid: 0 for ch in self.channels}
        remaining = int(grant_bytes)
        # round 1: priority order, up to min(Bj, buffer)
        for ch in self.channels:
            if remaining <= 0:
                break
            want = min(int(max(ch.bj, 0)), buffer_bytes.get(ch.lcid, 0))
            take = min(want, remaining)
            if take > 0:
                served[ch.lcid] += take
                ch.bj -= take
                remaining -= take
        # round 2: equal share among channels with residual data
        while remaining > 0:
            hungry = [
                ch for ch in self.channels
                if buffer_bytes.get(ch.lcid, 0) - served[ch.lcid] > 0
            ]
            if not hungry:
                break
            share = max(remaining // len(hungry), 1)
            progressed = False
            for ch in hungry:
                if remaining <= 0:
                    break
                residual = buffer_bytes.get(ch.lcid, 0) - served[ch.lcid]
                take = min(share, residual, remaining)
                if take > 0:
                    served[ch.lcid] += take
                    remaining -= take
                    progressed = True
            if not progressed:
                break
        return served
