"""Application traffic models (ref: +appLayer/setTrafficModel.m + MATLAB
networkTrafficOnOff/FTP/VoIP/VideoConference; SURVEY §2.9).

Deterministic-seeded host generators; `generate(elapsed_ms)` returns a list of
packets (bytes) produced in that interval. Packet payloads are pseudo-random
(content only matters for byte-exact RLC/MAC plumbing).
"""

from __future__ import annotations

import numpy as np


class OnOffTraffic:
    """On-Off source: during ON, constant rate `data_rate_kbps` in fixed-size
    packets; exponential(ish) ON/OFF holding times."""

    def __init__(self, data_rate_kbps: float, packet_size: int = 1500,
                 on_time_s: float = 1.0, off_time_s: float = 0.0, seed: int = 0):
        self.rate_bytes_per_ms = data_rate_kbps * 1000 / 8 / 1000
        self.packet_size = packet_size
        self.on_ms = max(on_time_s * 1000, 1)
        self.off_ms = off_time_s * 1000
        self.rng = np.random.default_rng(seed)
        self.state_on = True
        self.state_timer = self._draw(self.on_ms)
        self.backlog = 0.0

    def _draw(self, mean_ms):
        return float(self.rng.exponential(mean_ms)) if mean_ms > 0 else 0.0

    def generate(self, elapsed_ms: float) -> list:
        pkts = []
        t = elapsed_ms
        while t > 0:
            step = min(t, self.state_timer) if self.state_timer > 0 else t
            if self.state_on:
                self.backlog += self.rate_bytes_per_ms * step
                while self.backlog >= self.packet_size:
                    pkts.append(self.rng.bytes(self.packet_size))
                    self.backlog -= self.packet_size
            if self.state_timer > 0:
                self.state_timer -= step
                if self.state_timer <= 0:
                    if self.off_ms > 0:
                        self.state_on = not self.state_on
                        self.state_timer = self._draw(self.on_ms if self.state_on else self.off_ms)
                    else:
                        self.state_timer = self._draw(self.on_ms)
            t -= step
        return pkts


class VoIPTraffic:
    """VoIP: 20 ms frames of ~40 bytes during talk spurts, silence otherwise."""

    def __init__(self, seed: int = 0, frame_bytes: int = 40, frame_ms: float = 20.0):
        self.rng = np.random.default_rng(seed)
        self.frame_bytes = frame_bytes
        self.frame_ms = frame_ms
        self.next_frame = frame_ms
        self.talking = True
        self.spurt_timer = float(self.rng.exponential(2000))

    def generate(self, elapsed_ms: float) -> list:
        pkts = []
        self.spurt_timer -= elapsed_ms
        if self.spurt_timer <= 0:
            self.talking = not self.talking
            self.spurt_timer = float(self.rng.exponential(2000 if self.talking else 1000))
        self.next_frame -= elapsed_ms
        while self.next_frame <= 0:
            if self.talking:
                pkts.append(self.rng.bytes(self.frame_bytes))
            self.next_frame += self.frame_ms
        return pkts


class FTPTraffic:
    """FTP model 2-ish: file bursts (trunc-lognormal size) with exponential
    reading time between files, drained at line rate."""

    def __init__(self, seed: int = 0, mean_file_mb: float = 0.5,
                 reading_time_s: float = 5.0, packet_size: int = 1500):
        self.rng = np.random.default_rng(seed)
        self.packet_size = packet_size
        self.mean_file = mean_file_mb * 1e6
        self.reading_ms = reading_time_s * 1000
        self.pending = 0
        self.timer = float(self.rng.exponential(self.reading_ms))

    def generate(self, elapsed_ms: float) -> list:
        self.timer -= elapsed_ms
        if self.timer <= 0:
            self.pending += int(min(self.rng.lognormal(np.log(self.mean_file), 0.35), 5e6))
            self.timer = float(self.rng.exponential(self.reading_ms))
        pkts = []
        # drain up to 10 packets/ms into the RLC queue
        n = min(self.pending // self.packet_size, int(10 * elapsed_ms))
        for _ in range(int(n)):
            pkts.append(self.rng.bytes(self.packet_size))
            self.pending -= self.packet_size
        return pkts


class VideoConferenceTraffic:
    """Periodic video frames at `fps`, size jittered around the rate budget."""

    def __init__(self, data_rate_kbps: float = 4000, fps: float = 30, seed: int = 0,
                 max_packet: int = 1500):
        self.rng = np.random.default_rng(seed)
        self.frame_ms = 1000.0 / fps
        self.frame_bytes = data_rate_kbps * 1000 / 8 / fps
        self.next_frame = self.frame_ms
        self.max_packet = max_packet

    def generate(self, elapsed_ms: float) -> list:
        pkts = []
        self.next_frame -= elapsed_ms
        while self.next_frame <= 0:
            size = int(max(self.rng.normal(self.frame_bytes, 0.2 * self.frame_bytes), 100))
            while size > 0:
                take = min(size, self.max_packet)
                pkts.append(self.rng.bytes(take))
                size -= take
            self.next_frame += self.frame_ms
        return pkts


def make_traffic(model: str, dl: bool, params, seed: int):
    """Factory from TrafficParams (setTrafficModel.m:7-22)."""
    rate = params.dl_app_data_rate_kbps if dl else params.ul_app_data_rate_kbps
    if model == "On-Off":
        return OnOffTraffic(rate, params.packet_size_bytes, params.on_time_s,
                            params.off_time_s, seed)
    if model == "VoIP":
        return VoIPTraffic(seed)
    if model == "FTP":
        return FTPTraffic(seed)
    if model == "VideoConference":
        return VideoConferenceTraffic(min(rate, 6000), seed=seed)
    raise ValueError(f"unknown traffic model '{model}'")
