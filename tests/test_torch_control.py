"""The port's host control plane against isac_tpu's, driven the same way.

Traffic models, RLC UM/AM, LCP, MAC PDUs and BSR, HARQ, the scheduler, the
KPI collector, the scheduling logger and the MAC PCAP writer are host numpy
and Python on both sides. Each test runs one function over both packages with
the same seeded inputs (SDUs, grants, losses, CSI reports, HARQ feedback,
timer ticks) and compares everything the runs produced — packets, PDU bytes,
STATUS PDUs, delivered SDUs, grants, counters, KPIs, file bytes — exactly.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import isac_tpu.app.traffic as j_traffic
import isac_tpu.config.params as j_params
import isac_tpu.mac.harq as j_harq
import isac_tpu.mac.lcp as j_lcp
import isac_tpu.mac.pdu as j_pdu
import isac_tpu.mac.scheduler as j_scheduler
import isac_tpu.metrics.kpi as j_kpi
import isac_tpu.metrics.logger as j_logger
import isac_tpu.rlc.am as j_am
import isac_tpu.rlc.um as j_um
import isac_tpu_torch.app.traffic as t_traffic
import isac_tpu_torch.config.params as t_params
import isac_tpu_torch.mac.harq as t_harq
import isac_tpu_torch.mac.lcp as t_lcp
import isac_tpu_torch.mac.pdu as t_pdu
import isac_tpu_torch.mac.scheduler as t_scheduler
import isac_tpu_torch.metrics.kpi as t_kpi
import isac_tpu_torch.metrics.logger as t_logger
import isac_tpu_torch.rlc.am as t_am
import isac_tpu_torch.rlc.um as t_um

JAX = SimpleNamespace(traffic=j_traffic, params=j_params, harq=j_harq, lcp=j_lcp, pdu=j_pdu,
                      scheduler=j_scheduler, kpi=j_kpi, logger=j_logger, am=j_am, um=j_um)
PORT = SimpleNamespace(traffic=t_traffic, params=t_params, harq=t_harq, lcp=t_lcp, pdu=t_pdu,
                       scheduler=t_scheduler, kpi=t_kpi, logger=t_logger, am=t_am, um=t_um)


def _canon(x):
    """A comparable form: arrays keep dtype and shape, dataclasses become dicts."""
    if isinstance(x, np.ndarray):
        dt = x.dtype.str
        if x.dtype.kind == "f":  # NaN marks "no value" and must compare equal
            x = np.where(np.isnan(x), None, x.astype(object))
        return ("nd", dt, x.shape, x.tolist())
    if isinstance(x, np.generic):
        return ("np", x.dtype.str, x.item())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, _canon(dataclasses.asdict(x)))
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    if isinstance(x, (bytes, bytearray)):
        return bytes(x)
    if isinstance(x, float) and np.isnan(x):
        return "nan"
    return x


def _same(drive, *args):
    a, b = drive(JAX, *args), drive(PORT, *args)
    assert len(a) > 0
    assert _canon(a) == _canon(b)
    return a


# ----------------------------------------------------------------- traffic


def _drive_traffic(ns, model, dl, seed):
    tp = ns.params.TrafficParams(model=model, dl_app_data_rate_kbps=20e3,
                                 ul_app_data_rate_kbps=3e3, on_time_s=0.05, off_time_s=0.03)
    src = ns.traffic.make_traffic(model, dl, tp, seed)
    # FTP waits 5 s on average between files: longer steps reach a few files
    lens = [10.0, 25.0, 40.0] if model == "FTP" else [0.5, 1.0, 2.0, 3.5]
    steps = np.random.default_rng(seed).choice(lens, 300)
    return [src.generate(float(ms)) for ms in steps]


@pytest.mark.parametrize("model", ["On-Off", "VoIP", "FTP", "VideoConference"])
@pytest.mark.parametrize("dl", [True, False])
def test_traffic_models_equal(model, dl):
    out = _same(_drive_traffic, model, dl, 7)
    assert sum(len(p) for p in out) > 0


# --------------------------------------------------------------------- RLC


def _sdus(rng, n, lo=20, hi=2500):
    return [rng.integers(0, 256, int(rng.integers(lo, hi)), dtype=np.uint8).tobytes()
            for _ in range(n)]


def _drive_um(ns, seed, loss):
    rng = np.random.default_rng(seed)
    tx, rx = ns.um.UMEntity(), ns.um.UMEntity()
    log = []
    for ms in range(400):
        if ms < 300:
            for sdu in _sdus(rng, int(rng.integers(0, 3))):
                tx.enqueue_sdu(sdu)
        pdus = tx.send_pdus(int(rng.integers(0, 4000)))
        kept = [p for p in pdus if rng.random() >= loss]
        if len(kept) > 1 and rng.random() < 0.3:
            kept = kept[::-1]  # out-of-order arrival
        delivered = [rx.receive_pdu(p) for p in kept]
        tx.tick_1ms()
        rx.tick_1ms()
        log.append((pdus, delivered, tx.buffer_status()))
    log.append((tx.stats, rx.stats))
    return log


@pytest.mark.parametrize("seed,loss", [(1, 0.0), (2, 0.15), (3, 0.4)])
def test_rlc_um_equal(seed, loss):
    _same(_drive_um, seed, loss)


def _drive_am(ns, seed, loss):
    """Two AM entities: data a -> b over a lossy link, STATUS b -> a (also
    lossy, budget-bounded), polling and both timers running."""
    rng = np.random.default_rng(seed)
    a = ns.am.AMEntity(poll_pdu=4, t_poll_retransmit_ms=15, t_reassembly_ms=10)
    b = ns.am.AMEntity(poll_pdu=4, t_poll_retransmit_ms=15, t_reassembly_ms=10)
    log = []
    for ms in range(500):
        if ms < 350:
            for sdu in _sdus(rng, int(rng.integers(0, 3))):
                a.enqueue_sdu(sdu)
        pdus = a.send_pdus(int(rng.integers(0, 5000)))
        delivered = [b.receive_pdu(p) for p in pdus if rng.random() >= loss]
        status = b.status_pdu(budget=int(rng.integers(3, 60))) if b.status_trigger else None
        if status is not None and rng.random() >= loss / 2:
            a.receive_pdu(status)
        a.tick_1ms()
        b.tick_1ms()
        log.append((pdus, delivered, status, a.buffer_status(), len(a.tx_buffer),
                    sorted(a.retx_queue), b.rx_next))
    log.append((a.stats, b.stats, sorted(a.tx_buffer), a.tx_next_ack))
    return log


@pytest.mark.parametrize("seed,loss", [(4, 0.0), (5, 0.1), (6, 0.3)])
def test_rlc_am_equal(seed, loss):
    log = _same(_drive_am, seed, loss)
    if loss:
        assert any(entry[2] is not None for entry in log[:-1])  # STATUS PDUs flowed


# --------------------------------------------------------------------- MAC


def _drive_lcp(ns, seed):
    rng = np.random.default_rng(seed)
    st = ns.lcp.LCPState()
    for lcid, prio, pbr in ((4, 2, 500.0), (5, 1, 2000.0), (6, 3, 100.0)):
        st.add(ns.lcp.LogicalChannel(lcid=lcid, priority=prio, pbr_bytes_per_ms=pbr))
    log = []
    for _ in range(200):
        bufs = {lcid: int(rng.integers(0, 20000)) for lcid in (4, 5, 6)}
        log.append((st.allocate(int(rng.integers(0, 30000)), bufs),
                    [c.bj for c in st.channels]))
        st.tick_1ms()
    return log


def test_lcp_equal():
    _same(_drive_lcp, 8)


def _drive_pdu(ns, seed):
    rng = np.random.default_rng(seed)
    log = [[ns.pdu.bsr_index(n) for n in (0, 1, 10, 11, 100, 5000, 10**6, 10**9)],
           [ns.pdu.bsr_bytes(i) for i in range(32)]]
    for _ in range(60):
        sdus = [(int(rng.choice([1, 4, 5, 32])), p) for p in _sdus(rng, int(rng.integers(0, 5)), 1, 400)]
        control = [ns.pdu.short_bsr(int(rng.integers(0, 8)), int(rng.integers(0, 10**5))),
                   ns.pdu.long_bsr({int(g): int(rng.integers(0, 10**6)) for g in range(int(rng.integers(1, 8)))})]
        control = control[: int(rng.integers(0, 3))]
        size = (sum(len(ns.pdu.subpdu(lcid, p)) for lcid, p in sdus)
                + sum(len(c) for c in control) + int(rng.integers(0, 80)))
        pdu = ns.pdu.build_mac_pdu(sdus, size, control=control)
        log.append((pdu, ns.pdu.parse_mac_pdu(pdu), ns.pdu.subpdu(4, sdus[0][1] if sdus else b"")))
    return log


def test_mac_pdu_and_bsr_equal():
    _same(_drive_pdu, 9)


def _drive_harq(ns, seed):
    rng = np.random.default_rng(seed)
    h = ns.harq.HarqState(n_ues=3, n_harq=4)
    log = []
    for _ in range(300):
        ue = int(rng.integers(0, 3))
        op = rng.random()
        pid = h.free_process(ue)
        if op < 0.4 and pid is not None:
            h.new_tx(ue, pid, int(rng.integers(100, 9000)), int(rng.integers(0, 28)),
                     int(rng.integers(1, 51)), None, n_sym=int(rng.choice([4, 14])))
        elif op < 0.6:
            ids = np.nonzero(h.need_retx[ue])[0]
            if ids.size:
                h.retx(ue, int(ids[0]))
        else:
            ids = np.nonzero(h.pending[ue])[0]
            if ids.size:
                p = int(ids[0])
                log.append(("fb", h.feedback(ue, p, bool(rng.random() < 0.6)), h.rv(ue, p)))
        log.append((pid, h.ndi, h.rv_idx, h.pending, h.need_retx, h.tx_count))
    return log


def test_harq_equal():
    _same(_drive_harq, 10)


def _drive_scheduler(ns, strategy, max_rank, table, seed):
    rng = np.random.default_rng(seed)
    n_ues, n_rb = 4, 51
    s = ns.scheduler.Scheduler(n_ues, n_rb, strategy=strategy, max_rank=max_rank,
                               mcs_table=table, n_harq=4, max_rb_per_ue=30)
    log = []
    inflight = []
    for slot in range(60):
        for u in range(n_ues):
            if rng.random() < 0.3:
                s.update_dl_csi(u, rng.integers(1, 16, n_rb), int(rng.integers(1, max_rank + 1)),
                                rng.integers(0, 16, 4))
            if rng.random() < 0.3:
                s.update_ul_csi(u, rng.integers(1, 16, n_rb), int(rng.integers(1, max_rank + 1)),
                                int(rng.integers(0, 6)))
            s.update_buffer(u, "DL", int(rng.integers(0, 60000)))
            s.update_buffer(u, "UL", int(rng.integers(0, 20000)))
        for direction in ("DL", "UL"):
            n_sym, sym_start = (14, 0) if slot % 3 else (4, int(rng.choice([0, 4, 8])))
            grants = s.schedule_slot(slot, direction, n_sym=n_sym, sym_start=sym_start)
            log.append(grants)
            inflight += [(g.ue, direction, g.harq_id) for g in grants]
        done, inflight = inflight[: len(inflight) // 2], inflight[len(inflight) // 2:]
        log.append([s.harq_feedback(u, d, h, bool(rng.random() < 0.7)) for u, d, h in done])
        log.append([(c.served_dl, c.served_ul, c.olla_dl, c.olla_ul) for c in s.ues])
    return log


@pytest.mark.parametrize("strategy", ["RR", "PF", "BestCQI"])
@pytest.mark.parametrize("max_rank,table", [(2, "qam64"), (4, "qam256")])
def test_scheduler_equal(strategy, max_rank, table):
    log = _same(_drive_scheduler, strategy, max_rank, table, 11)
    assert any(g.is_retx for entry in log for g in entry if hasattr(g, "is_retx"))


# ------------------------------------------------------------ KPIs and logs


def _drive_metrics(ns, seed, path):
    rng = np.random.default_rng(seed)
    n_ues, n_slots, n_rb = 3, 40, 24
    m = ns.kpi.CellMetrics(n_ues=n_ues, bandwidth_hz=20e6, duration_s=0.02)
    lg = ns.logger.SchedulingLogger(n_slots, n_ues, n_rb)
    pcap = ns.logger.MacPcapWriter(str(path), tdd=bool(seed % 2))
    for slot in range(n_slots + 2):
        for u in range(n_ues):
            d = "DL" if rng.random() < 0.6 else "UL"
            tbs = int(rng.integers(100, 20000))
            retx = bool(rng.random() < 0.2)
            ok = bool(rng.random() < 0.8)
            prbs = sorted(rng.choice(n_rb, int(rng.integers(1, n_rb)), replace=False).tolist())
            m.on_tx(d, u, tbs, retx)
            m.on_crc(d, u, tbs, ok)
            m.on_sdu_delivered(d, u, int(rng.integers(0, 3000)))
            if rng.random() < 0.05:
                m.on_harq_drop(d, u)
            m.log_slot(slot, dir=d, ue=u, tbs=tbs, crc=ok)
            lg.log_grant(slot, d, u, prbs, int(rng.integers(0, 28)), tbs, int(rng.choice([0, 2, 3, 1])),
                         int(rng.integers(0, 16)), int(rng.integers(1, 3)), retx,
                         sym_start=int(rng.choice([0, 4])), n_sym=int(rng.choice([4, 14])))
            lg.log_crc(slot, d, u, ok)
            if rng.random() < 0.3:
                lg.log_csi(slot, d, u, rng.integers(0, 16, n_rb))
            pdu = rng.integers(0, 256, int(rng.integers(1, 200)), dtype=np.uint8).tobytes()
            pcap.write(pdu, rnti=u + 1, ueid=u, harq_id=int(rng.integers(0, 16)),
                       frame=slot // 20, slot=slot % 20, is_dl=d == "DL", t_s=slot * 5e-4)
    pcap.save()
    return [m.finalize(peak_se_dl=4.5, peak_se_ul=2.1), lg.finalize(),
            ns.kpi.peak_spectral_efficiency(2, 8, 0.7), ns.kpi.ecdf(rng.normal(size=50)),
            pcap.n_packets, path.read_bytes()]


@pytest.mark.parametrize("seed", [12, 13])
def test_kpi_logger_pcap_equal(seed, tmp_path):
    a = _drive_metrics(JAX, seed, tmp_path / "jax.pcap")
    b = _drive_metrics(PORT, seed, tmp_path / "port.pcap")
    assert _canon(a) == _canon(b)
    assert len(b[-1]) > 1000
