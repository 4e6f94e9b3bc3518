"""Sectorised TRxPs in the port: the M.2412 layout of 3 TRxPs a site
(`multi_cell(..., sectors=3)`, config/params.py `SectorGNBParams`) and the
gNB end of a link at a sector (ops/cdl.py `GnbSector`: TR 38.901 Table 7.3-1
element pattern, the array turned by §7.1.3's rotation, the end's angles
translated to the link's direction by §7.7.5.1).

- (a) `build_cdl_link` with a sector against the plain float64 reference
  (isacbench/reference/sector.py) over CDL-A and CDL-D, the three
  boresights, DL (gNB departs) and UL (gNB receives): within SECTOR_TOL of
  the link's largest |coeff|, delays exact, Dopplers to float64 rounding.
  The coefficients are float32 storage of a float64 computation (~5e-8);
  each planted fault (pattern left out, boresight 120 deg off, tilt left
  out, translation left out) reads at least 10 x SECTOR_TOL on every case;
- (b) the omni path is the upstream draw bit for bit: every link a 7-cell
  and a 2-cell drop draw (serving DL and UL, every bank link) equals the
  JAX package's `build_cdl_link` of the same arguments;
- (c) the 57-TRxP layout: 19 sites x 3 co-sited TRxPs, boresights 30, 150,
  270 deg, tilt 12 deg, every UE within 200 m of its site and +-60 deg of
  its boresight (geometry only);
- (d) 2 sites x 3 sectors for one frame at 6 PRB / nfft 128 through
  `SyncNetworkRunner`: every UE gets a throughput, ``antenna.sector_links``
  counts every link drawn, the runner's ``bank_draws`` stage is timed, and
  each DL cross term has its ``network.dl_term`` span.
"""

import numpy as np
import pytest
import torch

import isac_tpu.ops.cdl as j_cdl
import isac_tpu_torch.config.params as t_params
import isac_tpu_torch.config.scenarios as t_scenarios
import isac_tpu_torch.sim.cell as t_cell
import isac_tpu_torch.sim.network as t_network
from isac_tpu_torch.ops import cdl
from isac_tpu_torch.utils import tracing
from isacbench.reference import sector as ref

torch.set_num_threads(2)

# max |d coeff| / max |coeff| of a link: float32 storage of a float64
# computation reads ~5e-8; the planted faults read >= 10x this
SECTOR_TOL = 1e-5
LAM = 299792458.0 / 3.5e9
GNB = t_params.ULA(n_v=8, polarizations=2).element_positions(LAM)
UE = np.stack([np.zeros(2), np.arange(2) * 0.5 * LAM, np.zeros(2)], -1)
CASES = [(p, b, e) for p in ("CDL-A", "CDL-D") for b in (30.0, 150.0, 270.0)
         for e in ("tx", "rx")]


def _case(boresight: float, end: str, site=(120.0, -40.0)):
    """A TRxP of the boresight at `site`, 30 m up, and a UE 25 deg off its
    boresight 140 m away: the program's GnbSector and the positions."""
    gnb = t_params.SectorGNBParams(position=(*site, 30.0), boresight_deg=boresight)
    az = np.deg2rad(boresight + 25.0)
    ue_pos = np.array([site[0] + 140.0 * np.cos(az), site[1] + 140.0 * np.sin(az), 1.5])
    sec = cdl.gnb_sector(gnb, ue_pos, end)
    return sec, ((GNB, UE) if end == "tx" else (UE, GNB))


def _error(profile, boresight, end, sec=None) -> float:
    good, (tx, rx) = _case(boresight, end)
    link = cdl.build_cdl_link(profile, 300.0, 3.5e9, tx, rx, ue_velocity=0.43, seed=11,
                              sector=sec or good)
    coeff, tau, nu = ref.sector_link(profile, 300.0, 3.5e9, tx, rx, 0.43, 11, boresight, 12.0,
                                     good.azimuth_deg, good.zenith_deg, end)
    np.testing.assert_array_equal(link.tau, tau.numpy())
    np.testing.assert_allclose(link.nu, nu.numpy(), rtol=1e-12, atol=1e-12)
    want = coeff.numpy()
    return float(np.abs(link.coeff - want).max() / np.abs(want).max())


@pytest.mark.parametrize("profile, boresight, end", CASES)
def test_sector_link_matches_reference(profile, boresight, end):
    """(a)."""
    sec, _ = _case(boresight, end)
    assert (sec.end, sec.boresight_deg, sec.downtilt_deg) == (end, boresight, 12.0)
    assert sec.azimuth_deg == pytest.approx((boresight + 25.0 + 180.0) % 360.0 - 180.0)
    assert sec.zenith_deg == pytest.approx(90.0 + np.degrees(np.arctan(28.5 / 140.0)))
    assert _error(profile, boresight, end) <= SECTOR_TOL


def _pattern_left_out(mp, sec):
    mp.setattr(cdl, "sector_pattern_db", lambda zen, az: np.zeros_like(zen))
    return sec


def _translation_left_out(mp, sec):
    mp.setattr(cdl, "translate_angles", lambda angles, *args: angles)
    return sec


FAULTS = {
    "pattern_left_out": _pattern_left_out,
    "boresight_off_120": lambda mp, sec: cdl.GnbSector(
        sec.end, sec.boresight_deg + 120.0, sec.downtilt_deg, sec.azimuth_deg, sec.zenith_deg),
    "tilt_left_out": lambda mp, sec: cdl.GnbSector(
        sec.end, sec.boresight_deg, 0.0, sec.azimuth_deg, sec.zenith_deg),
    "translation_left_out": _translation_left_out,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_reads_over(fault, monkeypatch):
    """(a): each fault, on every case."""
    errors = []
    for profile, boresight, end in CASES:
        with monkeypatch.context() as mp:
            sec = FAULTS[fault](mp, _case(boresight, end)[0])
            errors.append(_error(profile, boresight, end, sec))
    assert min(errors) >= 10 * SECTOR_TOL, (fault, errors)


def test_pattern_and_rotation():
    """The element pattern's published points and the sector's rotation."""
    zen = np.array([90.0, 90.0, 90.0, 155.0, 90.0, 180.0])
    az = np.array([0.0, 32.5, -32.5, 0.0, 180.0, 180.0])
    np.testing.assert_allclose(cdl.sector_pattern_db(zen, az),
                               [0.0, -3.0, -3.0, -12.0, -30.0, -30.0], atol=1e-12)
    rot = cdl.sector_rotation(150.0, 12.0)
    bore = rot @ np.array([1.0, 0.0, 0.0])  # the local boresight, globally
    assert np.degrees(np.arctan2(bore[1], bore[0])) == pytest.approx(150.0)
    assert np.degrees(np.arccos(bore[2])) == pytest.approx(102.0)
    np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-15)
    assert cdl.gnb_sector(t_params.GNBParams(), np.array([50.0, 0.0, 1.5]), "tx") is None


@pytest.mark.parametrize("num_cells", [7, 2])
def test_omni_links_are_the_upstream_draw(num_cells):
    """(b) through the port's call sites (engines and banks)."""
    sim = t_scenarios.multi_cell(t_params.SimulationParameters(), num_cells=num_cells)
    assert sim.bs == t_scenarios.multi_cell(t_params.SimulationParameters(),
                                            num_cells=num_cells, sectors=1).bs
    assert all(type(g) is t_params.GNBParams for g in sim.bs.values())
    sim.validate()
    cells, cross = t_network.resolve_los_cross(t_params.assign_cell_parameters(sim), sim)
    calls = []

    def keep(*args, **kwargs):
        calls.append((args, kwargs, orig(*args, **kwargs)))
        return calls[-1][2]

    orig = cdl.build_cdl_link
    try:
        t_cell.build_cdl_link = t_network.build_cdl_link = keep
        rn = t_network.SyncNetworkRunner(cells, seed=3, cross_los=cross, enable_sensing=False,
                                         n_rb_override=6, nfft_override=128, device="cpu")
        rn._build_banks()
    finally:
        t_cell.build_cdl_link = t_network.build_cdl_link = orig
    assert len(calls) == num_cells * 10 + num_cells * num_cells * 5
    for args, kwargs, link in calls:
        assert kwargs.pop("sector") is None
        want = j_cdl.build_cdl_link(*args, **kwargs)
        for f in ("coeff", "tau", "nu"):
            np.testing.assert_array_equal(getattr(link, f), getattr(want, f))


def test_57_trxp_layout():
    """(c)."""
    sim = t_scenarios.multi_cell(t_params.SimulationParameters(), num_cells=19, num_ues=10,
                                 sectors=3, seed=20261018)
    sim.validate()
    cells = t_params.assign_cell_parameters(sim)
    assert len(cells) == 57
    sites = t_scenarios.multi_cell(t_params.SimulationParameters(), num_cells=19)
    for k, cell in enumerate(cells):
        gnb = cell.gnb
        assert isinstance(gnb, t_params.SectorGNBParams) and gnb.cell_id == k + 1
        assert gnb.position == sites.bs[f"cell{k // 3 + 1}"].position
        assert (gnb.boresight_deg, gnb.downtilt_deg) == (30.0 + 120.0 * (k % 3), 12.0)
        assert sim.ue[cell.name].seed == 20261018 + k and cell.ue_positions.shape == (10, 3)
        rel = cell.ue_positions[:, :2] - np.asarray(gnb.position[:2])
        assert (np.hypot(rel[:, 0], rel[:, 1]) <= 200.0).all()
        off = (np.degrees(np.arctan2(rel[:, 1], rel[:, 0])) - gnb.boresight_deg + 180) % 360 - 180
        assert (np.abs(off) <= 60.0).all(), (k, off)
    with pytest.raises(ValueError):
        t_scenarios.multi_cell(t_params.SimulationParameters(), sectors=2)


def test_two_sites_three_sectors_one_frame():
    """(d)."""
    sim = t_scenarios.multi_cell(t_params.SimulationParameters(), num_cells=2, num_ues=2,
                                 sectors=3)
    sim.validate()
    cells, cross = t_network.resolve_los_cross(t_params.assign_cell_parameters(sim), sim)
    drawn = []

    def keep(*args, **kwargs):
        drawn.append(kwargs["sector"])
        return orig(*args, **kwargs)

    orig = cdl.build_cdl_link
    tracing.reset()
    tracing.enable()
    try:
        t_cell.build_cdl_link = t_network.build_cdl_link = keep
        rn = t_network.SyncNetworkRunner(cells, seed=5, cross_los=cross, enable_sensing=False,
                                         n_rb_override=6, nfft_override=128, device="cpu")
        results = rn.run()
        recs = tracing.records()
    finally:
        t_cell.build_cdl_link = t_network.build_cdl_link = orig
        tracing.disable()
        tracing.reset()
    n = 6 * 2 * 2 + 6 * 6 * 2  # serving DL and UL, and 6 banks of 6 x 2 links
    assert len(drawn) == n and all(s is not None for s in drawn)
    assert sum(r.counts.get("antenna.sector_links", 0) for r in recs) == n
    draws = [r for r in recs if r.name == "network.bank_draws"]
    assert [r.attrs["links"] for r in draws] == [12] * 6
    assert rn.stage_s["bank_draws"] > 0
    terms = [r for r in recs if r.name == "network.dl_term"]
    assert terms and all(r.attrs == dict(sources=6, ues=2, subcarriers=72, rx=2, tx=16)
                         for r in terms)
    dl = np.concatenate([r["communication"]["ueDLThroughputMbps"] for r in results])
    ul = np.concatenate([r["communication"]["ueULThroughputMbps"] for r in results])
    assert dl.shape == ul.shape == (12,)
    assert np.isfinite(dl).all() and np.isfinite(ul).all() and (dl > 0).any()
