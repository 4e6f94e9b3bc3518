"""The 19-site layout (`multi_cell(19, num_ues=10)`: the centre site and two
rings of the hexagonal grid, 10 UEs a cell) and the cross-cell banks in the
cluster form (sim/network.py `_RayBank`, ops/cdl.py `SlotChannel`, `delay_clusters`).

- (a) the grouping of rays by delay is exact: every ray's delay is its
  cluster's, padded rays and padded clusters carry no weight;
- (b) `_CrossBank.h` of destinations 0 and 18 at slots 0 and 7 against the
  float64 ray form of the benchmark's plain reference
  (isacbench/reference/channel.py), within BANK_TOL of each link's largest
  |H|. At 12 PRB the carrier spans +-2.2 MHz, too little for a phase
  rounded in float32 to show (both read ~5e-7), so the second case moves the
  same banks' subcarriers to the band edges of the full 100 MHz carrier:
  there the bank reads <= 6e-7 and the ray form with float32 phases
  ~1.1e-5, which BANK_TOL refuses;
- (c) the 19-cell banks equal the JAX package's (5 UEs, its own
  `multi_cell`): amplitudes, pathlosses and active rows exactly, slot
  responses within RDM_TOL of their maximum;
- (d) one frame of `network_simulation(multi_cell(19, num_ues=10))` at
  6 PRB / nfft 128 gives a throughput for each of the 190 UEs, and the
  ``network.bank_bytes`` count of each slot is the banks' reckoned bytes;
- (e) the runner's `bank_bytes` is the reckoned bytes of (b)'s banks: their
  constants after the build, one destination's slot response more after a
  DL cross term, and no more once the uplink has read its rows;
- (f) a 19-cell bank's whole response at a DL slot and its rows at a U slot
  equal the same fold and contraction of the host's float64 time phases
  (the bank builds them on its device, ops/cdl.py `time_phases_on`).
"""

import copy

import numpy as np
import pytest
import torch

import isac_tpu.config.params as j_params
import isac_tpu.config.scenarios as j_scenarios
import isac_tpu.sim.network as j_network
import isac_tpu_torch.config.params as t_params
import isac_tpu_torch.config.scenarios as t_scenarios
import isac_tpu_torch.sim.network as t_network
from isac_tpu_torch.ops.cdl import (
    build_cdl_link,
    delay_clusters,
    freq_phases_on,
    subcarrier_freqs,
)
from isac_tpu_torch.utils import tracing
from isacbench.reference import channel
from test_torch_cdl_device import BANK_TOL, _host_phase_form, _rel_err
from test_torch_cell import RDM_TOL

torch.set_num_threads(2)

CELLS, UES = 19, 10
TINY = dict(n_rb_override=12, nfft_override=256, enable_sensing=False, device="cpu")
# every bank holds CDL-A links (its own row is NLoS): 23 delays a link; a
# delay takes at most 20 rays, 21 in a bank with a CDL-D link (its LoS ray
# shares the first cluster's zero delay)
DELAYS, PORTS = 23, 32


def hex19(num_ues=UES):
    sim = t_scenarios.multi_cell(t_params.SimulationParameters(), num_cells=CELLS,
                                 num_ues=num_ues)
    sim.validate()
    return t_network.resolve_los_cross(t_params.assign_cell_parameters(sim), sim)


@pytest.fixture(scope="module")
def layout():
    return hex19()


@pytest.fixture(scope="module")
def runner(layout):
    """The 19-cell runner at 12 PRB with its banks built, and every bank's
    links in build order."""
    cells, cross = layout
    links = []
    orig = t_network.build_cdl_link

    def keep(*args, **kwargs):
        links.append(orig(*args, **kwargs))
        return links[-1]

    rn = t_network.SyncNetworkRunner(cells, seed=5, cross_los=cross, **TINY)
    t_network.build_cdl_link = keep
    try:
        rn._build_banks()
    finally:
        t_network.build_cdl_link = orig
    n = CELLS * UES
    return rn, [links[d * n:(d + 1) * n] for d in range(CELLS)]


def static_bytes(n_sc: int, cross: dict) -> int:
    """Every bank's constants: phases per delay, coefficients and Dopplers
    (float64) by delay, and the 14 symbol times (float64)."""
    rays = [21 if any(cross[(d, s)].any() for s in range(CELLS) if s != d) else 20
            for d in range(CELLS)]
    return sum(CELLS * UES * (n_sc * DELAYS * 8 + DELAYS * j * PORTS * 8 + DELAYS * j * 8)
               + 14 * 8 for j in rays)


def response_bytes(n_sc: int) -> int:
    return CELLS * UES * 14 * n_sc * PORTS * 8


def test_layout():
    cells, cross = hex19()
    assert len(cells) == CELLS and all(c.ue_positions.shape == (UES, 3) for c in cells)
    sites = np.asarray([c.gnb.position for c in cells])
    ring = np.round(np.linalg.norm(sites[:, :2], axis=1))
    assert ring[0] == 0 and (ring[1:7] == 500).all() and (ring[7:] >= 866).all()
    assert len(cross) == CELLS * (CELLS - 1)
    # the default leaves every existing caller's cells as they were
    five = t_scenarios.multi_cell(t_params.SimulationParameters(), num_cells=7)
    assert [five.ue[f"cell{i + 1}"].num_ues for i in range(7)] == [5] * 7
    base = t_scenarios.open_street_map_city(t_params.SimulationParameters())
    assert five.ue["cell1"] == base.ue["cell1"]


@pytest.mark.parametrize("profile, n_delays", [("CDL-A", 23), ("CDL-D", 13)])
def test_clusters_are_exact(profile, n_delays):
    """(a) on single links of unequal ray counts."""
    gnb = np.zeros((16, 3))
    gnb[:, 2] = np.arange(16) * 0.05
    links = [build_cdl_link(p, 300.0, 3.5e9, gnb, np.zeros((2, 3)), ue_velocity=3.0, seed=7 + i)
             for i, p in enumerate([profile, "CDL-A", "CDL-D"])]
    delays, index = delay_clusters([link.tau for link in links])
    assert delays.shape == (3, 23) and index.shape == (3, 460)
    assert len(np.unique(links[0].tau)) == n_delays
    for l, link in enumerate(links):
        r, n = link.tau.size, len(np.unique(link.tau))
        np.testing.assert_array_equal(delays[l, index[l, :r]], link.tau)  # exact
        assert (index[l, r:] == -1).all()  # padded rays: no cluster
        assert (delays[l, n:] == 0).all() and not np.isin(np.arange(n, 23), index[l]).any()


def test_bank_clusters_carry_no_padding_weight(runner):
    """(a) in the 19-cell banks: the coefficients and Dopplers laid out by
    delay are the link's own rays of that delay, in order; a padded ray
    slot and a padded delay carry zero; the phases are those of the delays.
    The Dopplers are the bank's device table (float64)."""
    rn, links = runner
    for d in (0, 18):
        bank = rn.banks[d]
        L, N, J, A = bank.links.coeff.shape
        assert bank.links.nu.dtype == torch.float64 and bank.links.nu.shape == (L, N * J)
        nu = bank.links.nu.cpu().numpy()
        assert (L, N, A) == (CELLS * UES, DELAYS, PORTS) and J in (20, 21)
        taus = [link.tau for link in links[d]]
        delays, _ = delay_clusters(taus)
        assert torch.equal(bank.ffc, freq_phases_on(delays, rn.sims[d].freqs, "cpu"))
        for l, link in enumerate(links[d]):
            uniq = np.unique(link.tau)
            np.testing.assert_array_equal(delays[l, :uniq.size], uniq)
            coeff = link.coeff.reshape(A, -1).T
            for n in range(N):
                rays = np.flatnonzero(link.tau == delays[l, n]) if n < uniq.size else []
                k = len(rays)
                assert torch.equal(bank.links.coeff[l, n, :k], torch.as_tensor(coeff[rays]))
                assert not bank.links.coeff[l, n, k:].any()
                np.testing.assert_array_equal(nu[l, n * J:n * J + k], link.nu[rays])
                assert (nu[l, n * J + k:(n + 1) * J] == 0).all()


def _ray_form_error(bank, links, slot, freqs, f32_phase=False) -> float:
    """The largest over links of max |dH| / max |H| between the bank's
    response and the float64 ray form; with f32_phase, of the ray form whose
    frequency phases are rounded to complex64 from a float32 angle."""
    t = slot * bank.slot_s + bank.sym_t.cpu().numpy()
    want = channel.slot_response(links, t, freqs, "cpu")
    if f32_phase:
        got = []
        for link in links:
            ang = (torch.as_tensor(-2 * np.pi * freqs, dtype=torch.float32)[:, None]
                   * torch.as_tensor(link.tau, dtype=torch.float32)[None, :])
            pf = torch.polar(torch.ones_like(ang), ang).to(torch.complex128)
            nu = torch.as_tensor(link.nu)
            pt = torch.polar(torch.ones(14, nu.numel(), dtype=torch.float64),
                             2 * np.pi * torch.as_tensor(t)[:, None] * nu)
            c = torch.as_tensor(link.coeff).to(torch.complex128)
            got.append(torch.einsum("sr,kr,abr->skab", pt, pf, c))
        got = torch.stack(got)
    else:
        got = bank.h(slot).reshape(want.shape).to(torch.complex128)
    dims = tuple(range(1, want.dim()))
    return float(((got - want).abs().amax(dims) / want.abs().amax(dims)).max())


@pytest.mark.parametrize("band", ["12prb", "full-carrier-edges"])
def test_bank_matches_float64_ray_form(runner, layout, band):
    """(b) destinations 0 and 18, slots 0 and 7."""
    rn, links = runner
    _, cross = layout
    full = subcarrier_freqs(3276, 30e3)
    edges = full[np.r_[0:72, 3276 - 72:3276]]
    for d in (0, 18):
        bank, freqs = rn.banks[d], rn.sims[d].freqs
        if band != "12prb":
            dst = copy.copy(rn.sims[d])
            dst.freqs = freqs = edges
            bank = t_network._CrossBank(dst, rn.sims, d, cross, seed=rn.seed * 131 + d * 17)
        for slot in (0, 7):
            assert bank.h(slot).shape == (CELLS, UES, 14, 144, 2, 16)
            err = _ray_form_error(bank, links[d], slot, freqs)
            assert err <= BANK_TOL, (d, slot, err)
            if band != "12prb":
                ctl = _ray_form_error(bank, links[d], slot, freqs, f32_phase=True)
                assert ctl > 3 * BANK_TOL, (d, slot, ctl)
        bank.release()


def test_bank_bytes_reckoned(runner, layout):
    """(e)."""
    rn, _ = runner
    k = rn.sims[0].n_sc
    for b in rn.banks:
        b.release()
    static = static_bytes(k, layout[1])
    assert rn.bank_bytes >= static
    assert sum(b.nbytes() for b in rn.banks) == static
    rn.bank_bytes = 0
    rn._note_bank_bytes()
    assert rn.bank_bytes == static
    states = [{"port_grid": torch.ones((16, 14, k), dtype=torch.complex64)}] * CELLS
    ext = rn._dl_ext(3, 0, states)
    assert ext.shape == (UES, 2, 14, k)
    assert rn.bank_bytes == static + response_bytes(k)
    rn.banks[3].release()
    assert sum(b.nbytes() for b in rn.banks) == static
    # the uplink's rows are not kept
    assert rn.banks[4].h_row(0, 3).shape == (UES, 14, k, 2, 16)
    assert sum(b.nbytes() for b in rn.banks) == static


def test_bank_matches_host_phases(runner):
    """(f) destination 18: h at DL slot 5, and every fourth source row at U
    slot 9, within 1e-6 of each link's largest |H|."""
    rn, _ = runner
    bank = rn.banks[18]
    want = _host_phase_form(bank, 5, slice(None))
    assert _rel_err(bank.h(5).reshape(want.shape), want) <= 1e-6
    bank.release()
    for s in range(0, CELLS, 4):
        rows = slice(s * UES, (s + 1) * UES)
        assert _rel_err(bank.h_row(9, s), _host_phase_form(bank, 9, rows)) <= 1e-6


def test_banks_equal_jax():
    """(c) at 5 UEs, every destination's bank; slot responses of a site of
    each ring."""
    runners = {}
    for port, (P, S, N) in ((False, (j_params, j_scenarios, j_network)),
                            (True, (t_params, t_scenarios, t_network))):
        sim = S.multi_cell(P.SimulationParameters(), num_cells=CELLS)
        sim.validate()
        cells, cross = N.resolve_los_cross(P.assign_cell_parameters(sim), sim)
        kw = dict(device="cpu") if port else {}
        rn = N.SyncNetworkRunner(cells, seed=3, cross_los=cross, enable_sensing=False,
                                 n_rb_override=12, nfft_override=256, **kw)
        rn._build_banks()
        runners[port] = rn
    jr, tr = runners[False], runners[True]
    for d, (jb, tb) in enumerate(zip(jr.banks, tr.banks)):
        np.testing.assert_array_equal(tb.active, jb.active)
        assert tb.active.tolist() == [s != d for s in range(CELLS)]
        np.testing.assert_array_equal(tb.pl, jb.pl)
        np.testing.assert_array_equal(tb.amp, jb.amp)
    for d in (0, 6, 18):
        jb, tb = jr.banks[d], tr.banks[d]
        for slot in (0, 7):
            want = np.asarray(jb.h(slot))
            got = tb.h(slot).numpy()
            assert got.shape == want.shape == (CELLS, 5, 14, 144, 2, 16)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=RDM_TOL * float(np.abs(want).max()))
        tb.release()


def test_one_frame_network():
    """(d)."""
    sim = t_scenarios.multi_cell(t_params.SimulationParameters(), num_cells=CELLS,
                                 num_ues=UES)
    _, cross = hex19()
    tracing.reset()
    tracing.enable()
    try:
        net = t_network.network_simulation(sim, n_rb_override=6, nfft_override=128,
                                           enable_sensing=False, device="cpu")
        recs = tracing.records()
    finally:
        tracing.disable()
        tracing.reset()
    assert len(net["cells"]) == CELLS
    dl = np.concatenate([c["communication"]["ueDLThroughputMbps"] for c in net["cells"]])
    ul = np.concatenate([c["communication"]["ueULThroughputMbps"] for c in net["cells"]])
    assert dl.shape == ul.shape == (CELLS * UES,)
    assert np.isfinite(dl).all() and np.isfinite(ul).all() and (dl > 0).any()
    assert net["network"]["dlThroughputECDF"] is not None
    slots = [r for r in recs if r.name == "network.slot"]
    counts = [r.counts.get("network.bank_bytes") for r in slots]
    assert len(slots) == 20
    assert counts == [static_bytes(72, cross) + response_bytes(72)] * 20
