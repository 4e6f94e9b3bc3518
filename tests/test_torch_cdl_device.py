"""The CDL ray frequency phases built on the device (ops/cdl.py
`freq_phases_on`) against the host's float64 `freq_phases`, the slow-time
phases (`time_phases_on`) against the host's `time_phases`, and the one slot
response built from them (ops/cdl.py `SlotChannel`, `cluster_response`).

On the CPU: CDL-A and CDL-D delays at 300 ns with padded zero-delay rays over
a slice of the full carrier's subcarriers; block sizes that do not divide
the tensor; and, at 12 PRB, every engine's and every bank's phases of an
engine and a 3-cell network, with the ``rays.device_phases`` count. The
time phases of CDL-A and CDL-D Dopplers at 30 m/s padded with zero rays to a
bank's width, at slot 0 and at the last slot of a 200-frame timeline; a
3-cell network's bank responses (`h`, `h_row`) against the same fold and
contraction of host phases, with no NumPy array made a tensor during a
response and one ``rays.device_time_phases`` count per response, the
engines' and the banks'; an engine's DL and UL responses and the one-link
`cdl_frequency_response` against the float64 ray form of the benchmark's
plain reference (isacbench/reference/channel.py), within BANK_TOL.

On the card (marker ``card``; this file imports no JAX, so run it there with
``python -m pytest --noconftest tests/test_torch_cdl_device.py -m card -s``):
the full width [5, 3276, 460] and the memory it takes beyond its output.
"""

import numpy as np
import pytest
import torch

from isac_tpu_torch.config.carrier import ofdm_info
from isac_tpu_torch.ops import cdl
from isac_tpu_torch.ops.cdl import (
    batched_frequency_response,
    build_cdl_link,
    cdl_frequency_response,
    freq_phases,
    freq_phases_on,
    stack_links,
    subcarrier_freqs,
    time_phases,
    time_phases_on,
)
from isac_tpu_torch.utils import tracing
from isacbench.reference import channel

CPU = dict(n_rb_override=12, nfft_override=256, device="cpu")
FULL_FREQS = subcarrier_freqs(3276, 30e3)
F32_EPS = 2.0 ** -23
_INFO = ofdm_info(273, 30)
SYM_T = _INFO.symbol_starts(1, 0).astype(np.float64) / _INFO.sample_rate  # [14] s
SLOT_S = 0.5e-3
# a slot response against the float64 ray form: max |dH| / max |H| of each
# link (tests/test_torch_network_hex19.py: a float32 frequency phase at the
# full carrier's band edges reads ~1.1e-5, the device's float64 one <= 6e-7)
BANK_TOL = 3e-6


@pytest.fixture
def clean():
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _padded(attr: str, profiles, n_rays: int, speed: float = 3.0) -> np.ndarray:
    """[L, n_rays] float64: each profile's ray delays (`tau`) or Dopplers
    (`nu`) at 300 ns and `speed` m/s, zero-padded to n_rays as stack_links
    pads them."""
    gnb = np.zeros((16, 3))
    gnb[:, 2] = np.arange(16) * 0.05
    ue = np.zeros((2, 3))
    rows = []
    for i, p in enumerate(profiles):
        x = getattr(build_cdl_link(p, 300.0, 3.5e9, gnb, ue, ue_velocity=speed, seed=11 + i), attr)
        rows.append(np.pad(x, (0, n_rays - x.size)))
    return np.stack(rows)


def _delays(profiles, n_rays: int) -> np.ndarray:
    return _padded("tau", profiles, n_rays)


def _assert_close_to_host(got: torch.Tensor, want: np.ndarray):
    """At most one float32 ulp apart per part, and at least 99.99% bit-equal."""
    g = torch.view_as_real(got.cpu()).numpy()
    w = np.stack([want.real, want.imag], axis=-1)
    assert g.shape == w.shape and g.dtype == w.dtype == np.float32
    diff = np.abs(g.astype(np.float64) - w)
    assert diff.max() <= F32_EPS
    assert (diff <= np.spacing(np.abs(w))).all()
    assert (g == w).mean() >= 0.9999


@pytest.mark.parametrize("profile", ["CDL-A", "CDL-D"])
def test_matches_host_phases(profile):
    tau = _delays([profile, profile, "CDL-A"], 480)  # CDL-D's 261 rays padded
    assert (tau == 0).sum(axis=-1).min() >= 20
    freqs = FULL_FREQS[np.r_[0:3276:9, 3275]]  # both band edges: the largest phases
    got = freq_phases_on(tau, freqs, "cpu")
    assert got.dtype == torch.complex64 and got.shape == (3, freqs.size, 480)
    _assert_close_to_host(got, freq_phases(tau, freqs))


@pytest.mark.parametrize("n_links, sc", [(1, slice(None)), (64, slice(None, None, 89))],
                         ids=["subcarrier-blocks", "link-blocks"])
def test_blocks_that_do_not_divide(n_links, sc):
    """One full-width link is more than a block (blocks of 2279 and 997
    subcarriers); 64 links of 37 subcarriers are 61 links a block and 3 over.
    Every block is written, one link without a leading axis too."""
    tau = _delays((["CDL-A", "CDL-D"] * 32)[:n_links], 460)
    freqs = FULL_FREQS[sc]
    assert (n_links * freqs.size * 460) % cdl._PHASE_BLOCK
    got = freq_phases_on(tau, freqs, "cpu")
    _assert_close_to_host(got, freq_phases(tau, freqs))
    one = freq_phases_on(tau[-1], freqs, "cpu")
    assert one.shape == (freqs.size, 460) and torch.equal(one, got[-1])


def test_engine_and_banks_build_on_device(clean, monkeypatch):
    """Every frequency phase table of an engine and of a 3-cell network's
    banks (L x K x N, one phase a link, subcarrier and delay) is built by
    freq_phases_on, lies within one float32 ulp of the host's phases of the
    same delays, and is counted as rays.device_phases."""
    from isac_tpu_torch.config import params, scenarios
    from isac_tpu_torch.sim import cell as cell_mod
    from isac_tpu_torch.sim import network as net_mod

    torch.set_num_threads(2)
    built = []

    def spy(tau, freqs, device):
        out = freq_phases_on(tau, freqs, device)
        built.append((np.array(tau), np.array(freqs), out))
        return out

    monkeypatch.setattr(cdl, "freq_phases_on", spy)

    sim = scenarios.multi_cell(params.SimulationParameters(), num_cells=3)
    sim.validate()
    cells = params.assign_cell_parameters(sim)
    tracing.enable()
    engine = cell_mod.CellSimulator(cells[0], seed=2, enable_sensing=False, **CPU)
    runner = net_mod.SyncNetworkRunner(cells, seed=4, enable_sensing=False, **CPU)
    runner._build_banks()
    tracing.disable()

    ffs = [s._channel[d].ffc for s in [engine, *runner.sims] for d in ("DL", "UL")]
    ffs += [b.ffc for b in runner.banks]
    assert len(ffs) == len(built) == 2 * 4 + 3
    assert [id(ff) for ff in ffs] == [id(out) for _, _, out in built]
    for tau, freqs, out in built:
        assert out.device == engine.dev and out.shape == (tau.shape[0], freqs.size, tau.shape[1])
        _assert_close_to_host(out, freq_phases(tau, freqs))
    counted = sum(r.counts.get("rays.device_phases", 0) for r in tracing.records())
    assert counted == sum(ff.numel() for ff in ffs)
    rays = {r.name for r in tracing.records() if "rays.device_phases" in r.counts}
    assert rays == {"build.engine.rays", "network.banks"}


@pytest.mark.parametrize("slot", [0, 3999], ids=["slot-0", "slot-3999"])
@pytest.mark.parametrize("profile", ["CDL-A", "CDL-D"])
def test_time_phases_match_host(clean, profile, slot):
    """Dopplers of up to 350 Hz laid out to a hex19 bank's 23 delays x 21
    rays (CDL-D's 261 rays and CDL-A's 460 padded with zero rays); slot 3999
    ends a 200-frame timeline, ~4400 rad: the largest angles."""
    nu = _padded("nu", [profile, profile, "CDL-A"], 483, speed=30.0)
    assert (nu == 0).sum(axis=-1).min() >= 23 and np.abs(nu).max() > 300
    tracing.enable()
    with tracing.span("probe"):
        got = time_phases_on(torch.as_tensor(nu), torch.as_tensor(SYM_T) + slot * SLOT_S)
    tracing.disable()
    assert got.dtype == torch.complex64 and got.shape == (3, 14, 483)
    _assert_close_to_host(got, time_phases(nu, slot * SLOT_S + SYM_T))
    assert (got[:, :, nu[0] == 0][0] == 1).all()  # a zero ray's phase is exactly 1
    counted = [r.counts for r in tracing.records() if r.name == "probe"]
    assert counted == [{"rays.device_time_phases": 3 * 14 * 483}]


@pytest.fixture(scope="module")
def network():
    """A 3-cell network at 12 PRB with its banks built (TDD DDDSU: slot 4
    is U)."""
    from isac_tpu_torch.config import params, scenarios
    from isac_tpu_torch.sim import network as net_mod

    torch.set_num_threads(2)
    sim = scenarios.multi_cell(params.SimulationParameters(), num_cells=3)
    sim.validate()
    runner = net_mod.SyncNetworkRunner(params.assign_cell_parameters(sim), seed=6,
                                       enable_sensing=False, **CPU)
    runner._build_banks()
    return runner


@pytest.fixture(scope="module")
def banks(network):
    return network.banks


def _host_phase_form(bank, slot: int, links: slice) -> torch.Tensor:
    """A bank's (a SlotChannel's) fold and contraction with the time phases
    of the host's time_phases, uploaded as they were before the bank built
    them."""
    n_rx, n_tx = bank.links.ports
    t = slot * bank.slot_s + bank.sym_t.cpu().numpy()
    ft = torch.as_tensor(time_phases(bank.links.nu[links].cpu().numpy(), t), device=bank.dev)
    ffc, cn = bank.ffc[links], bank.links.coeff[links]
    L, N, J, A = cn.shape
    g = torch.matmul(ft.view(L, 14, N, J).transpose(1, 2), cn)
    h = torch.matmul(ffc, g.view(L, N, 14 * A))
    return h.view(L, ffc.shape[1], 14, n_rx, n_tx).transpose(1, 2)


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest over links of max |dH| / max |H|."""
    d = (got - want).abs().flatten(1).amax(1) / want.abs().flatten(1).amax(1)
    return float(d.max())


@pytest.mark.parametrize("slot", [2, 79], ids=["dl-slot-2", "u-slot-79"])
def test_bank_responses_match_host_phases(banks, slot):
    """h(slot) and every source row h_row(slot, s) of each bank against the
    host-phase form of the same fold and contraction; slot 79 is the U slot
    that ends hex7's four frames."""
    for bank in banks:
        L, U = bank.links.coeff.shape[0], bank.n_ues
        bank.release()
        h = bank.h(slot)
        assert h.shape == (bank.n_cells, U, 14, bank.ffc.shape[1], *bank.links.ports)
        assert _rel_err(h.reshape(L, *h.shape[2:]), _host_phase_form(bank, slot, slice(None))) <= 1e-6
        for s in range(bank.n_cells):
            rows = slice(s * U, (s + 1) * U)
            row = bank.h_row(slot, s)
            assert _rel_err(row, _host_phase_form(bank, slot, rows)) <= 1e-6
            assert torch.equal(row, h[s])  # the same phases and products, row by row
        bank.release()


def test_response_makes_no_tensor_of_numpy(banks, monkeypatch):
    """A slot response, whole or a row, converts no NumPy array to a tensor
    and calls no NumPy exp: its time phases come from the device tables."""
    bank = banks[1]
    bank.release()
    made = []
    for name in ("as_tensor", "from_numpy", "tensor"):
        def spy(*args, _orig=getattr(torch, name), _name=name, **kwargs):
            if any(isinstance(a, np.ndarray) for a in args):
                made.append(_name)
            return _orig(*args, **kwargs)
        monkeypatch.setattr(torch, name, spy)
    np_exp = np.exp
    monkeypatch.setattr(np, "exp", lambda *a, **k: made.append("np.exp") or np_exp(*a, **k))
    bank.h(4)
    bank.h_row(4, 2)
    monkeypatch.undo()
    bank.release()
    assert made == []
    assert bank.links.nu.dtype == bank.sym_t.dtype == torch.float64
    assert bank.links.nu.device == bank.sym_t.device == bank.dev


def test_time_phases_counted_once_per_response(network, clean, monkeypatch):
    """One rays.device_time_phases count a response: L x 14 x N*J for a
    bank's h and for an engine's DL and UL responses, U x 14 x N*J for a
    bank's row, none for a kept response; none inside network.bank_h, and
    an engine's response opens no network span."""
    bank, engine = network.banks[2], network.sims[0]
    bank.release()
    L, N, J, _ = bank.links.coeff.shape
    dl, ul = (engine._channel[d].links.coeff.shape for d in ("DL", "UL"))
    calls = []
    count = tracing.count

    def spy(name, n=1):
        if name == "rays.device_time_phases":
            calls.append(n)
        count(name, n)

    monkeypatch.setattr(tracing, "count", spy)
    tracing.enable()
    with tracing.span("probe.h"):
        bank.h(3)
        bank.h(3)
    with tracing.span("probe.row"):
        bank.h_row(3, 0)
    with tracing.span("probe.engine"):
        for d in ("DL", "UL", "DL", "UL"):
            engine._h_slot(7, d)
    tracing.disable()
    bank.release()
    assert calls == [L * 14 * N * J, bank.n_ues * 14 * N * J,
                     dl[0] * 14 * dl[1] * dl[2], ul[0] * 14 * ul[1] * ul[2]]
    recs = tracing.records()
    counted = {r.name: r.counts.get("rays.device_time_phases") for r in recs if "probe" in r.name}
    assert counted == {"probe.h": calls[0], "probe.row": calls[1],
                       "probe.engine": calls[2] + calls[3]}
    bank_h = [r for r in recs if r.name == "network.bank_h"]
    assert len(bank_h) == 2 and not any(r.counts for r in bank_h)
    assert {r.name for r in recs if r.name.startswith("network.")} == {"network.bank_h"}


@pytest.mark.parametrize("case", ["engine-DL", "engine-UL", "one-link"])
def test_responses_match_float64_ray_form(network, case):
    """An engine's _h_slot at a DL slot and at the U slot 9, and the one-link
    cdl_frequency_response, against the float64 ray form (BANK_TOL of each
    link's largest |H|); the one-link response is row 0 of the batched one."""
    engine = network.sims[1]
    direction = case.removeprefix("engine-")
    slot = 9 if direction == "UL" else 2
    links = engine.links_ul if direction == "UL" else engine.links_dl
    t = slot * engine.carrier.slot_duration_s + engine._sym_t
    want = channel.slot_response(links, t, engine.freqs, "cpu")
    if case == "one-link":
        got = cdl_frequency_response(links[0], t, engine.freqs, device="cpu")[None]
        batched = batched_frequency_response(stack_links(links, device="cpu"), t, engine.freqs)
        assert torch.equal(got[0], batched[0])
        want = want[:1]
    else:
        got = engine._h_slot(slot, direction)
    assert got.shape == want.shape and got.shape[1:3] == (14, engine.n_sc)
    dims = tuple(range(1, want.dim()))
    err = (got.to(torch.complex128) - want).abs().amax(dims) / want.abs().amax(dims)
    assert float(err.max()) <= BANK_TOL, err


@pytest.mark.card
def test_card_full_width_and_memory():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    tau = _delays(["CDL-A", "CDL-D", "CDL-A", "CDL-A", "CDL-D"], 460)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = freq_phases_on(tau, FULL_FREQS, dev)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base - got.numel() * got.element_size()
    print(f"[5, 3276, 460]: transient beyond the output {extra / 2**20:.3f} MiB")
    assert got.shape == (5, 3276, 460) and got.device.type == "cuda"
    assert extra <= 16 * 2**20
    _assert_close_to_host(got, freq_phases(tau, FULL_FREQS))
