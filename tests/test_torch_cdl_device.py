"""The CDL ray frequency phases built on the device (ops/cdl.py
`freq_phases_on`) against the host's float64 `freq_phases`.

On the CPU: CDL-A and CDL-D delays at 300 ns with padded zero-delay rays over
a slice of the full carrier's subcarriers; block sizes that do not divide
the tensor; and, at 12 PRB, every engine's and every bank's phases of an
engine and a 3-cell network, with the ``rays.device_phases`` count.

On the card (marker ``card``; this file imports no JAX, so run it there with
``python -m pytest --noconftest tests/test_torch_cdl_device.py -m card -s``):
the full width [5, 3276, 460] and the memory it takes beyond its output.
"""

import numpy as np
import pytest
import torch

from isac_tpu_torch.ops import cdl
from isac_tpu_torch.ops.cdl import build_cdl_link, freq_phases, freq_phases_on, subcarrier_freqs
from isac_tpu_torch.utils import tracing

CPU = dict(n_rb_override=12, nfft_override=256, device="cpu")
FULL_FREQS = subcarrier_freqs(3276, 30e3)
F32_EPS = 2.0 ** -23


@pytest.fixture
def clean():
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _delays(profiles, n_rays: int) -> np.ndarray:
    """[L, n_rays] float64: each profile's ray delays at 300 ns, zero-padded
    to n_rays as stack_links pads them."""
    gnb = np.zeros((16, 3))
    gnb[:, 2] = np.arange(16) * 0.05
    ue = np.zeros((2, 3))
    rows = []
    for i, p in enumerate(profiles):
        tau = build_cdl_link(p, 300.0, 3.5e9, gnb, ue, ue_velocity=3.0, seed=11 + i).tau
        rows.append(np.pad(tau, (0, n_rays - tau.size)))
    return np.stack(rows)


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
    """Every ff of an engine and of a 3-cell network's banks is built by
    freq_phases_on, lies within one float32 ulp of the host's phases of the
    same links, and is counted as rays.device_phases."""
    from isac_tpu_torch.config import params, scenarios
    from isac_tpu_torch.sim import cell as cell_mod
    from isac_tpu_torch.sim import network as net_mod

    torch.set_num_threads(2)
    built = []

    def spy(tau, freqs, device):
        out = freq_phases_on(tau, freqs, device)
        built.append((np.array(tau), np.array(freqs), out))
        return out

    monkeypatch.setattr(cell_mod, "freq_phases_on", spy)
    monkeypatch.setattr(net_mod, "freq_phases_on", spy)

    sim = scenarios.multi_cell(params.SimulationParameters(), num_cells=3)
    sim.validate()
    cells = params.assign_cell_parameters(sim)
    tracing.enable()
    engine = cell_mod.CellSimulator(cells[0], seed=2, enable_sensing=False, **CPU)
    runner = net_mod.SyncNetworkRunner(cells, seed=4, enable_sensing=False, **CPU)
    runner._build_banks()
    tracing.disable()

    ffs = [s._bl[d]["ff"] for s in [engine, *runner.sims] for d in ("DL", "UL")]
    ffs += [b._ffc for b in runner.banks]
    assert len(ffs) == len(built) == 2 * 4 + 3
    assert [id(ff) for ff in ffs] == [id(out) for _, _, out in built]
    for tau, freqs, out in built:
        assert out.device == engine.dev and out.shape == (tau.shape[0], freqs.size, tau.shape[1])
        _assert_close_to_host(out, freq_phases(tau, freqs))
    counted = sum(r.counts.get("rays.device_phases", 0) for r in tracing.records())
    assert counted == sum(ff.numel() for ff in ffs)
    rays = {r.name for r in tracing.records() if "rays.device_phases" in r.counts}
    assert rays == {"build.engine.rays", "network.banks"}


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
