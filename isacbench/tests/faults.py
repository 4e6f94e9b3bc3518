"""Faults planted beneath the harness's taps, for the tests that show a
broken timed path reads as not correct. Each takes a pytest monkeypatch."""

import torch


def frozen_fading(mp):
    """A step that returns its state unchanged: every slot sees slot 0's
    fading, in the engines and in the cross-cell banks."""
    import isac_tpu_torch.sim.cell as cell_mod
    import isac_tpu_torch.sim.network as net_mod

    h_slot, bank_h = cell_mod.CellSimulator._h_slot, net_mod._RayBank.h
    mp.setattr(cell_mod.CellSimulator, "_h_slot", lambda self, slot, d: h_slot(self, 0, d))
    mp.setattr(net_mod._RayBank, "h", lambda self, slot: bank_h(self, 0))


def decoder_unchanged(mp):
    """The decoder returns its input LLRs, as if no iteration ran."""
    import isac_tpu_torch.ops.ldpc_layered as L

    def post(llr, bg, z, n_iter=6, norm=0.75, impl=None):
        return llr.reshape(*llr.shape[:-1], -1, z).to(torch.float32).clone()

    mp.setattr(L, "layered_posterior", post)


def half_batch(mp):
    """Half of each decoder batch left out: the second half of the codewords
    comes back undecoded."""
    import isac_tpu_torch.ops.ldpc_layered as L

    orig = L.layered_posterior

    def post(llr, bg, z, n_iter=6, norm=0.75, impl=None):
        out = orig(llr, bg, z, n_iter, norm, impl)
        flat = out.reshape(-1, *out.shape[-2:]).clone()
        n = flat.shape[0]
        flat[n // 2:] = llr.reshape(-1, *out.shape[-2:])[n // 2:].to(flat.dtype)
        return flat.reshape(out.shape)

    mp.setattr(L, "layered_posterior", post)


def exchange_left_out(mp):
    """The co-channel cells' signals never reach a receiver."""
    import isac_tpu_torch.sim.network as net_mod

    mp.setattr(net_mod.SyncNetworkRunner, "_dl_ext", lambda self, d, slot, states: None)
    mp.setattr(net_mod.SyncNetworkRunner, "_ul_ext", lambda self, d, slot, ul_states: None)


def block_altered(mp):
    """An answer altered where it is produced: the first bit of every decoded
    transport block flipped, its CRC flag kept."""
    import isac_tpu_torch.sim.cell as cell_mod

    orig = cell_mod.sch_receive_batch

    def receive(*args, **kwargs):
        out = orig(*args, **kwargs)
        tb = out["tb"].clone()
        tb[..., 0] ^= 1
        out["tb"] = tb
        return out

    mp.setattr(cell_mod, "sch_receive_batch", receive)


def map_altered(mp):
    """The range-Doppler map altered where it is produced: one bin of every
    antenna raised by a tenth of the map's peak."""
    import isac_tpu_torch.ops.sensing as sensing

    orig = sensing.range_doppler_map

    def rdm(*args, **kwargs):
        out = orig(*args, **kwargs).clone()
        out[..., 0, 0] += 0.1 * torch.max(torch.abs(out))
        return out

    mp.setattr(sensing, "range_doppler_map", rdm)


def llrs_scaled(mp):
    """The demapper's LLRs one percent too large where they are produced."""
    import isac_tpu_torch.phy.chains as chains

    orig = chains.demodulate_llr
    mp.setattr(chains, "demodulate_llr", lambda *a, **k: orig(*a, **k) * 1.01)


def half_recovered(mp):
    """Rate recovery leaves out the second half of each code block's LLRs."""
    import isac_tpu_torch.ops.ldpc as ldpc

    orig = ldpc.rate_recover

    def recover(llr_e, *args, **kwargs):
        llr_e = llr_e.clone()
        llr_e[..., llr_e.shape[-1] // 2:] = 0.0
        return orig(llr_e, *args, **kwargs)

    mp.setattr(ldpc, "rate_recover", recover)


def crc_flag_flipped(mp):
    """Every transport block's CRC flag inverted where it is produced."""
    import isac_tpu_torch.ops.transport as transport

    orig = transport.sch_decode

    def decode(*args, **kwargs):
        tb, ok, bufs = orig(*args, **kwargs)
        return tb, ~ok, bufs

    mp.setattr(transport, "sch_decode", decode)


def noise_off(mp):
    """The receivers' noise left out: every grid arrives noise-free."""
    import isac_tpu_torch.sim.cell as cell_mod

    mp.setattr(cell_mod.CellSimulator, "_noise",
               lambda self, shape, key: torch.zeros(tuple(shape), dtype=torch.complex64,
                                                    device=self.dev))


def modulation_wrong(mp):
    """The transmitter's constellation mirrored (I and Q swapped) where the
    symbols are made."""
    import isac_tpu_torch.phy.chains as chains

    orig = chains.modulate

    def modulate(*args, **kwargs):
        d = orig(*args, **kwargs)
        return torch.complex(d.imag, d.real)

    mp.setattr(chains, "modulate", modulate)


def estimate_biased(mp):
    """The channel estimate one percent too large where it is made."""
    import isac_tpu_torch.phy.chains as chains

    orig = chains.estimate_channel_canonical

    def estimate(*args, **kwargs):
        h, nvar = orig(*args, **kwargs)
        return h * 1.01, nvar

    mp.setattr(chains, "estimate_channel_canonical", estimate)


def echo_late(mp):
    """The radar echo one sample later than its targets' range."""
    import isac_tpu_torch.sim.sensing as sen

    orig = sen.apply_radar_channel

    def echo(tx_wave, params, generator=None, target_los=None, noise=None):
        clean = orig(tx_wave, params, None, target_los, None)
        late = torch.cat([torch.zeros_like(clean[:1]), clean[:-1]])
        return late if noise is None else late + noise.to(late.dtype)

    mp.setattr(sen, "apply_radar_channel", echo)


def echo_noise_off(mp):
    """The radar's receiver noise left out."""
    import isac_tpu_torch.sim.sensing as sen

    orig = sen.apply_radar_channel
    mp.setattr(sen, "apply_radar_channel",
               lambda tx_wave, params, generator=None, target_los=None, noise=None:
               orig(tx_wave, params, None, target_los, None))


def detection_dropped(mp):
    """CA-CFAR's strongest detection left out of its list."""
    import isac_tpu_torch.ops.sensing as sensing

    orig = sensing.cfar_extract_detections

    def extract(*args, **kwargs):
        out = dict(orig(*args, **kwargs))
        valid = out["valid"].clone()
        valid[0] = False
        out["valid"] = valid
        return out

    mp.setattr(sensing, "cfar_extract_detections", extract)


def azimuth_turned(mp):
    """MUSIC's azimuths ten degrees off where they are picked."""
    import isac_tpu_torch.ops.sensing as sensing

    orig = sensing.music_doa

    def doa(*args, **kwargs):
        out = dict(orig(*args, **kwargs))
        out["azEst"] = out["azEst"] + 10.0
        return out

    mp.setattr(sensing, "music_doa", doa)
