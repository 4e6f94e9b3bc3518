"""The numbers that decide ``correct``, each against its limit.

- ``tx``: the transmitted port grid(s) of a sampled slot against the
  reference transmitter (reference/txchain.py) of every grant sent in it,
  from its transport block: CRC, segmentation, LDPC encoding, rate matching,
  scrambling, modulation, layer mapping, DM-RS, precoding and placement; max
  |dx| / rms x, the CSI-RS's resource elements left out;
- ``chan``: the slot channel response the program used (each serving link,
  and each link of a network destination's cross-cell bank) against the sum
  over rays, worst over links of max |dH| / rms H of the link;
- ``rx``: the received grid the receiver was given, less the noise the
  program drew, against the reference's serving signal plus every co-channel
  cell's signal, worst over receivers of max |dy| / rms y of the receiver;
- ``noise``: that drawn noise's mean power against the unit power of the
  noise-normalised grid, as |z| (sqrt(n) times the gap; a sound draw reads
  like the modulus of a standard normal);
- ``ldpc``: the decoder's posterior against the reference decode of the same
  input LLRs, max |dL| / max |L|;
- ``tb``: bits that differ between a transport block the receiver delivered
  with a passing CRC and the block that was sent (exact: limit 0);

over every stage of a sampled receive call (reference/estimator.py,
reference/rxchain.py):

- ``dmrs``: the DM-RS references the estimator used against the sequence of
  TS 38.211, max |d| (exact: limit 0);
- ``est``: the channel estimate and noise variance against the reference
  estimator of the same received allocation, worst over grants of max |dH|
  / rms H and the noise variance's relative gap;
- ``mmse``: the LLRs against the reference's own MMSE of the same received
  grid, channel estimate and noise, its data resource elements and its
  demapping, relative RMS gap per grant (compared as LLRs: a symbol on a
  resource element with an SINR near 0 carries float32 rounding magnified by
  1 / SINR, which its LLR scales away again);
- ``demod``: the LLRs against max-log demapping of the same symbols and
  noise, relative RMS gap per grant;
- ``scramble``: values that differ between the reference's layer demapping,
  Gold sequence, descrambling and clipping and the program's (exact);
- ``rm``: the decoder's input and the HARQ soft buffers against rate
  recovery of the same LLRs and buffers, max |d| (exact);
- ``crc``: CRC flags and the bits of every transport block of the call,
  delivered or not, that differ from the parity and CRC checks of the
  reference's decode of the decoder's input (exact);

and over a sampled sensing post-pass (reference/rdm.py, reference/sensing.py):

- ``rdm``: one antenna's range-Doppler map against the reference map of the
  same echo and transmit grids, max |d| / max |map|;
- ``echo``: the amplitude of the reference's echo of the transmit grid
  fitted to the echo grid, |a - 1| over its standard deviation (only where a
  target is in line of sight); ``echo_noise``: the power of the echo grid
  less the reference's echo against the radar's noise power, as |z|;
- ``cfar``: detections that differ from CA-CFAR of the program's map
  (missing, extra, or at another range, velocity or power; exact, a cell
  within 1e-5 of its threshold counting either way);
- ``doa``: MUSIC azimuths, as many as the eigenvalues split cleanly from the
  rest, that are not within one scan step of a peak of the reference's
  spectrum as high as the reference's pick of that rank, less 5%, plus a
  wrong count of valid azimuths (exact).

Each kind that a cell's traffic plans to sample has to be found at least
once in the window: a number with nothing to compare reads infinite.

``evaluate(..., control=True)`` puts the reference computed one precision
below float32 in the program's place (TF32 operands for the channel
contractions, bfloat16 for the decoder, the transmitter's symbols and
precoders, the estimator's and the map's inputs): the control that the
limits have to reject. It leaves out the exact numbers and the noise
statistics (``STATISTICAL``), which no precision of the arithmetic moves.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from isacbench.reference import channel, estimator, ldpc, rdm, rxchain, sensing, txchain

LIMITS = json.loads((Path(__file__).parent / "limits.json").read_text())["limits"]

NUMBERS_OF_KIND = {"dl_rx": ("chan", "rx", "noise", "tx"), "ul_rx": ("chan", "rx", "noise", "tx"),
                   "ldpc": ("ldpc",), "tb": ("tb",), "rdm": ("rdm", "echo_noise", "cfar", "doa"),
                   "rxc": ("dmrs", "est", "mmse", "demod", "scramble", "rm", "crc")}
EXACT = ("ldpc", "tb", "dmrs", "scramble", "rm", "crc", "cfar", "doa")
DOA_TIE = 0.05  # MUSIC peaks within this share of each other may come in either order
# statistics of the drawn noise, which no precision of the arithmetic moves
STATISTICAL = ("noise", "echo", "echo_noise")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 (or complex64) values to TF32's 10 mantissa bits,
    to nearest with ties away from zero, as the card converts them."""
    if x.is_complex():
        return torch.complex(round_tf32(x.real.contiguous()), round_tf32(x.imag.contiguous()))
    b = x.to(torch.float32).contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    if x.is_complex():
        return torch.complex(round_bf16(x.real), round_bf16(x.imag))
    return x.to(torch.bfloat16).to(torch.float32)


def _rel(a: torch.Tensor, b: torch.Tensor, lead: int) -> float:
    """Worst over the `lead` leading axes (links, receivers) of max |a - b|
    / rms b over the rest."""
    rows = int(np.prod(b.shape[:lead]))
    b = b.to(torch.complex128).reshape(rows, -1)
    d = torch.abs(a.to(torch.complex128).reshape(rows, -1) - b)
    rms = torch.sqrt(torch.mean(torch.abs(b) ** 2, dim=-1))
    return float(torch.max(torch.amax(d, dim=-1) / rms.clamp_min(1e-300)))


def _control_response(links, t, f, device):
    """The program's contraction form with TF32 operands: complex64 phases
    made in float64, then (time x frequency phases) @ coefficients."""
    out = []
    for link in links:
        pt = np.exp(2j * np.pi * t[:, None] * np.asarray(link.nu)[None, :]).astype(np.complex64)
        pf = np.exp(-2j * np.pi * f[:, None] * np.asarray(link.tau)[None, :]).astype(np.complex64)
        ph = torch.as_tensor(pt[:, None, :] * pf[None, :, :], device=device)  # [S, K, R]
        c = torch.as_tensor(np.asarray(link.coeff, np.complex64), device=device)
        out.append(torch.einsum("skr,abr->skab", round_tf32(ph).to(torch.complex128),
                                round_tf32(c).to(torch.complex128)).to(torch.complex64))
    return torch.stack(out)


def _dl(rec, device, control):
    h, hb, y = channel.dl_received(rec, device)
    if not control:
        pairs = [(rec["h"], h)] + ([(rec["net"]["h_bank"], hb)] if hb is not None else [])
        return pairs, (rec["y"] - rec["n"], y)
    cell = rec["cell"]
    t = channel.symbol_start_times(rec["slot"], rec["nfft"], cell.gnb.scs_khz)
    f = channel.subcarrier_freqs(rec["ks"], rec["n_sc"], cell.gnb.scs_khz)
    hc = _control_response(rec["links"], t, f, device)
    amp = torch.as_tensor(channel.dl_amplitude(cell, cell, rec["n_sc"], cell.ue_los), device=device)
    x = round_tf32(rec["x"].to(device)).to(torch.complex128)
    yc = torch.einsum("tsk,uskat->uask", x, round_tf32(hc).to(torch.complex128))
    yc = yc * amp[:, None, None, None]
    pairs = [(hc, h)]
    if hb is not None:
        net = rec["net"]
        hbc = _control_response(net["links"], t, f, device).reshape(hb.shape)
        pairs.append((hbc, hb))
        for s, src in enumerate(net["cells"]):
            xs = net["xs"][s]
            if s == net["d"] or xs is None:
                continue
            los = net["cross_los"].get((net["d"], s), np.zeros(hb.shape[1], bool))
            a = torch.as_tensor(channel.dl_amplitude(src, cell, rec["n_sc"], los), device=device)
            yc = yc + torch.einsum("tsk,uskat->uask", round_tf32(xs.to(device)).to(torch.complex128),
                                   round_tf32(hbc[s]).to(torch.complex128)) * a[:, None, None, None]
    return pairs, (yc, y)


def _ul(rec, device, control):
    h, y = channel.ul_received(rec, device)
    if not control:
        return [(rec["h"], h)], (rec["y"] - rec["n"], y)
    # the control: the serving uplink through the TF32 contraction; the
    # co-channel part is the reference's own
    cell = rec["cell"]
    t = channel.symbol_start_times(rec["slot"], rec["nfft"], cell.gnb.scs_khz)
    f = channel.subcarrier_freqs(rec["ks"], rec["n_sc"], cell.gnb.scs_khz)
    hc = _control_response(rec["links"], t, f, device)
    ues = [u for u, _ in rec["grants"]]
    amp = torch.as_tensor(channel.ul_amplitude(cell, cell, ues, [n for _, n in rec["grants"]],
                                               cell.ue_los), device=device)
    idx = torch.as_tensor(np.asarray(ues, np.int64), device=device)
    x = round_tf32(rec["x"].to(device)).to(torch.complex128)
    serve = torch.einsum("gtsk,gskat->gask", x, round_tf32(hc).to(torch.complex128)[idx])
    serve_ref = torch.einsum("gtsk,gskat->gask", rec["x"].to(device).to(torch.complex128), h[idx])
    amp4 = amp[:, None, None, None]
    return [(hc, h)], (y - serve_ref * amp4 + serve * amp4, y)


def _noise_z(n: torch.Tensor) -> float:
    """|z| of the mean power of unit-variance complex noise against 1: each
    |n|^2 is exponential, of mean 1 and standard deviation 1."""
    p = torch.abs(n.to(torch.complex128)) ** 2
    return float(torch.abs(p.mean() - 1.0)) * float(np.sqrt(p.numel()))


def _tx(rec: dict, control: bool) -> float:
    """The transmitted grid(s) against the reference transmitter of the
    slot's grants, max |dx| / rms x over the resource elements the grants
    fill, the CSI-RS's resource elements left out."""
    prog = rec["x_full"].numpy()

    def assemble(lower: bool):
        grids = []
        for g, tb, w in rec["tx"]:
            if lower:
                w = round_bf16(torch.as_tensor(w)).numpy()
            x = txchain.port_grid(tb, g, w, g["n_sc_grid"])
            grids.append(round_bf16(torch.as_tensor(x.astype(np.complex64))).numpy()
                         if lower else x)
        if prog.ndim == 4:
            return np.stack(grids)
        return sum(grids) if grids else np.zeros(prog.shape, np.complex128)

    ref = assemble(False)
    if control:
        prog = assemble(True)
    keep = np.ones(prog.shape[-2:], bool)
    for sym, off in rec.get("csi_res", ()):
        keep[sym, off::12] = False
    d = np.abs(prog - ref)[..., keep]
    filled = np.abs(ref[..., keep])
    rms = np.sqrt(np.mean(filled[filled > 0] ** 2)) if (filled > 0).any() else 1.0
    return float(np.max(d) / rms)


def _rms_rel(a: torch.Tensor, b: torch.Tensor, lead: int) -> float:
    """Worst over the `lead` leading axes of ||a - b|| / ||b|| over the rest."""
    rows = int(np.prod(b.shape[:lead]))
    a = a.to(torch.complex128).reshape(rows, -1)
    b = b.to(torch.complex128).reshape(rows, -1)
    return float(torch.max(torch.linalg.vector_norm(a - b, dim=-1)
                           / torch.linalg.vector_norm(b, dim=-1).clamp_min(1e-300)))


def _rxchain(rec: dict, device, control: bool) -> dict:
    """The numbers of one sampled receive call, stage by stage from the
    program's own input to each stage."""
    grants, out = rec["grants"], {}
    est = rec["estimate_channel_canonical"]
    refs = est["refs"].numpy()
    exact = 0.0
    for i, g in enumerate(grants):
        for j, sym in enumerate(est["dsyms"]):
            r = rxchain.dmrs_base(g["slot"], sym, g["n_id"], g["prbs"]).astype(np.complex64)
            exact = max(exact, float(np.max(np.abs(refs[i, j] - r))))
    out["dmrs"] = exact

    rx_c = est["rx_c"].numpy()
    if control:
        rx_c = round_bf16(est["rx_c"]).numpy()
    h_ref, nv_ref = estimator.estimate(rx_c, {**grants[0], "prbs_each": [g["prbs"] for g in grants]})
    h_p, nv_p = est["out"][0].numpy(), est["out"][1].numpy()
    if control:
        h_p, nv_p = h_ref, nv_ref
        h_ref, nv_ref = estimator.estimate(est["rx_c"].numpy(),
                                           {**grants[0], "prbs_each": [g["prbs"] for g in grants]})
    gap = 0.0
    for i in range(len(grants)):
        rms = np.sqrt(np.mean(np.abs(h_ref[i]) ** 2))
        gap = max(gap, float(np.max(np.abs(h_p[i] - h_ref[i])) / max(rms, 1e-300)),
                  float(abs(nv_p[i] - nv_ref[i]) / nv_ref[i]))
    out["est"] = gap

    m, d = rec["mmse_equalize"], rec["demodulate_llr"]
    g0, qm = grants[0], grants[0]["qm"]
    y, h = m["y"].to(device), m["h"].to(device)
    if control:
        y, h = round_bf16(y), round_bf16(h)
    sym_ref, sinr_ref = rxchain.mmse(y, h, m["nvar"].to(device))
    si, ki = (torch.as_tensor(a, device=device) for a in rxchain.data_res(
        len(g0["prbs"]), g0["sym_start"], g0["n_sym"], est["dsyms"], g0["reserved"]))
    llr_ref = rxchain.demap(sym_ref[:, :, si, ki], 1.0 / torch.clamp(sinr_ref[:, :, si, ki], 1e-9),
                            qm)
    out["mmse"] = _rms_rel(d["out"][0].to(device), llr_ref.reshape(d["out"][0].shape), 1)

    sym, nv = d["sym"].to(device), d["nvar"].to(device)
    if control:
        sym, nv = round_bf16(sym), round_bf16(nv)
    llr_ref = rxchain.demap(sym, torch.clamp_min(nv, 1e-10), qm)
    out["demod"] = _rms_rel(d["out"][0].to(device), llr_ref, 1)

    s = rec["descramble_llr"]
    n_layers = grants[0]["n_layers"]
    demapped = rxchain.layer_demap(d["out"][0].reshape(len(grants), -1), n_layers, qm)
    wrong = int(torch.count_nonzero(demapped != s["llr"]))
    seq = s["seq"].numpy()
    for i, g in enumerate(grants):
        ref = rxchain.scrambling(g["rnti"], g["n_id"], seq.shape[-1])
        wrong += int(np.count_nonzero(np.broadcast_to(seq, (len(grants), seq.shape[-1]))[i] != ref))
    desc = s["llr"] * (1.0 - 2.0 * s["seq"].to(s["llr"].dtype))
    wrong += int(torch.count_nonzero(desc != s["out"][0]))
    dec = rec["sch_decode"]
    wrong += int(torch.count_nonzero(torch.clamp(desc, -60.0, 60.0) != dec["llr"]))
    out["scramble"] = float(wrong)

    cfg, llr = dec["cfg"], dec["llr"].numpy()
    soft = dec["soft"].numpy() if torch.is_tensor(dec.get("soft")) else None
    dec_in = rec["decode"]["llr"].numpy()
    bufs = dec["out"][2].numpy()
    es = rxchain.e_per_cb(cfg.g, cfg.c, cfg.qm, cfg.n_layers)
    gap = 0.0
    for i, g in enumerate(grants):
        off = 0
        for r, e in enumerate(es):
            full, buf = rxchain.rate_recover(llr[i, off:off + e], cfg.bg, cfg.z, cfg.k, cfg.n_filler,
                                             cfg.qm, g["rv"], None if soft is None else soft[i, r])
            off += e
            gap = max(gap, float(np.max(np.abs(full - dec_in[i, r]))),
                      float(np.max(np.abs(buf - bufs[i, r]))))
    out["rm"] = gap

    post_ref = ldpc.posterior(torch.as_tensor(dec_in), cfg.bg, cfg.z, rec["decode"]["n_iter"],
                              rec["decode"]["norm"]).numpy()
    tb_ref, ok_ref = rxchain.transport_block(post_ref.reshape(len(grants), cfg.c, -1), cfg)
    tb_p = rec["out"]["tb"].numpy()
    ok_p = rec["out"]["crc_ok"].numpy()
    out["crc"] = float(np.count_nonzero(ok_p != ok_ref) + np.count_nonzero(tb_p != tb_ref))
    return out


def _sensing(rec: dict) -> dict:
    """The echo, CA-CFAR's detections and MUSIC's azimuths of one post-pass."""
    rx, tx = rec["rx"].numpy(), rec["tx"].numpy()
    out = sensing.echo_numbers(rx, tx, rec)
    grid = sensing.radar_grid(rec, rx.shape[-1])
    rdm_rows = rec["rdm_rows"].numpy()
    est = {k: v.numpy() for k, v in rec["est"].items()}
    r1 = grid["zone"][1]
    wrong = 0
    if (rec["rdm_a"].shape != (grid["n_ifft"], grid["n_fft"])
            or rdm_rows.shape[-2] < min(r1 + 4, grid["n_ifft"])):
        wrong += 1000  # the map lacks the configuration's bins
    det = sensing.cfar(rdm_rows, (0, 0), grid["zone"], grid["pfa"])
    valid = est["valid"].astype(bool)
    got = set()
    for rng_m, vel, pk in zip(est["rngEst"][valid], est["velEst"][valid], est["peak"][valid]):
        r = int(np.rint(rng_m / grid["r_res"]))
        c = int(np.rint(vel / grid["v_res"] + grid["n_fft"] / 2))
        if (abs(rng_m - r * grid["r_res"]) > 1e-4 * grid["r_res"]
                or abs(vel - (c - grid["n_fft"] / 2) * grid["v_res"]) > 1e-4 * grid["v_res"]
                or not 0 <= r < rdm_rows.shape[-2] or not 0 <= c < rdm_rows.shape[-1]):
            wrong += 1
            continue
        if abs(pk - det["pmax"][r, c]) > 1e-5 * det["pmax"][r, c]:
            wrong += 1
        got.add((r, c))
    out["cfar"] = float(wrong + len(det["sure"] - got) + len(got - det["maybe"]))

    n_sig = int(np.clip(valid.sum(), 1, 4))
    mu = sensing.music(rx, rec["gnb"].antenna, grid["lam"], grid["az_scan"], n_sig)
    spec, az, peaks = mu["spectrum"], mu["az"], mu["peaks"]
    step = az[1] - az[0]
    azi, dv = est["aziEst"], est["doa_valid"].astype(bool)
    wrong = int(dv.sum() != min(n_sig, peaks.size))
    for j in range(min(mu["clean"], mu["picks"].size)):
        if not np.isfinite(azi[j]):
            wrong += 1
            continue
        i = int(np.rint((azi[j] - az[0]) / step))
        near = peaks[spec[peaks] >= (1 - DOA_TIE) * spec[mu["picks"][j]]]
        wrong += int(not np.any(np.abs(near - i) <= 1))
    out["doa"] = float(wrong)
    return out


def evaluate(cap, plan: dict, device, control: bool = False) -> dict:
    """name -> (value, items compared) over what `cap` kept."""
    out: dict = {}

    def worst(name, value, n=1):
        v, k = out.get(name, (0.0, 0))
        out[name] = (max(v, value), k + n)

    for kind, fn in (("dl", _dl), ("ul", _ul)):
        for rec in cap.recs[kind]:
            pairs, (y_prog, y_ref) = fn(rec, device, control)
            for hp, hr in pairs:
                lead = hr.dim() - 4
                worst("chan", _rel(hp.to(device), hr, lead), int(np.prod(hr.shape[:lead])))
            worst("rx", _rel(y_prog.to(device), y_ref, 1), y_ref.shape[0])
            worst("tx", _tx(rec, control), len(rec["tx"]))
            if not control:
                worst("noise", _noise_z(rec["n"]), 1)
    for rec in cap.recs["ldpc"]:
        llr = rec["llr"].to(device)
        ref = ldpc.posterior(llr, rec["bg"], rec["z"], rec["n_iter"], rec["norm"])
        prog = rec["post"].to(device).reshape(ref.shape)
        if control:
            prog = ldpc.posterior(llr, rec["bg"], rec["z"], rec["n_iter"], rec["norm"],
                                  dtype=torch.bfloat16).float()
        scale = float(torch.max(torch.abs(ref)).clamp_min(1e-30))
        worst("ldpc", float(torch.max(torch.abs(prog - ref))) / scale, ref.shape[0])
    if not control:
        for rec in cap.recs["tb"]:
            if rec["ok"]:
                worst("tb", float(np.count_nonzero(rec["tx"] != rec["rx"])
                                  + abs(rec["tx"].size - rec["rx"].size)))
    for rec in cap.recs["rdm"]:
        rx, tx = rec["rx"][rec["a"]], rec["tx"][rec["a"]]
        prog = rec["rdm_a"].numpy()
        ref = rdm.range_doppler_map(rx.numpy(), tx.numpy(), *prog.shape)
        if control:
            prog = rdm.range_doppler_map(round_bf16(rx).numpy().astype(np.complex64),
                                         round_bf16(tx).numpy().astype(np.complex64),
                                         *prog.shape)
        worst("rdm", float(np.max(np.abs(prog - ref)) / np.max(np.abs(ref))))
        if not control:
            for name, value in _sensing(rec).items():
                worst(name, value)
    for rec in cap.recs["rxc"]:
        for name, value in _rxchain(rec, device, control).items():
            if not (control and name in EXACT):
                worst(name, value, len(rec["grants"]))
    for kind in plan:
        for name in NUMBERS_OF_KIND.get(kind, ()):
            skipped = control and (name in STATISTICAL or (name in EXACT and name != "ldpc"))
            if name not in out and not skipped:
                out[name] = (float("inf"), 0)
    return out


def judge(numbers: dict) -> dict:
    return {name: {"value": v, "limit": LIMITS[name], "n": n}
            for name, (v, n) in sorted(numbers.items())}
