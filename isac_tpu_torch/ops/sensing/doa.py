"""Direction-of-arrival estimation: MUSIC, beamscan, MVDR; 2D range-velocity MUSIC.

Counterparts of:
- +sensing/+estimation/+doaEstimation/music.m:1-165 (incl. the eigenvalue-gap
  target-count heuristic, determineNumTargets:109-125)
- digitalBF.m (beamscan a^H Ra a) and mvdrBF.m (1/(a^H Ra^-1 a))
- +sensing/+estimation/music2D.m:1-157 (range/velocity MUSIC)

All spectra are computed as matrix products over a precomputed steering-matrix
scan grid — no per-angle loops. The scan grids are built on the host in float64
and cached on the device per (array, wavelength, sector, device). Peak picking
uses fixed-capacity top-K with local-max suppression; the signal count stays a
device scalar, so nothing here waits for the host. (`torch.linalg.eigh` itself
synchronises on the card; that is the library's.)

Eigenvectors are defined up to a phase, and inside the noise subspace up to a
rotation, so two eigensolvers agree on the MUSIC spectrum (it depends only on
the noise-subspace projector), never on the vectors.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from isac_tpu_torch.config.params import UPA
from isac_tpu_torch.ops.sensing.cfar import top_k_lowest_index_first
from isac_tpu_torch.ops.sensing.radar_params import RadarDerived, steering_vector
from isac_tpu_torch.utils.geometry import SPEED_OF_LIGHT


def spatial_covariance(rx_grid: torch.Tensor) -> torch.Tensor:
    """Ra = X X^H / (nSc*nSym) from echo grid [n_ants, n_sym, n_sc] (fft2D.m:104-106)."""
    n_ants = rx_grid.shape[0]
    x = rx_grid.reshape(n_ants, -1)
    return torch.matmul(x, x.conj().T) / x.shape[1]


@lru_cache(maxsize=16)
def _scan_grid(antenna, wavelength: float, az_scan: tuple, el_scan: tuple, is_upa: bool):
    """Steering matrix over the angle scan grid. Returns (A [n_ants, G], az[G], el[G])."""
    az_scale, az_step = az_scan
    azs = np.arange(-az_scale / 2, az_scale / 2 + az_step / 2, az_step)
    if is_upa:
        el_scale, el_step = el_scan
        els = np.arange(-el_scale / 2, el_scale / 2 + el_step / 2, el_step)
        az_g, el_g = np.meshgrid(azs, els, indexing="ij")
        a = steering_vector(antenna, wavelength, az_g.ravel(), el_g.ravel())
        return a, az_g.ravel(), el_g.ravel()
    a = steering_vector(antenna, wavelength, azs, np.zeros_like(azs))
    # A 1D ULA has no elevation aperture: report NaN, never a fake 0 deg
    return a, azs, np.full_like(azs, np.nan)


@lru_cache(maxsize=16)
def _scan_grid_dev(antenna, wavelength: float, az_scan: tuple, el_scan: tuple,
                   device: torch.device):
    """`_scan_grid` on `device`: (A complex64, az float32, el float32)."""
    a, az, el = _scan_grid(antenna, wavelength, az_scan, el_scan, isinstance(antenna, UPA))
    return (
        torch.as_tensor(a.astype(np.complex64), device=device),
        torch.as_tensor(az.astype(np.float32), device=device),
        torch.as_tensor(el.astype(np.float32), device=device),
    )


def _params_scan(params: RadarDerived, device: torch.device):
    return _scan_grid_dev(params.antenna, SPEED_OF_LIGHT / params.fc,
                          tuple(params.azimuth_scan), tuple(params.elevation_scan), device)


def estimate_num_targets(eigvals: torch.Tensor, max_targets: int) -> torch.Tensor:
    """Eigenvalue-gap heuristic (music.m determineNumTargets:109-125): the
    number of signal eigenvalues = argmax of consecutive-gap ratio."""
    lam = torch.sort(eigvals.real, descending=True).values
    lam = torch.clamp(lam, min=1e-30)
    ratios = lam[:-1] / lam[1:]
    n = torch.argmax(ratios) + 1
    return torch.clamp(n, 1, max_targets)


def _pick_peaks(spectrum: torch.Tensor, k: int):
    """Top-k local maxima of a 1D spectrum. Returns (idx [k], valid [k]).
    `>=` on both sides, so a plateau counts as peaks; the edge neighbours are
    the edge value minus one."""
    left = torch.cat([spectrum[:1] - 1, spectrum[:-1]])
    right = torch.cat([spectrum[1:], spectrum[-1:] - 1])
    is_peak = (spectrum >= left) & (spectrum >= right)
    neg_inf = torch.full((), -torch.inf, dtype=spectrum.dtype, device=spectrum.device)
    metric = torch.where(is_peak, spectrum, neg_inf)
    vals, idx = top_k_lowest_index_first(metric, k)
    return idx, torch.isfinite(vals)


def _noise_subspace_spectrum(eigvecs: torch.Tensor, scan: torch.Tensor, num_signals):
    """1 / ||Un^H a||^2 from eigenvectors in ascending eigenvalue order."""
    n = eigvecs.shape[0]
    # noise subspace = eigenvectors below the signal count; mask-based, so the
    # count may be a device scalar
    noise_mask = torch.arange(n, device=eigvecs.device) < (n - num_signals)
    un = eigvecs * noise_mask[None, :].to(eigvecs.dtype)
    proj = torch.matmul(un.conj().T, scan)  # [n, G]
    denom = torch.sum(torch.abs(proj) ** 2, dim=0)
    return 1.0 / torch.clamp(denom, min=1e-12)


def music_spectrum(ra: torch.Tensor, scan: torch.Tensor, num_signals) -> torch.Tensor:
    """P(theta) = 1 / ||Un^H a||^2 with Un the noise subspace of Ra (music.m:49-58)."""
    _, eigvecs = torch.linalg.eigh(ra)  # ascending
    return _noise_subspace_spectrum(eigvecs, scan, num_signals)


def _masked(valid: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, values, torch.full_like(values, torch.nan))


def _music_peaks(r: torch.Tensor, scan: torch.Tensor, k: int, n_sig=None):
    """One eigendecomposition -> (peak idx [k], valid [k], spectrum, n_sig)."""
    eigvals, eigvecs = torch.linalg.eigh(r)
    if n_sig is None:
        n_sig = estimate_num_targets(eigvals, k)
    spec = _noise_subspace_spectrum(eigvecs, scan, n_sig)
    idx, valid = _pick_peaks(spec, k)
    return idx, valid & (torch.arange(k, device=r.device) < n_sig), spec


def music_doa(
    ra: torch.Tensor,
    params: RadarDerived,
    max_targets: int = 4,
    num_detections: torch.Tensor | None = None,
    num_det_static: int | None = None,
):
    """MUSIC DoA on spatial covariance. Returns dict with azEst/elEst [K] + valid.

    num_detections (a device scalar) or num_det_static overrides the
    eigenvalue-gap estimate of the signal count (the reference passes the CFAR
    detection count).
    """
    scan, az, el = _params_scan(params, ra.device)
    if num_det_static is not None:
        n_sig = int(num_det_static)
    elif num_detections is not None:
        n_sig = torch.clamp(num_detections, 1, max_targets)
    else:
        n_sig = None
    idx, valid, spec = _music_peaks(ra, scan, max_targets, n_sig)
    return {
        "azEst": _masked(valid, az[idx]),
        "elEst": _masked(valid, el[idx]),
        "valid": valid,
        "spectrum": spec,
    }


def _spectrum_doa(spec: torch.Tensor, az: torch.Tensor, el: torch.Tensor, max_targets: int):
    idx, valid = _pick_peaks(spec, max_targets)
    return {
        "azEst": _masked(valid, az[idx]),
        "elEst": _masked(valid, el[idx]),
        "valid": valid,
        "spectrum": spec,
    }


def beamscan_doa(ra: torch.Tensor, params: RadarDerived, max_targets: int = 4):
    """Conventional beamscan P = a^H Ra a (digitalBF.m)."""
    scan, az, el = _params_scan(params, ra.device)
    spec = torch.sum(scan.conj() * torch.matmul(ra, scan), dim=0).real
    return _spectrum_doa(spec, az, el, max_targets)


def mvdr_doa(ra: torch.Tensor, params: RadarDerived, max_targets: int = 4):
    """MVDR (Capon) P = 1/(a^H Ra^-1 a) (mvdrBF.m), diagonally loaded."""
    scan, az, el = _params_scan(params, ra.device)
    n = ra.shape[0]
    load = 1e-6 * torch.trace(ra).real / n
    ra_inv = torch.linalg.inv(ra + load * torch.eye(n, dtype=ra.dtype, device=ra.device))
    denom = torch.sum(scan.conj() * torch.matmul(ra_inv, scan), dim=0).real
    spec = 1.0 / torch.clamp(denom, min=1e-12)
    return _spectrum_doa(spec, az, el, max_targets)


@lru_cache(maxsize=8)
def _music_2d_scans(params: RadarDerived, n_sym: int, n_sc: int, r_step: float,
                    v_step: float, device: torch.device):
    """Range and velocity steering matrices of `music_2d` on `device`:
    (ranges f32 [Gr], A_r c64 [n_sc, Gr], velocities f32 [Gv], A_v c64 [n_sym, Gv])."""
    (rmin, rmax), (vmin, vmax) = params.cfar_zone
    scs_hz = SPEED_OF_LIGHT / (2.0 * params.r_max)  # r_max = c/(2*scs)
    lam = SPEED_OF_LIGHT / params.fc
    ranges = np.arange(rmin, rmax + r_step / 2, r_step)
    vels = np.arange(vmin, vmax + v_step / 2, v_step)
    a_r = np.exp(-2j * np.pi * scs_hz * 2.0 * np.outer(np.arange(n_sc), ranges) / SPEED_OF_LIGHT)
    a_v = np.exp(2j * np.pi * params.tsri * 2.0 * np.outer(np.arange(n_sym), vels) / lam)
    return (
        torch.as_tensor(ranges.astype(np.float32), device=device),
        torch.as_tensor(a_r.astype(np.complex64), device=device),
        torch.as_tensor(vels.astype(np.float32), device=device),
        torch.as_tensor(a_v.astype(np.complex64), device=device),
    )


def music_2d(
    channel: torch.Tensor,
    params: RadarDerived,
    max_targets: int = 4,
    r_step: float = 0.5,
    v_step: float = 0.5,
):
    """Full range/velocity MUSIC (music2D.m:66-123) on the element-wise channel
    H [n_sym, n_sc] of one antenna.

    Rr = H^T conj(H)/nSym over subcarriers; Rv = H conj(H)^T/nSc over symbols;
    steering: range exp(-2j pi scs 2r n/c), velocity exp(2j pi Tsri 2v m/lambda).
    """
    n_sym, n_sc = channel.shape
    h_sc = channel.T  # [n_sc, n_sym]
    rr = torch.matmul(h_sc, h_sc.conj().T) / n_sym
    rv = torch.matmul(h_sc.T, h_sc.conj()) / n_sc
    ranges, a_r, vels, a_v = _music_2d_scans(params, n_sym, n_sc, r_step, v_step,
                                             channel.device)
    ri, rvalid, _ = _music_peaks(rr, a_r, max_targets)
    vi, vvalid, _ = _music_peaks(rv, a_v, max_targets)
    return {
        "rngEst": _masked(rvalid, ranges[ri]),
        "velEst": _masked(vvalid, vels[vi]),
        "valid": rvalid,
    }
