"""Post-simulation visualization (counterpart of isac_tpu/viz.py: the same
figures, so one saved result renders to the same PNG bytes in both packages)
of the reference's plot tooling (SURVEY §2.8):

- +visualizationTools/metricsVisualizer.m (throughput/goodput/BLER surfaces)
- +visualizationTools/gridVisualizer.m (RB-occupancy and CQI grids)
- +visualizationTools/postSimVisualization.m + +estimation/fft2D.m:151-167
  (range-Doppler map with detections and ground truth)
- tools/plotECDF.m (network-level ECDFs, networkSimulation.m:173-232)
- +simulation/networkSimulation.m:117-171 plotLoS (scenario map with LoS rays)

All functions are headless (matplotlib Agg, imported on first use), consume
the result dicts that `CellSimulator.run()` / `network_simulation()` already
produce, torch tensors (CUDA ones too) converted to numpy at each figure's
entry, and save PNGs. The engine never imports this module: plotting is a
pure post-pass, and no module on the simulation path needs matplotlib.

Chart conventions (accessibility-validated categorical palette; color carries
identity only, magnitude uses single-hue ramps, text stays in ink colors):
UE/series hues are assigned in fixed order and never cycled.
"""

from __future__ import annotations

import numpy as np
import torch

# fixed-order categorical palette (identity: UEs, series). Validated for
# adjacent-pair CVD separation on a light surface; never cycled — >8 series
# fold into "other".
PALETTE = (
    "#2a78d6",  # blue
    "#eb6834",  # orange
    "#1baf7a",  # aqua
    "#eda100",  # yellow
    "#e87ba4",  # magenta
    "#008300",  # green
    "#4a3aa7",  # violet
    "#8a8986",  # gray (other)
)
_INK = "#0b0b0b"
_INK_2 = "#52514e"
_GRID = "#e4e3df"


def _mpl():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _host(obj):
    """obj with every torch tensor in it (nested dicts, lists, tuples) as a
    host numpy array; anything else as it is."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def _style(ax, title: str, xlab: str, ylab: str):
    ax.set_title(title, color=_INK, fontsize=11)
    ax.set_xlabel(xlab, color=_INK_2, fontsize=9)
    ax.set_ylabel(ylab, color=_INK_2, fontsize=9)
    ax.tick_params(colors=_INK_2, labelsize=8)
    ax.grid(True, color=_GRID, linewidth=0.6)
    ax.set_axisbelow(True)
    for s in ax.spines.values():
        s.set_color(_GRID)


def plot_rb_grid(logs: dict, direction: str, path: str):
    """RB-occupancy grid: slot x RB colored by scheduled UE (gridVisualizer.m
    'RB' mode). logs = result['logs'] (SchedulingLogger.finalize())."""
    logs = _host(logs)
    plt = _mpl()
    from matplotlib.colors import ListedColormap

    grid = np.asarray(logs[direction]["rbGrid"], np.int32)  # 0 = unused
    n_ues = int(grid.max())
    colors = ["#f4f3f0"] + [PALETTE[min(u, len(PALETTE) - 1)] for u in range(n_ues)]
    fig, ax = plt.subplots(figsize=(8, 4), dpi=120)
    ax.imshow(grid.T, aspect="auto", origin="lower", interpolation="nearest",
              cmap=ListedColormap(colors), vmin=0, vmax=n_ues)
    _style(ax, f"{direction} RB allocation (color = UE)", "slot", "PRB")
    handles = [plt.Rectangle((0, 0), 1, 1, fc=colors[u + 1]) for u in range(n_ues)]
    ax.legend(handles, [f"UE {u}" for u in range(n_ues)], fontsize=7,
              loc="upper right", framealpha=0.9)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def plot_cqi_grid(logs: dict, direction: str, ue: int, path: str):
    """CQI-in-force grid: slot x RB, single-hue magnitude ramp
    (gridVisualizer.m 'CQI' mode)."""
    logs = _host(logs)
    plt = _mpl()

    grid = np.asarray(logs[direction]["cqiGrid"], np.float64)[:, ue, :]
    fig, ax = plt.subplots(figsize=(8, 4), dpi=120)
    im = ax.imshow(grid.T, aspect="auto", origin="lower", interpolation="nearest",
                   cmap="Blues", vmin=0, vmax=15)
    _style(ax, f"{direction} CQI in force, UE {ue}", "slot", "PRB")
    fig.colorbar(im, ax=ax, label="CQI")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def plot_bler(logs: dict, path: str):
    """Per-UE slot BLER lines, DL and UL as two panels (phyLogger surfaces,
    metricsVisualizer live BLER plots)."""
    logs = _host(logs)
    plt = _mpl()

    fig, axes = plt.subplots(1, 2, figsize=(10, 3.5), dpi=120, sharey=True)
    for ax, d in zip(axes, ("DL", "UL")):
        bler = np.asarray(logs[d]["slotBLER"], np.float64)  # [slots, ues]
        for u in range(bler.shape[1]):
            m = np.isfinite(bler[:, u])
            if not m.any():
                continue
            ax.plot(np.nonzero(m)[0], bler[m, u], lw=2,
                    color=PALETTE[min(u, len(PALETTE) - 1)], label=f"UE {u}")
        _style(ax, f"{d} slot BLER", "slot", "BLER")
        ax.set_ylim(-0.02, 1.02)
    axes[0].legend(fontsize=7, loc="upper right")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def plot_throughput(comm: dict, path: str):
    """Per-UE throughput/goodput bars, DL and UL panels (metricsVisualizer
    performance indicators). comm = result['communication']."""
    comm = _host(comm)
    plt = _mpl()

    fig, axes = plt.subplots(1, 2, figsize=(10, 3.5), dpi=120)
    for ax, d in zip(axes, ("DL", "UL")):
        thr = np.asarray(comm[f"ue{d}ThroughputMbps"], np.float64)
        good = np.asarray(comm[f"ue{d}GoodputMbps"], np.float64)
        x = np.arange(thr.size)
        ax.bar(x - 0.2, thr, 0.36, color=PALETTE[0], label="throughput")
        ax.bar(x + 0.2, good, 0.36, color=PALETTE[2], label="goodput")
        _style(ax, f"{d} per-UE rate", "UE", "Mbps")
        ax.set_xticks(x)
    axes[0].legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def plot_ecdf(named_ecdfs: dict, path: str, xlab: str = "Mbps"):
    """Network-level ECDF curves (plotECDF.m / networkSimulation.m:173-232).
    named_ecdfs: {label: (sorted values, cumulative probs)} — the format
    network_simulation() emits under result['network']."""
    named_ecdfs = _host(named_ecdfs)
    plt = _mpl()

    fig, ax = plt.subplots(figsize=(6, 4), dpi=120)
    for i, (label, (v, p)) in enumerate(sorted(named_ecdfs.items())):
        v, p = np.asarray(v, np.float64), np.asarray(p, np.float64)
        if v.size == 0:
            continue
        ax.step(v, p, where="post", lw=2,
                color=PALETTE[min(i, len(PALETTE) - 1)], label=label)
    _style(ax, "network ECDF", xlab, "F(x)")
    ax.set_ylim(0, 1.02)
    ax.legend(fontsize=7, loc="lower right")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def plot_rdm(sensing: dict, path: str):
    """Range-Doppler map (dB, max over antennas) with CFAR detections and
    ground truth (fft2D.m plotRDM:151-167 + postSimVisualization.m).
    sensing = result['sensing'] ({'estimates', 'rmse', 'params'})."""
    sensing = _host(sensing)
    plt = _mpl()

    est, params = sensing["estimates"], sensing["params"]

    def _p(name):  # live RadarDerived object OR persist-replayed plain dict
        return params[name] if isinstance(params, dict) else getattr(params, name)

    rdm = np.asarray(est["rdm"])  # [n_ants, R, C]
    power = np.abs(rdm).max(axis=0) ** 2
    pdb = 10 * np.log10(np.maximum(power, power.max() * 1e-12))
    n_r, n_c = pdb.shape
    rng_axis = (np.arange(n_r) * _p("r_res"),)[0]
    vel_axis = (np.arange(n_c) - n_c // 2) * _p("v_res")
    # est['rdm'] is already Doppler-centered (rdm.py range_doppler_map applies
    # the fftshift), matching the velEst/truth axis convention (cfar.py) and
    # the reference's centered plot (fft2D.m:160) — plot it directly.
    pdb_disp = pdb
    fig, ax = plt.subplots(figsize=(6.5, 4.5), dpi=120)
    im = ax.imshow(
        pdb_disp, aspect="auto", origin="lower", interpolation="nearest",
        extent=[vel_axis[0], vel_axis[-1], rng_axis[0], rng_axis[-1]],
        cmap="Blues",
    )
    valid = np.asarray(est["valid"], bool)
    if valid.any():
        ax.scatter(np.asarray(est["velEst"])[valid], np.asarray(est["rngEst"])[valid],
                   s=70, facecolors="none", edgecolors=PALETTE[1], linewidths=2,
                   label="CFAR detection")
    ax.scatter(_p("velocity_ms"), _p("range_m"), s=60, marker="x",
               color=_INK, linewidths=2, label="truth")
    _style(ax, "range-Doppler map (dB)", "radial velocity (m/s)", "range (m)")
    ax.legend(fontsize=7, loc="upper right")
    fig.colorbar(im, ax=ax, label="power (dB)")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def plot_scenario(cells: list, path: str, walls: np.ndarray | None = None):
    """Scenario map: building footprints, gNB/UE positions, LoS/NLoS rays
    (networkSimulation.m plotLoS:117-171). cells = assign_cell_parameters()
    output (uses .gnb_position, .ue_positions, .ue_los)."""
    walls = _host(walls)
    plt = _mpl()

    fig, ax = plt.subplots(figsize=(6, 6), dpi=120)
    if walls is not None and len(walls):
        w = np.asarray(walls, np.float64)  # [N, 2, 3] segments
        for seg in w:
            ax.plot(seg[:, 0], seg[:, 1], color=_GRID, lw=1)
    for ci, cell in enumerate(cells):
        g = np.asarray(cell.gnb_position, np.float64)
        ues = np.asarray(cell.ue_positions, np.float64)
        los = np.asarray(getattr(cell, "ue_los", np.ones(len(ues))), bool)
        col = PALETTE[min(ci, len(PALETTE) - 1)]
        ax.scatter([g[0]], [g[1]], marker="^", s=110, color=col,
                   label=f"gNB {ci}", zorder=3)
        ax.scatter(ues[:, 0], ues[:, 1], s=26, color=col, zorder=3)
        for u, p in enumerate(ues):
            ax.plot([g[0], p[0]], [g[1], p[1]], lw=1.6 if los[u] else 1.0,
                    ls="-" if los[u] else ":", color=col, alpha=0.8)
    _style(ax, "scenario (solid = LoS, dotted = NLoS)", "x (m)", "y (m)")
    ax.set_aspect("equal")
    ax.legend(fontsize=7, loc="upper right")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def save_all(result: dict | str, prefix: str) -> list:
    """One call after CellSimulator.run(): write every applicable figure,
    return the paths (postSimVisualization.m equivalent).

    `result` may also be a path to a metrics.persist.save_result() file —
    offline replay, exactly the reference's saved-MAT-then-postSimVisualization
    flow (cellSimulation.m:204-277 -> postSimVisualization.m:1-60)."""
    if isinstance(result, str):
        from isac_tpu_torch.metrics.persist import load_result

        result = load_result(result)
    out = []

    def emit(fn, *a):
        path = a[-1]
        fn(*a)
        out.append(path)

    comm = result.get("communication")
    if comm is not None:
        emit(plot_throughput, comm, f"{prefix}_throughput.png")
    logs = result.get("logs")
    if logs is not None:
        emit(plot_rb_grid, logs, "DL", f"{prefix}_rb_dl.png")
        emit(plot_rb_grid, logs, "UL", f"{prefix}_rb_ul.png")
        emit(plot_cqi_grid, logs, "DL", 0, f"{prefix}_cqi_dl_ue0.png")
        emit(plot_bler, logs, f"{prefix}_bler.png")
    sensing = result.get("sensing")
    if sensing is not None and "rdm" in sensing.get("estimates", {}):
        emit(plot_rdm, sensing, f"{prefix}_rdm.png")
    return out
