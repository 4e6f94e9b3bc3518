"""Parity of the port's host-side tables and sequences with isac_tpu.

Everything here is integer, bit or host float64 data that the port keeps
its own numpy copy of, so every comparison is exact.
"""

import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import isac_tpu_torch
from isac_tpu.mac import tables as j_tables
from isac_tpu.ops import cdl as j_cdl
from isac_tpu.ops import dmrs as j_dmrs
from isac_tpu.ops import ldpc as j_ldpc
from isac_tpu.ops import ldpc_tables as j_ldpc_tables
from isac_tpu.ops import precoding as j_prec
from isac_tpu.ops import transport as j_transport
from isac_tpu.phy import chains as j_chains
from isac_tpu.utils import sequences as j_seq
from isac_tpu_torch.mac import tables as t_tables
from isac_tpu_torch.ops import cdl as t_cdl
from isac_tpu_torch.ops import dmrs as t_dmrs
from isac_tpu_torch.ops import ldpc as t_ldpc
from isac_tpu_torch.ops import ldpc_tables as t_ldpc_tables
from isac_tpu_torch.ops import precoding as t_prec
from isac_tpu_torch.ops import transport as t_transport
from isac_tpu_torch.phy import chains as t_chains
from isac_tpu_torch.utils import sequences as t_seq

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("c_init,length,offset", [
    (0, 31, 0), (1, 1000, 0), (12345, 4097, 17), ((1 << 31) - 1, 70000, 600),
])
def test_gold_sequence_equal(c_init, length, offset):
    np.testing.assert_array_equal(t_seq.gold_sequence(c_init, length, offset),
                                  j_seq.gold_sequence(c_init, length, offset))
    np.testing.assert_array_equal(t_seq.gold_qpsk(c_init, length // 2 + 1, offset),
                                  j_seq.gold_qpsk(c_init, length // 2 + 1, offset))


def test_extend_lfsr_equal():
    init = np.eye(24, dtype=np.uint8)
    np.testing.assert_array_equal(t_seq._extend_lfsr(init, 5000, (0, 1, 5, 6, 23), 24),
                                  j_seq._extend_lfsr(init, 5000, (0, 1, 5, 6, 23), 24))


@pytest.mark.parametrize("table", ["qam64", "qam256"])
def test_mcs_info_equal(table):
    n = len(j_tables.MCS_TABLE_64QAM if table == "qam64" else j_tables.MCS_TABLE_256QAM)
    for mcs in range(n):
        assert t_tables.mcs_info(mcs, table) == j_tables.mcs_info(mcs, table)


@pytest.mark.parametrize("bg", [1, 2])
def test_ldpc_tables_equal(bg):
    assert t_ldpc_tables.build_entries(bg) == j_ldpc_tables.build_entries(bg)
    t_ldpc_tables.validate_tables()


def test_ldpc_tables_override_hook(tmp_path, monkeypatch):
    """ISAC_TPU_LDPC_TABLES is honoured the same way by both packages."""
    data = {f"bg{bg}": [[r, c, list(s)] for r, c, s in j_ldpc_tables.build_entries(bg)]
            for bg in (1, 2)}
    orig = data["bg1"][40][2][0]
    data["bg1"][40][2][0] = (orig + 1) % 200
    p = tmp_path / "tables.json"
    p.write_text(json.dumps(data))
    monkeypatch.setenv("ISAC_TPU_LDPC_TABLES", str(p))
    assert t_ldpc_tables.build_entries(1) == j_ldpc_tables.build_entries(1)
    assert t_ldpc_tables.build_entries(1)[40][2][0] == (orig + 1) % 200
    data["bg2"][0][1] = 50
    p.write_text(json.dumps(data))
    with pytest.raises(ValueError, match="support mismatch"):
        t_ldpc_tables.build_entries(2)


@pytest.mark.parametrize("bg,z", [(1, 384), (1, 20), (2, 52), (2, 160), (2, 64)])
def test_lifted_code_equal(bg, z):
    a, b = t_ldpc.lifted_code(bg, z), j_ldpc.lifted_code(bg, z)
    for f in ("rows", "cols", "shifts"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.k, a.n_full, a.n_rows, a.n_cols, a.k_cols) == (b.k, b.n_full, b.n_rows,
                                                             b.n_cols, b.k_cols)
    assert t_ldpc.LIFTING_SIZES == j_ldpc.LIFTING_SIZES


def test_ldpc_selection_rules_equal():
    for a_bits in (100, 292, 293, 3824, 3825, 20000):
        for rate in (0.2, 0.25, 0.5, 0.67, 0.7, 0.9):
            assert t_ldpc.select_base_graph(a_bits, rate) == j_ldpc.select_base_graph(a_bits, rate)
    for bg in (1, 2):
        for b_bits in (100, 192, 193, 560, 561, 640, 641, 5000):
            kb = t_ldpc.kb_for(bg, b_bits)
            assert kb == j_ldpc.kb_for(bg, b_bits)
            for kp in (40, 1000, 3840, 8448):
                if kb * 384 >= kp:
                    assert t_ldpc.select_lifting_size(kb, kp) == j_ldpc.select_lifting_size(kb, kp)


def test_dmrs_values_equal():
    assert t_dmrs.DMRS_SYMBOLS_TYPE_A == j_dmrs.DMRS_SYMBOLS_TYPE_A
    for slot, sym, n_id, prbs in [(0, 2, 1, tuple(range(51))), (7, 11, 513, (0, 3, 4, 9)),
                                  (19, 5, 0, tuple(range(10, 30)))]:
        np.testing.assert_array_equal(t_dmrs.dmrs_values_for_prbs(slot, sym, n_id, prbs),
                                      j_dmrs.dmrs_values_for_prbs(slot, sym, n_id, prbs))


@pytest.mark.parametrize("ports,rank", [(16, 1), (16, 2), (16, 3), (16, 4), (4, 2), (8, 1)])
def test_type1_codebook_equal(ports, rank):
    n1, n2 = t_prec.csirs_panel_dims(ports)
    assert (n1, n2) == j_prec.csirs_panel_dims(ports)
    np.testing.assert_array_equal(t_prec.type1_codebook(n1, n2, rank),
                                  j_prec.type1_codebook(n1, n2, rank))


@pytest.mark.parametrize("profile,seed", [("CDL-A", 0), ("CDL-D", 3), ("CDL-C", 7)])
def test_build_cdl_link_equal(profile, seed):
    """The port's CDL ray constants equal the reference's for the same seed."""
    lam = 3e8 / 3.5e9
    etx = np.stack([np.zeros(16), np.repeat(np.arange(8), 2) * 0.5 * lam, np.zeros(16)], -1)
    erx = np.stack([np.zeros(2), np.arange(2) * 0.5 * lam, np.zeros(2)], -1)
    a = t_cdl.build_cdl_link(profile, 300.0, 3.5e9, etx, erx, ue_velocity=0.43, seed=seed)
    b = j_cdl.build_cdl_link(profile, 300.0, 3.5e9, etx, erx, ue_velocity=0.43, seed=seed)
    for f in ("coeff", "tau", "nu"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(t_cdl.subcarrier_freqs(612, 30e3),
                                  j_cdl.subcarrier_freqs(612, 30e3))


def test_transport_config_equal():
    for mod, n_layers, n_prb, nre, rate in [("QPSK", 1, 4, 132, 0.12), ("64QAM", 2, 273, 144, 0.455),
                                            ("16QAM", 1, 51, 144, 0.37), ("256QAM", 4, 100, 156, 0.9)]:
        tbs = t_transport.nr_tbs(mod, n_layers, n_prb, nre, rate)
        assert tbs == j_transport.nr_tbs(mod, n_layers, n_prb, nre, rate)
        qm = {"QPSK": 2, "16QAM": 4, "64QAM": 6, "256QAM": 8}[mod]
        g = n_prb * nre * qm * n_layers
        a, b = t_transport.sch_config(tbs, rate, qm, n_layers, g), \
            j_transport.sch_config(tbs, rate, qm, n_layers, g)
        assert vars(a) == vars(b)
        assert t_transport._cb_groups(a) == j_transport._cb_groups(b)


@pytest.mark.parametrize("kw", [
    dict(n_prb=273, mcs=19, n_layers=2), dict(n_prb=4, mcs=10),
    dict(n_prb=6, mcs=27, n_layers=2, n_sym=12, dmrs_add_pos=2),
    dict(n_prb=4, mcs=5, reserved_per_prb=((5, 0), (5, 6))),
])
def test_grant_layout_equal(kw):
    a = t_chains._layout(t_chains.SCHGrant(**kw).layout_key())
    b = j_chains._layout(j_chains.SCHGrant(**kw).layout_key())
    for k in ("dsyms", "n_re", "tbs", "n_sc_c", "data_syms", "full_rows"):
        assert a[k] == b[k], k
    for k in ("sym_idx", "sc_idx"):
        np.testing.assert_array_equal(a[k], b[k])
    assert vars(a["cfg"]) == vars(b["cfg"])
    for n_layers in (1, 2, 3, 4):
        assert t_chains.dmrs_ports(n_layers) == j_chains.dmrs_ports(n_layers)


def test_port_imports_neither_jax_nor_isac_tpu():
    """Every module of isac_tpu_torch, and tools/torch_mp_worker.py, imports
    in a fresh interpreter without pulling in jax or isac_tpu, nor matplotlib
    (viz.py imports it on first use only)."""
    mods = [m.name for m in pkgutil.walk_packages(isac_tpu_torch.__path__, "isac_tpu_torch.")]
    # a sub-package without __init__.py would silently drop out of the walk
    for m in ("parallel.links", "example", "config.params", "config.scenarios", "ops.ofdm",
              "ops.dft", "ops.sensing.doa", "ops.sensing.echo", "sim.sensing", "utils.windows",
              "ops.csi", "ops.csirs", "ops.srs", "ops.pathloss", "phy.passthrough",
              "sim.cell", "mac.harq", "mac.lcp", "mac.pdu", "mac.scheduler", "rlc.um",
              "rlc.am", "app.traffic", "metrics.kpi", "metrics.logger", "utils.prng",
              "utils.tracing", "topology.blockages", "topology.osm", "topology.wraparound",
              "sim.network", "metrics.persist", "api", "viz", "sim.block", "parallel.mesh",
              "parallel.distributed", "parallel.cells", "parallel.time_blocks"):
        assert f"isac_tpu_torch.{m}" in mods, m
    # the torch-only multi-process worker: no jax / isac_tpu import anywhere in
    # it (also not inside its functions), and its module imports clean
    worker = REPO / "tools" / "torch_mp_worker.py"
    for node in ast.walk(ast.parse(worker.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "isac_tpu"), n
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"spec = importlib.util.spec_from_file_location('torch_mp_worker', {str(worker)!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'isac_tpu', 'matplotlib'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
