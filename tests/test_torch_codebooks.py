"""Parity of the port's codebooks, panel configurations, PRG precoding and
MAC tables with isac_tpu, on the CPU.

The codebooks and tables are host numpy on both sides, generated by each
package and compared element for element (values AND dtype: one PUSCH table
is complex128 in the reference, and the port reproduces that). prg_precode is
a sum of n_layers complex products per RE: a stated float32 tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isac_tpu.config.params import ULA as J_ULA
from isac_tpu.config.params import UPA as J_UPA
from isac_tpu.mac import tables as j_tables
from isac_tpu.ops import precoding as j_prec
from isac_tpu_torch.config.params import ULA as T_ULA
from isac_tpu_torch.config.params import UPA as T_UPA
from isac_tpu_torch.mac import tables as t_tables
from isac_tpu_torch.ops import precoding as t_prec

torch.set_num_threads(1)

# float32 sum of <= 4 complex products in another order: a few ulps of the largest
SUM_RTOL = 2e-6


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n1,n2,rank", [(2, 1, 1), (2, 1, 2), (4, 1, 1), (4, 1, 2), (2, 2, 1),
                                        (2, 2, 2), (4, 2, 1), (4, 2, 2), (8, 1, 2), (4, 2, 3),
                                        (1, 1, 2)])
def test_type1_mode2_codebook_equal(n1, n2, rank):
    """codebookMode 2 (ranks 1-2 with more than 2 ports; the rest fall through
    to the mode-1 table on both sides)."""
    _same(t_prec.type1_codebook(n1, n2, rank, codebook_mode=2),
          j_prec.type1_codebook(n1, n2, rank, codebook_mode=2))
    with pytest.raises(ValueError):
        t_prec.type1_codebook(n1, n2, rank, codebook_mode=3)


# every supported (Ng, N1, N2) at ranks 1-2; ranks 3-4 where the table stays
# small (the largest ones are tens of MB and are built the same way)
_MP_CASES = [(cfg, rank) for cfg in sorted(j_prec.MULTI_PANEL_CONFIGS) for rank in (1, 2, 3, 4)
             if rank <= 2 or cfg[0] * cfg[1] * cfg[2] <= 8]


@pytest.mark.parametrize("cfg,rank", _MP_CASES)
def test_multipanel_codebook_equal(cfg, rank):
    ng, n1, n2 = cfg
    _same(t_prec.type1_multipanel_codebook(ng, n1, n2, rank),
          j_prec.type1_multipanel_codebook(ng, n1, n2, rank))
    if ng == 2 and n1 * n2 <= 4:
        _same(t_prec.type1_multipanel_codebook(ng, n1, n2, rank, codebook_mode=2),
              j_prec.type1_multipanel_codebook(ng, n1, n2, rank, codebook_mode=2))


def test_multipanel_codebook_rejects_like_reference():
    assert t_prec.MULTI_PANEL_CONFIGS == j_prec.MULTI_PANEL_CONFIGS
    for args, kw in (((3, 2, 1, 1), {}), ((4, 2, 1, 1), {"codebook_mode": 2}),
                     ((2, 2, 1, 5), {}), ((2, 2, 1, 1), {"codebook_mode": 0})):
        with pytest.raises(ValueError):
            t_prec.type1_multipanel_codebook(*args, **kw)
        with pytest.raises(ValueError):
            j_prec.type1_multipanel_codebook(*args, **kw)


@pytest.mark.parametrize("n_ports,rank", [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 3), (4, 4)])
def test_pusch_codebook_equal(n_ports, rank):
    _same(t_prec.pusch_codebook(n_ports, rank), j_prec.pusch_codebook(n_ports, rank))
    assert t_prec.max_pusch_tpmi(n_ports, rank) == j_prec.max_pusch_tpmi(n_ports, rank)


def test_pusch_codebook_unsupported_raises():
    with pytest.raises(ValueError):
        t_prec.pusch_codebook(8, 1)


@pytest.mark.parametrize("kind,kw", [
    ("ula", dict(n_v=8, polarizations=2)), ("ula", dict(n_v=2, polarizations=2)),
    ("upa", dict(n_v=2, n_h=4, polarizations=2)),
    ("upa", dict(n_v=1, n_h=2, n_pv=1, n_ph=2, polarizations=2)),
    ("upa", dict(n_v=2, n_h=2, n_pv=2, n_ph=2, polarizations=2)),
    ("upa", dict(n_v=3, n_h=2, n_pv=1, n_ph=2, polarizations=2)),
])
def test_panel_configs_equal(kind, kw):
    a = (T_ULA if kind == "ula" else T_UPA)(**kw)
    b = (J_ULA if kind == "ula" else J_UPA)(**kw)
    assert t_prec.panel_dims_for_antenna(a) == j_prec.panel_dims_for_antenna(b)
    assert t_prec.panel_config_for_antenna(a) == j_prec.panel_config_for_antenna(b)


def test_panel_dims_single_pol_raises():
    with pytest.raises(ValueError):
        t_prec.panel_dims_for_antenna(T_ULA(n_v=4, polarizations=1))
    with pytest.raises(ValueError):
        t_prec.csirs_panel_dims(6)


@pytest.mark.parametrize("n_prb,prb_start,prg_size", [(4, 0, 2), (5, 3, 2), (6, 2, 4)])
def test_prg_indices_and_precode_equal(n_prb, prb_start, prg_size):
    np.testing.assert_array_equal(t_prec.prg_indices(n_prb, prg_size),
                                  j_prec.prg_indices(n_prb, prg_size))
    rng = np.random.default_rng(n_prb)
    n_prg = int(((np.arange(12 * n_prb) // 12 + prb_start) // prg_size).max()
                - (prb_start // prg_size)) + 1
    lg = (rng.standard_normal((2, 3, 12 * n_prb)) + 1j * rng.standard_normal((2, 3, 12 * n_prb))
          ).astype(np.complex64)
    w = (rng.standard_normal((n_prg, 4, 2)) + 1j * rng.standard_normal((n_prg, 4, 2))
         ).astype(np.complex64)
    want = np.asarray(j_prec.prg_precode(jnp.asarray(lg), jnp.asarray(w), prb_start, prg_size))
    got = t_prec.prg_precode(torch.as_tensor(lg), torch.as_tensor(w), prb_start, prg_size).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=SUM_RTOL * np.abs(want).max())


@pytest.mark.parametrize("table", ["qam64", "qam256"])
def test_mac_tables_equal(table):
    assert t_tables.max_mcs(table) == j_tables.max_mcs(table)
    for cqi in range(-1, 18):
        assert t_tables.cqi_to_mcs(cqi, table) == j_tables.cqi_to_mcs(cqi, table)
    np.testing.assert_array_equal(t_tables.CQI_EFFICIENCY, j_tables.CQI_EFFICIENCY)
    for n_prb in (1, 36, 37, 72, 73, 144, 145, 273, 275, 300):
        for config in (1, 2):
            assert t_tables.rbg_size(n_prb, config) == j_tables.rbg_size(n_prb, config)
