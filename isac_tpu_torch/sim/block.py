"""Block-mode engine execution: a segment of slots' device work dispatched
after the host has planned the whole segment (counterpart of
isac_tpu/sim/block.py).

The per-slot engine (sim/cell.py run loop) defers every CRC / CSI / SRS
result to its protocol due slot. Protocol timing makes a better schedule
legal: with k1 >= 2 (schedulerEntity.m:2148-2171) and next-slot UL / SRS
processing, NOTHING is due at the host between consecutive feedback
boundaries (for DDDSU: 4 DL slots, then the U slot, per period). Block mode
therefore runs the host control plane (scheduling, TB building, BSR, SRS
grids: `CellSimulator._plan_slot`) ahead for every slot up to the next due
boundary, then dispatches the segment's device work at once: per-slot CDL
channel, transmit grids and CSI-RS, all-UE reception, SCH decode, CSI / SRS
estimation and report selection, and the sensing grids.

`dispatch_segment` calls the slot loop's own device halves
(`_apply_dl_tx`, `_dl_rx_phase`, `_apply_ul_tx`, `_ul_rx_phase`,
`_apply_srs`) slot by slot in the slot loop's order, with the same inputs
and the same `_slot_key(slot, salt)` keys, so every result is the slot
loop's bit for bit, and the results land in the same `_deferred` /
`_sen_slots` structures in the same order (the reference's `_wire`). Nothing
inside a segment reads a device result back to the host: the one readback
stays at the next boundary's `_materialize_due`. Each segment's dispatch
runs inside a ``cell.segment`` span (utils/tracing.py).

Not ported, being the relay's or XLA's: `_planes` (the re/im split of
complex host inputs), `prepack_due` (the relay's packed fetch issued
early), and the fused program itself (`_build_seg_fn`'s jit, cached in
`_SEG_CACHE` under `_sim_config_key`): eager PyTorch has no program to
compile or cache. Capturing a segment as a CUDA graph is the GPU form of
"one dispatched program" and is left to speed work.

Reference match: the hot loop +simulation/cellSimulation.m:147-202 (serial,
one UE and one slot at a time), with the feedback timing of
schedulerEntity.m:2148-2171.
"""

from __future__ import annotations

from isac_tpu_torch.utils import tracing


def dispatch_segment(sim, plans: list):
    """Run one planned segment's device work on `sim` (a CellSimulator) and
    record its length in `sim.segment_lens`."""
    if not plans:
        return
    sim.segment_lens.append(len(plans))
    with tracing.span("cell.segment"):
        for p in plans:
            s = p["slot"]
            if p["dl"] is not None:
                st = sim._apply_dl_tx(p["dl"])
                if st is not None:
                    sim._dl_rx_phase(s, p["csi"], st)
            if p["ul"] is not None:
                sim._ul_rx_phase(s, sim._apply_ul_tx(p["ul"]))
            if p["srs"] is not None:
                with tracing.span("cell.srs"):
                    sim._apply_srs(s, p["srs"])
