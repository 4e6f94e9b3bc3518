"""Result persistence + replay (counterpart of isac_tpu/metrics/persist.py,
in its exact file schema: a file written by either package loads in the
other to an equal tree).

The reference saves per-cell logs/metrics to MAT files at the end of
cellSimulation (`+simulation/cellSimulation.m:204-277`: simulationLogs /
simulationMetrics save() calls) and replays them offline through
`+visualizationTools/postSimVisualization.m:1-60`. TPU-native equivalent:
`save_result()` writes the FULL result dict (KPIs, scheduling-log surfaces,
sensing estimates/RMSE, nested network results) to a single `.npz` —
numpy arrays and torch tensors (CUDA ones copied to the host, complex kept
complex) as compressed entries, everything else as a JSON tree with array
placeholders — and `load_result()` restores a plain host-numpy dict that
`viz.save_all` renders identically to the live result.

Dataclass values (e.g. the sensing RadarDerived params) are flattened to
plain dicts on save — replay consumes data, not behavior — with their class
name recorded under `__dataclass__`.
"""

from __future__ import annotations

import dataclasses
import io
import json

import numpy as np
import torch


def _encode(obj, arrays: list):
    """Recursively convert to a JSON tree; arrays land in `arrays`."""
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        # JSON has no NaN/Inf literal; tag them
        if np.isnan(obj):
            return {"__f__": "nan"}
        if np.isinf(obj):
            return {"__f__": "inf" if obj > 0 else "-inf"}
        return obj
    if isinstance(obj, (np.bool_, np.integer)):
        return _encode(obj.item(), arrays)
    if isinstance(obj, np.floating):
        return _encode(float(obj), arrays)
    if isinstance(obj, torch.Tensor):  # device values pulled to the host
        arrays.append(obj.detach().cpu().numpy())
        return {"__a__": len(arrays) - 1}
    if isinstance(obj, dict):
        return {"__d__": {str(k): _encode(v, arrays) for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {"__l__": [_encode(v, arrays) for v in obj],
                "__t__": isinstance(obj, tuple)}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        d = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
        enc = _encode(d, arrays)
        enc["__dataclass__"] = type(obj).__name__
        return enc
    a = np.asarray(obj)
    if a.dtype == object:
        return {"__repr__": repr(obj)[:200]}  # last-resort opaque value
    arrays.append(a)
    return {"__a__": len(arrays) - 1}


def _decode(node, arrays):
    if isinstance(node, dict):
        if "__a__" in node:
            return arrays[f"a{node['__a__']}"]
        if "__f__" in node:
            return float(node["__f__"])  # 'nan' / 'inf' / '-inf'
        if "__d__" in node:
            out = {k: _decode(v, arrays) for k, v in node["__d__"].items()}
            if "__dataclass__" in node:
                out["__dataclass__"] = node["__dataclass__"]
            return out
        if "__repr__" in node:
            return node["__repr__"]
        if "__l__" in node:
            vals = [_decode(v, arrays) for v in node["__l__"]]
            return tuple(vals) if node.get("__t__") else vals
    return node


def save_result(result: dict, path: str) -> str:
    """Persist a CellSimulator / network_simulation result dict to `path`
    (.npz appended if missing). Returns the written path."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    arrays: list = []
    tree = _encode(result, arrays)
    payload = {f"a{i}": a for i, a in enumerate(arrays)}
    payload["__tree__"] = np.frombuffer(
        json.dumps(tree).encode("utf-8"), dtype=np.uint8
    )
    with open(path, "wb") as f:
        np.savez_compressed(f, **payload)
    return path


def load_result(path: str) -> dict:
    """Load a save_result() file back into a plain host-numpy result dict
    (dataclasses come back as dicts carrying `__dataclass__`)."""
    with np.load(path, allow_pickle=False) as z:
        tree = json.loads(bytes(z["__tree__"].tobytes()).decode("utf-8"))
        arrays = {k: z[k] for k in z.files if k != "__tree__"}
    return _decode(tree, arrays)
