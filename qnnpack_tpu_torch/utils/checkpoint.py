"""Packed-weight bundle save/load: a port of qnnpack_tpu/utils/checkpoint.py.

The bundle format is the JAX package's, so a bundle saved by either
package loads in the other: one .npz holding, for record i of a flat list
of packed records (None entries kept), `w_i` (the biased int8 weights in
the JAX layout) and `b_i` (the folded int32 bias), and `__meta__`, the
JSON list of each record's kind ("gemm" or "conv") and its constructor
fields - never the derived ones.  Loading rebuilds every record through
its constructor, so `w_kmajor`, `bias_c`, `w_dw` and `w_stem` are derived
as at packing (nn/packing.py, nn/conv.py).

The JAX GEMM record has one more field, `w_aug` (an MXU trick the port
does not carry); its bundles hold "w_aug": null, and so do the port's.

One record kind differs between the packages: the port packs an imported
1x1 stride-1 unpadded conv as GEMM weights (models/graph.py:is_gemm_conv)
where the JAX params hold a conv record.  Given the graph's spec,
save_params writes such a record in the JAX conv form (w [1, 1, K, N]) and
load_params converts as models/graph.py:params_from_jax does.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..device import resolve_device
from ..nn.conv import PackedConvWeights
from ..nn.packing import PackedGemmWeights, as_tensor

_FIELDS = {
    "gemm": ("k", "n", "input_zero_point", "kernel_zero_point"),
    "conv": ("kernel_height", "kernel_width", "group_input_channels",
             "group_output_channels", "groups", "input_zero_point",
             "kernel_zero_point"),
}
_KINDS = {"gemm": PackedGemmWeights, "conv": PackedConvWeights}


def _as_jax_conv(record: PackedGemmWeights) -> tuple:
    """(meta, w) of GEMM weights in the JAX 1x1 conv record's form."""
    meta = dict(kind="conv", kernel_height=1, kernel_width=1,
                group_input_channels=record.k,
                group_output_channels=record.n, groups=1,
                input_zero_point=record.input_zero_point,
                kernel_zero_point=record.kernel_zero_point)
    return meta, record.w.reshape(1, 1, record.k, record.n)


def _entry(record, as_conv: bool) -> tuple:
    """(meta, w) of one record as the bundle holds it."""
    if isinstance(record, PackedGemmWeights):
        if as_conv:
            return _as_jax_conv(record)
        kind = "gemm"
    elif isinstance(record, PackedConvWeights):
        kind = "conv"
    else:
        raise TypeError(f"not a packed record: {type(record).__name__}")
    meta = {"kind": kind,
            **{f: int(getattr(record, f)) for f in _FIELDS[kind]}}
    if kind == "gemm":
        meta["w_aug"] = None
    return meta, record.w


def save_params(path, params, spec=None):
    """Write a flat list of packed records (None entries kept) to `path`.
    `spec`, the graph's GraphSpec, marks the `conv` layers whose records
    are GEMM weights; they are written as JAX conv records."""
    conv_layers = set() if spec is None else {
        i for i, (tag, _, _) in enumerate(spec.layers) if tag == "conv"}
    arrays, metas = {}, []
    for i, p in enumerate(params):
        if p is None:
            metas.append(None)
            continue
        meta, w = _entry(p, i in conv_layers)
        metas.append(meta)
        arrays[f"w_{i}"] = w.cpu().numpy()
        arrays[f"b_{i}"] = p.bias_folded.cpu().numpy()
    arrays["__meta__"] = np.frombuffer(json.dumps(metas).encode(),
                                       dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def _read(path) -> list:
    """The bundle's records as dicts of their meta fields, `w` and
    `bias_folded` (numpy); None entries kept."""
    with np.load(path) as z:
        metas = json.loads(bytes(z["__meta__"].tobytes()).decode())
        records = []
        for i, meta in enumerate(metas):
            if meta is None:
                records.append(None)
                continue
            meta = dict(meta)
            w_aug = meta.pop("w_aug", None)
            if w_aug is not None:
                raise ValueError(
                    f"record {i}: w_aug {w_aug!r} is not null; the port's "
                    "GEMM records take no augmented weights (the kernels sum "
                    "the activation rows themselves)")
            if meta.get("kind") not in _KINDS:
                raise ValueError(f"record {i}: unknown kind "
                                 f"{meta.get('kind')!r}")
            extra = set(meta) - {"kind", *_FIELDS[meta["kind"]]}
            if extra:
                raise ValueError(f"record {i}: unknown fields "
                                 f"{sorted(extra)}")
            records.append(dict(meta, w=z[f"w_{i}"],
                                bias_folded=z[f"b_{i}"]))
    return records


def load_params(path, device="cuda", spec=None):
    """The packed records of a bundle saved by either package, on `device`
    (the GPU unless the caller asks for the CPU).  With `spec`, the
    records go through models/graph.py:params_from_jax, which turns an
    imported 1x1 conv record into GEMM weights as the port packs it."""
    dev = resolve_device(device)
    records = _read(path)
    if spec is not None:
        from ..models.graph import params_from_jax
        return params_from_jax(records, spec, device=dev)
    out = []
    for rec in records:
        if rec is None:
            out.append(None)
            continue
        kind = rec["kind"]
        out.append(_KINDS[kind](
            w=as_tensor(rec["w"], torch.int8, dev).contiguous(),
            bias_folded=as_tensor(rec["bias_folded"], torch.int32, dev),
            **{f: rec[f] for f in _FIELDS[kind]}))
    return out
