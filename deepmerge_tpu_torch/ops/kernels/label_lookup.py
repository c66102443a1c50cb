"""The label-map relabel lookup (kernel K9) and its plain PyTorch version.

Counterpart of the TPU kernel in ``tools/gather_probe.py`` (``kern``), the
tail of ``merged_label_map``: every pixel of an (H, W) int32 superpixel map
looks up its region's dense cluster id in an R-entry int32 table. Ids out of
range read as the JAX package's ``dense[idx]`` reads them on the CPU: a
negative id wraps once (``idx + R``), then the id is clamped to
``[0, R - 1]``. The CUDA kernel (``csrc/label_lookup.cu``) stages the table
in shared memory and streams the map in 16-byte vectors; it reads the int32
map as it is, where ``table[map.long()]`` first writes an int64 copy.
"""

from __future__ import annotations

import ctypes

import torch

from deepmerge_tpu_torch.ops.kernels import build

# tables up to this many bytes are staged in shared memory (two CTAs an SM
# still fit); larger ones are read through the read-only cache
MAX_SHARED_TABLE_BYTES = 96 * 1024
BLOCKS_PER_SM = 2
_THREADS = 512  # kThreads of csrc/label_lookup.cu
_VECTOR_BYTES = 16

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # table, r, map, out, n, vec, blocks, shared_bytes, stream
    "dm_label_lookup": [_P, _I, _P, _P, _LL, _I, _I, _I, _P],
}


def label_lookup_ref(table: torch.Tensor, index_map: torch.Tensor
                     ) -> torch.Tensor:
    """Plain version: ``table[clamp(index_map)]``, negative ids wrapped
    once, then clamped to the table."""
    r = table.shape[0]
    idx = index_map.long()
    idx = torch.where(idx < 0, idx + r, idx).clamp_(0, r - 1)
    return table[idx]


def _check(table: torch.Tensor, index_map: torch.Tensor) -> None:
    if table.dtype != torch.int32 or table.dim() != 1 or table.numel() == 0:
        raise TypeError(f"table must be a non-empty 1-D int32 tensor, got "
                        f"{table.dtype} {tuple(table.shape)}")
    if index_map.dtype != torch.int32:
        raise TypeError(f"index_map must be int32, got {index_map.dtype}")
    if table.device != index_map.device:
        raise ValueError("table and index_map must be on the same device")
    if table.numel() >= 2 ** 31:
        raise ValueError(f"table of {table.numel()} entries: at most "
                         "2^31 - 1")


def label_lookup(table: torch.Tensor, index_map: torch.Tensor
                 ) -> torch.Tensor:
    """``out[p] = table[index_map[p]]`` (out-of-range ids as in the module
    docstring), an int32 tensor of ``index_map``'s shape.

    CPU tensors run ``label_lookup_ref``. CUDA tensors (contiguous) launch
    ``csrc/label_lookup.cu`` and count the launch in
    ``label_lookup.launches``; anything else raises.
    """
    _check(table, index_map)
    if index_map.device.type == "cpu":
        return label_lookup_ref(table, index_map)
    if index_map.device.type != "cuda":
        raise ValueError(f"unsupported device {index_map.device}")
    if not (table.is_contiguous() and index_map.is_contiguous()):
        raise ValueError("table and index_map must be contiguous")
    out = torch.empty_like(index_map)
    n = index_map.numel()
    if n == 0:
        return out
    r = table.shape[0]
    vec = int(index_map.data_ptr() % _VECTOR_BYTES == 0
              and out.data_ptr() % _VECTOR_BYTES == 0)
    sms = torch.cuda.get_device_properties(
        index_map.device).multi_processor_count
    # one int4 of pixels a thread in the first pass, at most a few CTAs an SM
    blocks = max(1, min(-(-n // (4 * _THREADS)), BLOCKS_PER_SM * sms))
    shared = 4 * r if 4 * r <= MAX_SHARED_TABLE_BYTES else 0
    lib = build.load("label_lookup", _SIGNATURES)
    stream = torch.cuda.current_stream(index_map.device).cuda_stream
    err = lib.dm_label_lookup(table.data_ptr(), r, index_map.data_ptr(),
                              out.data_ptr(), n, vec, blocks, shared, stream)
    build.check(lib, err, "dm_label_lookup")
    label_lookup.launches += 1
    return out


label_lookup.launches = 0
