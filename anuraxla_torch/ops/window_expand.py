"""Window expansion: a batch's PCM16 source runs -> [B, row_len] f32 rows.

A fleet scan's batch travels as one int16 span slot (``pipeline/stream.py``
``fleet_span_batches``): a table of ``B`` (offset, length) int32 pairs, one a
row, then the source runs the rows are cut from, each sample once. Row ``j``
is ``runs[off_j : off_j + len_j] / 32768`` at column ``col`` of a zero row
of ``row_len`` (``col`` > 0: the mel kernel's pre-padded layout); a row of
length 0 is all zeros.

- ``window_expand``: on a CUDA tensor it launches the hand-written kernel of
  ``csrc/window_expand.cu`` or raises; a tensor on the CPU takes the plain
  version. ``window_expand.launches`` counts the kernel's launches.
- ``window_expand_plain``: the same function in plain PyTorch, a row at a
  time. ``/ 32768`` is exact in f32, so the kernel equals it bit for bit.
- ``slot_size`` and ``split_slot``: the slot's layout, which the host side
  writes (``fleet_span_batches``, the session's span ring) and the kernel
  reads.
"""

from __future__ import annotations

import ctypes
import functools

import torch

TABLE_INT16 = 4  # an (offset, length) int32 pair: four int16 values of the slot


def slot_size(rows: int, samples: int) -> int:
    """The int16 values of a slot holding the table of ``rows`` rows and
    ``samples`` source samples."""
    return rows * TABLE_INT16 + samples


def split_slot(slot: torch.Tensor, rows: int):
    """A slot's (table [rows, 2] int32, runs int16) views."""
    head = rows * TABLE_INT16
    return slot[:head].view(torch.int32).view(rows, 2), slot[head:]


def _check(slot: torch.Tensor, rows: int, num_samples: int, row_len: int, col: int) -> None:
    if slot.dtype != torch.int16 or slot.ndim != 1 or not slot.is_contiguous():
        raise ValueError(f"window_expand needs a contiguous 1-D int16 slot, got {slot.dtype} {tuple(slot.shape)}")
    if rows < 1 or slot.numel() < rows * TABLE_INT16:
        raise ValueError(f"a slot of {slot.numel()} int16 values holds no table of {rows} rows")
    if col < 0 or col + num_samples > row_len:
        raise ValueError(f"a row of {row_len} cannot hold {num_samples} samples at column {col}")


def window_expand_plain(slot: torch.Tensor, rows: int, num_samples: int, row_len: int, col: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on the slot's device."""
    _check(slot, rows, num_samples, row_len, col)
    table, runs = split_slot(slot, rows)
    out = torch.zeros((rows, row_len), dtype=torch.float32, device=slot.device)
    for j, (off, n) in enumerate(table.tolist()):
        out[j, col : col + n] = runs[off : off + n].to(torch.float32) / 32768.0
    return out


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel library, built at first use, with its C signature bound."""
    from anuraxla_torch.ops import _build

    lib = _build.load("window_expand")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    # slot, B, row_len, col, rows, stream
    lib.window_expand_launch.argtypes = [vp, i32, i32, i32, vp, vp]
    lib.window_expand_launch.restype = i32
    return lib


def window_expand(slot: torch.Tensor, rows: int, num_samples: int, row_len: int, col: int = 0) -> torch.Tensor:
    """The slot's ``rows`` windows as [rows, row_len] f32 rows (see the module
    docstring); the kernel on a CUDA tensor, the plain version on the CPU."""
    if slot.device.type == "cpu":
        return window_expand_plain(slot, rows, num_samples, row_len, col)
    if slot.device.type != "cuda":
        raise ValueError(f"window_expand runs on cuda or cpu tensors, got {slot.device}")
    _check(slot, rows, num_samples, row_len, col)
    if slot.data_ptr() % 8:
        raise ValueError("window_expand needs its slot's table on an 8-byte boundary")
    out = torch.empty((rows, row_len), dtype=torch.float32, device=slot.device)
    with torch.cuda.device(slot.device):
        err = _lib().window_expand_launch(slot.data_ptr(), rows, row_len, col, out.data_ptr(),
                                          torch.cuda.current_stream(slot.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window_expand launch failed: cudaError_t {err}")
    window_expand.launches += 1
    return out


window_expand.launches = 0  # the wrapper adds one where it launches the kernel
