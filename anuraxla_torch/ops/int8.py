"""Int8 contractions of the quantized serving encoder — the port of the int8
conv and dot of ``anuraxla/models/quant.py`` (``_int8_conv`` :204,
``_int8_dot`` :198, which XLA lowers to the TPU's matrix unit; neither is a
Pallas kernel) together with the quantization before each (``_quant_x``
:194) and the dequantization after it (:244, :256).

- ``int8_conv``: a 3x3 conv over NHWC input, stride 1 or 2, explicit
  (lo, hi) pads per axis, an HWIO int8 kernel; ``int8_dense``: [M, K] x
  [K, N] int8. Both return ``float(acc) * (sx[b] * sw[n]) + bias[n]`` in f32
  (``raw=True``: the int32 sums ``acc`` themselves). ``x`` is int8 codes, or
  f32 activations that the kernel quantizes as it loads them,
  ``clamp(round(x / sx), -127, 127)`` (the reference's ``_quant_x``,
  ``quantize_rows`` here). On a CUDA tensor they launch the hand-written
  Hopper kernel of ``csrc/int8_gemm.cu`` (int32 sums on the integer tensor
  cores) or raise; a tensor on the CPU takes the plain version.
  ``int8_conv.launches`` / ``int8_dense.launches`` count the kernel's
  launches.
- ``int8_conv_plain`` / ``int8_dense_plain``: the same function in plain
  PyTorch — ``quantize_rows`` for f32 x, ``patches`` (the reference's
  ``_patches``) and a float64 product, exact for these integer sums, cast to
  int32, then the same epilogue one rounding at a time. The kernel equals
  them bit for bit.
- ``pack_weight``: W ([K, N], a conv's HWIO kernel as [9 Cin, Cout]) in the
  layout the kernel's ``wgmma`` path streams, made once (``quantize_encoder``
  keeps it beside ``wq`` as ``"wq_packed"``); ``unpack_weight`` inverts it.
  ``wgmma_tile``, ``halo_fits`` (the form of a conv's A operand: the halo
  form wherever it fits, else the gathered one) and ``dense_splits`` are the
  kernel's choices, written here so that the CPU tests reach them.

``sx`` is one activation scale (calibrated) or one a row (dynamic: [B] or
[B, 1, 1, 1]); ``sw`` and ``bias`` are per output channel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

PLAIN_CHUNK = 1 << 25  # float64 elements of a patch block in the plain version (256 MB)
WGMMA_WIDTHS = (32, 64, 128, 256)  # columns a block of the wgmma path covers (BN)
MAX_STAGE_K = 128  # deepest stage of K the wgmma path streams (BK)
N_SM = 132  # H100 SXM's streaming multiprocessors: the dense's splits fill them once


def patches(x: torch.Tensor, stride: int, pads) -> torch.Tensor:
    """[B, H, W, C] -> [B, Ho, Wo, 9C] 3x3 im2col, channel fastest, matching
    a [3, 3, Cin, Cout] kernel reshaped to [9 Cin, Cout]."""
    (pt, pb), (pl, pr) = pads
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    hp, wp = xp.shape[1], xp.shape[2]
    ho = (hp - 3) // stride + 1
    wo = (wp - 3) // stride + 1
    pats = [
        xp[:, dy : dy + stride * (ho - 1) + 1 : stride, dx : dx + stride * (wo - 1) + 1 : stride, :]
        for dy in range(3)
        for dx in range(3)
    ]
    return torch.cat(pats, dim=-1)


def conv_out_hw(h: int, w: int, stride: int, pads) -> tuple[int, int]:
    (pt, pb), (pl, pr) = pads
    return (h + pt + pb - 3) // stride + 1, (w + pl + pr - 3) // stride + 1


def quantize_rows(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """f32 activations -> int8 codes, ``clamp(round(x / sx), -127, 127)``
    (round half to even), ``sx`` one value or one a row of ``x``: the
    reference's ``_quant_x`` (``anuraxla/models/quant.py:194``)."""
    s = sx.reshape(-1).to(torch.float32)
    s = s.reshape(-1, *([1] * (x.ndim - 1))) if s.numel() > 1 else s.reshape(())
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)


def _codes(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """The int8 operand: x as it is, or f32 x quantized by its row scales."""
    if x.dtype == torch.int8:
        return x
    if x.dtype != torch.float32:
        raise ValueError(f"x must be int8 codes or float32 activations, got {x.dtype}")
    return quantize_rows(x, _row_scales(sx, x.shape[0]))


def stage_depth(K: int) -> int:
    """BK: the deepest multiple of 32 up to ``MAX_STAGE_K`` that divides K
    rounded up to 32 (K = 288 -> 96: three stages, not a pad to 384)."""
    kp = -(-K // 32) * 32
    return next(bk for bk in range(MAX_STAGE_K, 0, -32) if kp % bk == 0)


def wgmma_tile(K: int, N: int, *, dense: bool = False):
    """(BN, BK) of the wgmma path for a [K, N] weight, or None where the
    shape takes the simple path: K % 16 == 0 (a conv's Cin % 16 == 0) and N
    in ``WGMMA_WIDTHS`` (one column tile), or for the dense also a multiple
    of 256 (column tiles of 256)."""
    if K % 16 or not (N in WGMMA_WIDTHS or (dense and N % 256 == 0)):
        return None
    return min(N, 256), stage_depth(K)


def pack_weight(w: torch.Tensor, bk: int | None = None, bn: int | None = None) -> torch.Tensor:
    """W [K, N] int8 (or a conv's HWIO kernel) -> [N / BN, S, BN, BK] int8:
    column tile, stage of K, then a stage's bytes in the K-major core-matrix
    order the kernel's ``wgmma`` reads without swizzle — k32 step, 8-column
    group, 16-byte half of the step, column, 16 bytes of k — with K padded
    by zeros to S whole stages. Plain torch, on W's device."""
    w2 = w.reshape(-1, w.shape[-1])
    K, N = w2.shape
    bn, bk = bn or min(N, 256), bk or stage_depth(K)
    if bk % 32 or N % bn or bn % 8:
        raise ValueError(f"no packing of [{K}, {N}] into stages of {bk} x {bn}")
    S = -(-K // bk)
    wp = torch.zeros((S * bk, N), dtype=torch.int8, device=w2.device)
    wp[:K] = w2
    # k = ((s * (bk/32) + j) * 2 + h) * 16 + b, n = (t * (bn/8) + g) * 8 + r
    t = wp.reshape(S, bk // 32, 2, 16, N // bn, bn // 8, 8)
    return t.permute(4, 0, 1, 5, 2, 6, 3).contiguous().reshape(N // bn, S, bn, bk)


def unpack_weight(packed: torch.Tensor, K: int) -> torch.Tensor:
    """The inverse of ``pack_weight``: [K, N] (the padding dropped)."""
    T, S, bn, bk = packed.shape
    t = packed.reshape(T, S, bk // 32, bn // 8, 2, 8, 16).permute(1, 2, 4, 6, 0, 3, 5)
    return t.reshape(S * bk, T * bn)[:K]


def halo_fits(B: int, H: int, W: int, cin: int, cout: int, stride: int, pads, bk: int) -> bool:
    """Whether a conv takes the halo form of the wgmma path
    (``csrc/int8_gemm.cu``; the gathered form otherwise): Cin a power of two
    from 32 to 1024, stride 1 with pads of 1 or stride 2, the input and its
    padded grid indexed in 32 bits, the ring and the strips within the
    card's 227 KB (the kernel's ``halo_smem_bytes``) — the launch's own
    checks."""
    ho, wo = conv_out_hw(H, W, stride, pads)
    if (cin < 32 or cin > 1024 or cin & (cin - 1) or cout not in WGMMA_WIDTHS or stride not in (1, 2)
            or (stride == 1 and tuple(map(tuple, pads)) != ((1, 1), (1, 1)))):
        return False
    planes, gw, gh = (1, W + 2, H + 2) if stride == 1 else (4, wo + 1, ho + 1)
    if B * H * W * cin >= 1 << 31 or B * gh * gw >= (1 << 31) - 128:
        return False
    strip = 128 + (2 * gw + 2 if stride == 1 else gw + 1)
    rows = (strip + 7) // 8 * 8 + 1
    smem = max(4 * cout * bk + planes * cin * rows, 128 * cout * 4) + 16 * 4 + 8 * 128 + 12 * planes * strip
    return smem <= 232448


def dense_splits(m_tiles: int, n_tiles: int, n_stages: int, n_sm: int = N_SM) -> int:
    """Splits of the dense's K: as many as fill ``n_sm`` blocks once over the
    m_tiles x n_tiles output tiles, at least 1 and at most one a stage."""
    return max(1, min(n_stages, n_sm // max(1, m_tiles * n_tiles)))


def split_ranges(n_stages: int, splits: int) -> list[tuple[int, int]]:
    """The stages [begin, end) split z streams, as the kernel computes them."""
    return [(z * n_stages // splits, (z + 1) * n_stages // splits) for z in range(splits)]


def _row_scales(sx: torch.Tensor, B: int) -> torch.Tensor:
    """sx as [B] or [1]: one value, or one a row."""
    s = sx.reshape(-1).to(torch.float32)
    if s.numel() not in (1, B):
        raise ValueError(f"sx must hold one scale or one a row ({B}), got shape {tuple(sx.shape)}")
    return s


def dequantize(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """[M, N] int32 sums of rows of B equal groups -> float(acc) * (sx * sw) +
    bias, one rounding a step (the kernel's epilogue)."""
    B = sx.numel()
    scale = sx.reshape(B, 1) * sw.reshape(1, -1)  # [B or 1, N]
    y = acc.to(torch.float32).reshape(B, -1, acc.shape[-1]) * scale[:, None, :]
    return (y + bias).reshape(acc.shape)


def _int_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 x [K, N] int8 -> [M, N] int32, exactly: every partial sum
    is an integer under 2^53, so float64 sums in any order are exact."""
    wd = w.to(torch.float64)
    rows = max(1, PLAIN_CHUNK // max(1, a.shape[1]))
    out = torch.empty((a.shape[0], w.shape[1]), dtype=torch.int32, device=a.device)
    for i in range(0, a.shape[0], rows):
        out[i : i + rows] = (a[i : i + rows].to(torch.float64) @ wd).to(torch.int32)
    return out


def int8_conv_plain(xq, wq, sx, sw, bias, stride: int, pads, *, raw: bool = False) -> torch.Tensor:
    """The plain version of ``int8_conv`` (f32 x: ``quantize_rows`` first)."""
    xq = _codes(xq, sx)
    B, H, W, _ = xq.shape
    ho, wo = conv_out_hw(H, W, stride, pads)
    n = wq.shape[-1]
    w2 = wq.reshape(-1, n)
    acc = torch.empty((B, ho * wo, n), dtype=torch.int32, device=xq.device)
    per = max(1, PLAIN_CHUNK // max(1, ho * wo * w2.shape[0]))  # rows of the batch a patch block
    for i in range(0, B, per):
        p = patches(xq[i : i + per], stride, pads)
        acc[i : i + per] = _int_product(p.reshape(-1, p.shape[-1]), w2).reshape(-1, ho * wo, n)
    acc = acc.reshape(B, ho, wo, n)
    if raw:
        return acc
    return dequantize(acc.reshape(-1, n), _row_scales(sx, B), sw, bias).reshape(B, ho, wo, n)


def int8_dense_plain(xq, wq, sx, sw, bias, *, raw: bool = False) -> torch.Tensor:
    """The plain version of ``int8_dense`` (f32 x: ``quantize_rows`` first)."""
    acc = _int_product(_codes(xq, sx), wq)
    if raw:
        return acc
    return dequantize(acc, _row_scales(sx, xq.shape[0]), sw, bias)


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel library, built at first use, with its C signatures bound."""
    from anuraxla_torch.ops import _build

    lib = _build.load("int8_gemm")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    # x, x_f32, w, wp, bk, n_stages, halo, sx, sx_stride, sw, bias, out, out_i32,
    # B, H, W, Cin, Cout, Ho, Wo, stride, pad_t, pad_l, stream
    lib.int8_conv_launch.argtypes = [vp, i32, vp, vp, i32, i32, i32, vp, i32, vp, vp, vp, vp, *[i32] * 10, vp]
    lib.int8_conv_launch.restype = i32
    # x, x_f32, w, wp, bk, n_stages, bn, splits, ws, counters, sx, sx_stride, sw, bias, out, out_i32, M, K, N, stream
    lib.int8_dense_launch.argtypes = [vp, i32, vp, vp, i32, i32, i32, i32, vp, vp, vp, i32, vp, vp, vp, vp,
                                      i32, i32, i32, vp]
    lib.int8_dense_launch.restype = i32
    return lib


def _check_cuda(name: str, x, wq, sx, sw, bias, raw: bool):
    """The kernel's operands, checked: int8 or f32 contiguous x, int8 w, f32
    scales (f32 x: always; int8 x: not with ``raw``) and bias on x's card;
    x moved to a 16-byte boundary if a view left it off one."""
    if x.dtype not in (torch.int8, torch.float32) or wq.dtype != torch.int8:
        raise ValueError(f"{name} needs int8 or float32 x and int8 w, got {x.dtype} and {wq.dtype}")
    if wq.device != x.device:
        raise ValueError(f"{name}: w is on {wq.device}, x on {x.device}")
    x, wq = x.contiguous(), wq.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    if raw and x.dtype == torch.int8:
        return x, wq, None, None, None
    sx = _row_scales(sx, x.shape[0]).contiguous()
    if sx.device != x.device:
        raise ValueError(f"{name}: sx is on {sx.device}, x on {x.device}")
    if raw:
        return x, wq, sx, None, None
    sw, bias = sw.to(torch.float32).contiguous(), bias.to(torch.float32).contiguous()
    for t, what in ((sw, "sw"), (bias, "bias")):
        if t.device != x.device:
            raise ValueError(f"{name}: {what} is on {t.device}, x on {x.device}")
    if sw.numel() != wq.shape[-1] or bias.numel() != wq.shape[-1]:
        raise ValueError(f"{name}: sw and bias need {wq.shape[-1]} values, got {sw.numel()} and {bias.numel()}")
    return x, wq, sx, sw, bias


def _packed(name: str, wq, packed):
    """The wgmma path's W for ``wq`` ([K, N] or HWIO): ``packed`` checked
    against it, else packed here; None where the shape takes the simple path."""
    K, N = wq.numel() // wq.shape[-1], wq.shape[-1]
    tile = wgmma_tile(K, N, dense=wq.ndim == 2)
    if tile is None:
        if packed is not None:
            raise ValueError(f"{name}: a [{K}, {N}] weight takes the simple path, which reads wq, not a packed W")
        return None
    if packed is None:
        return pack_weight(wq)
    bn, bk = tile
    want = (N // bn, -(-K // packed.shape[-1]) if packed.ndim == 4 else 0, bn)
    if (packed.dtype != torch.int8 or packed.ndim != 4 or tuple(packed.shape[:3]) != want
            or packed.shape[-1] % 32 or packed.device != wq.device):
        raise ValueError(f"{name}: packed W {tuple(packed.shape)} {packed.dtype} on {packed.device} is not "
                         f"pack_weight's layout of a [{K}, {N}] int8 weight on {wq.device}")
    return packed.contiguous()


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _ptr(t):
    return t.data_ptr() if t is not None else None


def int8_conv(xq, wq, sx, sw, bias, stride: int, pads, *, raw: bool = False, packed=None) -> torch.Tensor:
    """[B, H, W, Cin] NHWC x — int8 codes, or f32 quantized by ``sx`` as the
    kernel loads it — * [3, 3, Cin, Cout] int8 (HWIO), stride 1 or 2, pads
    ((top, bottom), (left, right)) -> [B, Ho, Wo, Cout] f32 ``float(acc) *
    (sx[b] * sw) + bias`` (``raw``: int32 ``acc``). ``packed``: ``pack_weight
    (wq)``, made once by the caller; packed here where it is not given.
    The wgmma path takes its halo form where ``halo_fits``."""
    if xq.ndim != 4 or wq.ndim != 4 or tuple(wq.shape[:2]) != (3, 3) or wq.shape[2] != xq.shape[3]:
        raise ValueError(f"expected NHWC x and a 3x3 HWIO kernel of its channels, got {tuple(xq.shape)}, "
                         f"{tuple(wq.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if xq.device.type == "cpu":
        return int8_conv_plain(xq, wq, sx, sw, bias, stride, pads, raw=raw)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv runs on cuda or cpu tensors, got {xq.device}")
    xq, wq, sx, sw, bias = _check_cuda("int8_conv", xq, wq, sx, sw, bias, raw)
    wp = _packed("int8_conv", wq, packed)
    B, H, W, cin = xq.shape
    cout = wq.shape[-1]
    ho, wo = conv_out_hw(H, W, stride, pads)
    if ho < 1 or wo < 1:
        raise ValueError(f"no output for a {H}x{W} input with pads {pads} at stride {stride}")
    halo = wp is not None and halo_fits(B, H, W, cin, cout, stride, pads, wp.shape[-1])
    out = torch.empty((B, ho, wo, cout), device=xq.device, dtype=torch.int32 if raw else torch.float32)
    with torch.cuda.device(xq.device):
        _launch("int8_conv", _lib().int8_conv_launch,
                xq.data_ptr(), int(xq.dtype == torch.float32), wq.data_ptr(), _ptr(wp),
                0 if wp is None else wp.shape[-1], 0 if wp is None else wp.shape[1], int(halo),
                _ptr(sx), int(sx is not None and sx.numel() > 1), _ptr(sw), _ptr(bias),
                None if raw else out.data_ptr(), out.data_ptr() if raw else None,
                B, H, W, cin, cout, ho, wo, stride, pads[0][0], pads[1][0],
                torch.cuda.current_stream(xq.device).cuda_stream)
    int8_conv.launches += 1
    return out


# split-K arrival counters of the dense, one a (device, stream): zero between
# launches (the last block of each tile sets its counter back), so one
# zeroed array serves every launch on its stream
_COUNTERS: dict = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        c = _COUNTERS[key] = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
    return c


def int8_dense(xq, wq, sx, sw, bias, *, raw: bool = False, packed=None) -> torch.Tensor:
    """[M, K] x — int8 codes, or f32 quantized by ``sx`` on load — times
    [K, N] int8 -> [M, N] f32 ``float(acc) * (sx[m] * sw) + bias`` (``raw``:
    int32 ``acc``). ``packed``: ``pack_weight(wq)``, as for ``int8_conv``.
    On the wgmma path K is split over ``dense_splits`` blocks; their int32
    partials meet in a workspace allocated here."""
    if xq.ndim != 2 or wq.ndim != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"expected [M, K] x [K, N], got {tuple(xq.shape)}, {tuple(wq.shape)}")
    if xq.device.type == "cpu":
        return int8_dense_plain(xq, wq, sx, sw, bias, raw=raw)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_dense runs on cuda or cpu tensors, got {xq.device}")
    xq, wq, sx, sw, bias = _check_cuda("int8_dense", xq, wq, sx, sw, bias, raw)
    wp = _packed("int8_dense", wq, packed)
    M, K = xq.shape
    N = wq.shape[1]
    out = torch.empty((M, N), device=xq.device, dtype=torch.int32 if raw else torch.float32)
    bn = bk = n_stages = 0
    splits, ws, counters = 1, None, None
    if wp is not None:
        n_tiles, n_stages, bn, bk = wp.shape
        m_tiles = -(-M // 128)
        sms = torch.cuda.get_device_properties(xq.device).multi_processor_count
        splits = dense_splits(m_tiles, n_tiles, n_stages, sms)
        if splits > 1:
            ws = torch.empty((splits, M, N), device=xq.device, dtype=torch.int32)
            counters = _counters(xq.device, m_tiles * n_tiles)
    with torch.cuda.device(xq.device):
        _launch("int8_dense", _lib().int8_dense_launch,
                xq.data_ptr(), int(xq.dtype == torch.float32), wq.data_ptr(), _ptr(wp), bk, n_stages, bn,
                splits, _ptr(ws), _ptr(counters),
                _ptr(sx), int(sx is not None and sx.numel() > 1), _ptr(sw), _ptr(bias),
                None if raw else out.data_ptr(), out.data_ptr() if raw else None, M, K, N,
                torch.cuda.current_stream(xq.device).cuda_stream)
    int8_dense.launches += 1
    return out


# a wrapper adds one where it launches its kernel, nowhere else
int8_conv.launches = 0
int8_dense.launches = 0


def launches() -> dict:
    return {"int8_conv": int8_conv.launches, "int8_dense": int8_dense.launches}


def reset_launches() -> None:
    int8_conv.launches = 0
    int8_dense.launches = 0
