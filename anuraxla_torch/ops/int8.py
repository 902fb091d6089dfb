"""Int8 contractions of the quantized serving encoder — the port of the int8
conv and dot of ``anuraxla/models/quant.py`` (``_int8_conv`` :204,
``_int8_dot`` :198, which XLA lowers to the TPU's matrix unit; neither is a
Pallas kernel) together with the dequantization that follows each (:245,
:257).

- ``int8_conv``: a 3x3 conv over NHWC int8 input, stride 1 or 2, explicit
  (lo, hi) pads per axis, an HWIO int8 kernel; ``int8_dense``: [M, K] x
  [K, N] int8. Both return ``float(acc) * (sx[b] * sw[n]) + bias[n]`` in f32
  (``raw=True``: the int32 sums ``acc`` themselves). On a CUDA tensor they
  launch the hand-written Hopper kernel of ``csrc/int8_gemm.cu`` (int32 sums
  on the integer tensor cores) or raise; a tensor on the CPU takes the plain
  version. ``int8_conv.launches`` / ``int8_dense.launches`` count the
  kernel's launches.
- ``int8_conv_plain`` / ``int8_dense_plain``: the same function in plain
  PyTorch — ``patches`` (the reference's ``_patches``) and a float64 product,
  exact for these integer sums, cast to int32, then the same epilogue one
  rounding at a time. The kernel equals them bit for bit.

``sx`` is one activation scale (calibrated) or one a row (dynamic: [B] or
[B, 1, 1, 1]); ``sw`` and ``bias`` are per output channel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

PLAIN_CHUNK = 1 << 25  # float64 elements of a patch block in the plain version (256 MB)


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
    """The plain version of ``int8_conv``."""
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
    """The plain version of ``int8_dense``."""
    acc = _int_product(xq, wq)
    if raw:
        return acc
    return dequantize(acc, _row_scales(sx, xq.shape[0]), sw, bias)


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel library, built at first use, with its C signatures bound."""
    from anuraxla_torch.ops import _build

    lib = _build.load("int8_gemm")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    # x, w, sx, sx_stride, sw, bias, out, out_i32, B, H, W, Cin, Cout, Ho, Wo, stride, pad_t, pad_l, stream
    lib.int8_conv_launch.argtypes = [vp, vp, vp, i32, vp, vp, vp, vp, *[i32] * 10, vp]
    lib.int8_conv_launch.restype = i32
    # x, w, sx, sx_stride, sw, bias, out, out_i32, M, K, N, stream
    lib.int8_dense_launch.argtypes = [vp, vp, vp, i32, vp, vp, vp, vp, i32, i32, i32, vp]
    lib.int8_dense_launch.restype = i32
    return lib


def _check_cuda(name: str, xq, wq, sx, sw, bias, raw: bool):
    """The kernel's operands, checked: int8 contiguous x and w, f32 scales and
    bias on x's card (not needed with ``raw``)."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"{name} needs int8 x and w, got {xq.dtype} and {wq.dtype}")
    if wq.device != xq.device:
        raise ValueError(f"{name}: w is on {wq.device}, x on {xq.device}")
    xq, wq = xq.contiguous(), wq.contiguous()
    if raw:
        return xq, wq, None, None, None
    sx = _row_scales(sx, xq.shape[0]).contiguous()
    sw, bias = sw.to(torch.float32).contiguous(), bias.to(torch.float32).contiguous()
    for t, what in ((sx, "sx"), (sw, "sw"), (bias, "bias")):
        if t.device != xq.device:
            raise ValueError(f"{name}: {what} is on {t.device}, x on {xq.device}")
    if sw.numel() != wq.shape[-1] or bias.numel() != wq.shape[-1]:
        raise ValueError(f"{name}: sw and bias need {wq.shape[-1]} values, got {sw.numel()} and {bias.numel()}")
    return xq, wq, sx, sw, bias


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def int8_conv(xq, wq, sx, sw, bias, stride: int, pads, *, raw: bool = False) -> torch.Tensor:
    """[B, H, W, Cin] int8 (NHWC) * [3, 3, Cin, Cout] int8 (HWIO), stride 1 or
    2, pads ((top, bottom), (left, right)) -> [B, Ho, Wo, Cout] f32
    ``float(acc) * (sx[b] * sw) + bias`` (``raw``: int32 ``acc``)."""
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
    B, H, W, cin = xq.shape
    cout = wq.shape[-1]
    ho, wo = conv_out_hw(H, W, stride, pads)
    if ho < 1 or wo < 1:
        raise ValueError(f"no output for a {H}x{W} input with pads {pads} at stride {stride}")
    out = torch.empty((B, ho, wo, cout), device=xq.device, dtype=torch.int32 if raw else torch.float32)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    with torch.cuda.device(xq.device):
        _launch("int8_conv", _lib().int8_conv_launch,
                xq.data_ptr(), wq.data_ptr(), ptr(sx), int(not raw and sx.numel() > 1), ptr(sw), ptr(bias),
                None if raw else out.data_ptr(), out.data_ptr() if raw else None,
                B, H, W, cin, cout, ho, wo, stride, pads[0][0], pads[1][0],
                torch.cuda.current_stream(xq.device).cuda_stream)
    int8_conv.launches += 1
    return out


def int8_dense(xq, wq, sx, sw, bias, *, raw: bool = False) -> torch.Tensor:
    """[M, K] int8 x [K, N] int8 -> [M, N] f32 ``float(acc) * (sx[m] * sw) +
    bias`` (``raw``: int32 ``acc``)."""
    if xq.ndim != 2 or wq.ndim != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"expected [M, K] x [K, N], got {tuple(xq.shape)}, {tuple(wq.shape)}")
    if xq.device.type == "cpu":
        return int8_dense_plain(xq, wq, sx, sw, bias, raw=raw)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_dense runs on cuda or cpu tensors, got {xq.device}")
    xq, wq, sx, sw, bias = _check_cuda("int8_dense", xq, wq, sx, sw, bias, raw)
    M, K = xq.shape
    N = wq.shape[1]
    out = torch.empty((M, N), device=xq.device, dtype=torch.int32 if raw else torch.float32)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    with torch.cuda.device(xq.device):
        _launch("int8_dense", _lib().int8_dense_launch,
                xq.data_ptr(), wq.data_ptr(), ptr(sx), int(not raw and sx.numel() > 1), ptr(sw), ptr(bias),
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
