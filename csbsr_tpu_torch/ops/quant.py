"""int8 serving convolutions (`csbsr_tpu/ops/quant.py`), NCHW.

The quantizers are the JAX package's:

  - weights: per output channel, symmetric, scale max|W| / 127 (1 / 127
    for an all-zero channel), computed from the float32 params at each call;
  - activations: per tensor, symmetric, from a calibrated abs-max (static)
    or from the tensor's own abs-max (dynamic, one more reduction). The
    division and the round run in the activation's dtype (bf16 on the
    serving path), half to even, as `jnp.round` does.

The product is int8 x int8 -> int32, then a float32 dequant
`acc * (x_scale * w_scale)` cast to the activation's dtype. The JAX package
gets the integer convolution from XLA, outside any Pallas kernel; here it is
`torch._int_mm` (cuBLASLt's int8 GEMM with int32 accumulation) over an
int8 im2col:

  - conv: the padded int8 input unfolded by strided views and copied once
    into an (N*Ho*Wo, C*kh*kw) matrix, times the (O, C*kh*kw) weight
    transposed (cuBLASLt's int8 "TN" layout); K, N and M padded with zeros
    (exact) to the shapes the CUDA GEMM takes (`_mm`); a
    grouped conv runs block-diagonal products of up to GROUP_CHUNK groups;
  - transposed conv with k = m*s: an ordinary conv over the input padded by
    m-1 with the s*s sub-pixel phases of the kernel as output channels
    (m x m taps each), then depth-to-space and a crop of p on each side.
    Every output is the same integer sum, so the int32 result is exact.

Beside it, the plain version (`route="plain"`): the same integer
convolution as a float64 `F.conv2d` / `F.conv_transpose2d` of the int8
values, exact while every sum stays below 2^53 (|q| <= 127, so a sum of
fewer than 5e11 products). The CPU takes it by default; on CUDA the default
is the `_int_mm` route, which launches its int8 product or raises (no
float fallback). `PRODUCTS` counts the `_int_mm` calls by route name, as
`cuda_build.LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import collections
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

__all__ = ["quantize_weight", "quantize_act", "conv_acc", "conv_transpose_acc", "int8_conv",
           "int8_conv_transpose", "dequant", "PRODUCTS", "GROUP_CHUNK"]

IntPair = Union[int, Sequence[int]]
PRODUCTS: collections.Counter = collections.Counter()
GROUP_CHUNK = 16  # groups per block-diagonal product of a grouped conv


def _pair(v: IntPair) -> Tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127, 1 / 127 where amax is 0, in float32 and correctly rounded
    on every device: CUDA computes a tensor divided by a Python number as a
    product with its reciprocal, one ulp off the quotient for some amax, and
    a scale one ulp off moves int8 levels and outputs from the CPU's and the
    JAX package's. The divisor is a tensor on amax's device instead."""
    amax = amax.float()
    return torch.where(amax > 0, amax, torch.ones_like(amax)) / torch.full_like(amax, 127.0)


def quantize_weight(weight: torch.Tensor, out_axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 weight, float32 scale per output channel): symmetric, max|W| / 127."""
    w = weight.detach().float()
    dims = [d for d in range(w.ndim) if d != out_axis]
    scale = _scale(w.abs().amax(dim=dims))
    shape = [1] * w.ndim
    shape[out_axis] = -1
    q = torch.clamp(torch.round(w / scale.reshape(shape)), -127, 127)
    return q.to(torch.int8), scale


def quantize_act(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 x, float32 scalar scale): per tensor, symmetric; `amax` None
    takes the tensor's own abs-max (dynamic). Divides and rounds in x's dtype."""
    if amax is None:
        amax = x.detach().abs().amax().float()
    scale = _scale(amax.to(device=x.device, dtype=torch.float32))
    q = torch.clamp(torch.round(x.detach() / scale.to(x.dtype)), -127, 127)
    return q.to(torch.int8), scale


def _mm(a: torch.Tensor, w: torch.Tensor, name: str) -> torch.Tensor:
    """int8 a (M, K) @ w (N, K)^T -> int32 (M, N) by torch._int_mm, with `a`
    row-major and w^T column-major (cuBLASLt's int8 "TN" layout) and zeros
    padded to its CUDA shape rules (K a multiple of 8; N and M multiples of
    16, M at least 32)."""
    m, k = a.shape
    n = w.shape[0]
    pk, pn, pm = -k % 8, -n % 16, max(32 - m, 0) + (-max(m, 32) % 16)
    a = F.pad(a, (0, pk, 0, pm)) if pk or pm else a.contiguous()
    w = F.pad(w, (0, pk, 0, pn)) if pk or pn else w.contiguous()
    PRODUCTS[name] += 1
    out = torch._int_mm(a, w.t())
    return out[:m, :n] if (pn or pm) else out


def _im2col(xq: torch.Tensor, kernel: Tuple[int, int], stride, padding, dilation):
    """int8 (N, C, H, W) -> ((N*Ho*Wo, C*kh*kw) int8, Ho, Wo), columns in
    (c, i, j) order, the order of a flattened (O, C, kh, kw) weight."""
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel, stride, padding, dilation
    n, c = xq.shape[:2]
    x = F.pad(xq, (pw, pw, ph, ph)) if ph or pw else xq
    x = x.unfold(2, (kh - 1) * dh + 1, sh).unfold(3, (kw - 1) * dw + 1, sw)
    if dh > 1 or dw > 1:
        x = x[..., ::dh, ::dw]
    ho, wo = x.shape[2], x.shape[3]
    return x.permute(0, 2, 3, 1, 4, 5).reshape(n * ho * wo, c * kh * kw), ho, wo


def _conv_acc_int_mm(xq, wq, stride, padding, dilation, groups):
    o, cg, kh, kw = wq.shape
    n = xq.shape[0]
    a, ho, wo = _im2col(xq, (kh, kw), stride, padding, dilation)
    w = wq.reshape(o, cg * kh * kw)
    if groups == 1:
        acc = _mm(a, w, "conv")
    else:
        og, kg = o // groups, cg * kh * kw
        parts = []
        for g0 in range(0, groups, GROUP_CHUNK):
            gs = min(GROUP_CHUNK, groups - g0)
            # block-diagonal weight of gs groups: the zeros add nothing
            bd = torch.zeros((gs * og, gs * kg), dtype=torch.int8, device=wq.device)
            for j in range(gs):
                bd[j * og:(j + 1) * og, j * kg:(j + 1) * kg] = w[(g0 + j) * og:(g0 + j + 1) * og]
            parts.append(_mm(a[:, g0 * kg:(g0 + gs) * kg], bd, "conv_grouped"))
        acc = torch.cat(parts, dim=1)
    return acc.reshape(n, ho, wo, o).permute(0, 3, 1, 2)


def _conv_acc_plain(xq, wq, stride, padding, dilation, groups):
    with torch.backends.cudnn.flags(enabled=False):  # no FFT/Winograd: exact float64
        y = F.conv2d(xq.double(), wq.double(), None, stride, padding, dilation, groups)
    return y.round().to(torch.int32)


def _route(x: torch.Tensor, route: Optional[str]) -> str:
    route = route or ("int_mm" if x.is_cuda else "plain")
    if route not in ("int_mm", "plain"):
        raise ValueError(f"unknown int8 route {route!r}")
    return route


def conv_acc(xq: torch.Tensor, wq: torch.Tensor, stride: IntPair = 1, padding: IntPair = 0,
             dilation: IntPair = 1, groups: int = 1, route: Optional[str] = None) -> torch.Tensor:
    """int32 accumulators of conv2d(xq, wq): xq (N, C, H, W) and wq
    (O, C/groups, kh, kw) int8."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"conv_acc takes int8 operands, got {xq.dtype} and {wq.dtype}")
    args = (_pair(stride), _pair(padding), _pair(dilation), int(groups))
    if _route(xq, route) == "plain":
        return _conv_acc_plain(xq, wq, *args)
    return _conv_acc_int_mm(xq, wq, *args)


def _phase_weight(wq: torch.Tensor, s: int) -> torch.Tensor:
    """(Cin, Cout, k, k) transposed-conv weight, k = m*s -> the (s*s*Cout, Cin,
    m, m) weight of the ordinary conv whose output channel (ry, rx, o) is
    sub-pixel phase (ry, rx): tap (u, v) takes w[:, o, ry + s(m-1-u), rx + s(m-1-v)]."""
    cin, cout, k, _ = wq.shape
    m = k // s
    w = wq.reshape(cin, cout, m, s, m, s).flip(2, 4)  # (cin, o, u, ry, v, rx)
    return w.permute(3, 5, 1, 0, 2, 4).reshape(s * s * cout, cin, m, m)


def conv_transpose_acc(xq: torch.Tensor, wq: torch.Tensor, stride: IntPair, padding: IntPair,
                       route: Optional[str] = None) -> torch.Tensor:
    """int32 accumulators of conv_transpose2d(xq, wq, stride, padding): xq
    (N, Cin, H, W), wq (Cin, Cout, k, k) int8, square kernel and stride."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"conv_transpose_acc takes int8 operands, got {xq.dtype} and {wq.dtype}")
    (s, s2), (p, p2) = _pair(stride), _pair(padding)
    k = wq.shape[-1]
    if _route(xq, route) == "plain":
        with torch.backends.cudnn.flags(enabled=False):
            y = F.conv_transpose2d(xq.double(), wq.double(), None, (s, s2), (p, p2))
        return y.round().to(torch.int32)
    if s != s2 or p != p2 or wq.shape[-2] != k or k % s:
        raise NotImplementedError(f"int8 transposed conv needs a square kernel that is a "
                                  f"multiple of its stride (k {tuple(wq.shape[-2:])}, "
                                  f"stride {(s, s2)}, padding {(p, p2)})")
    m, cout = k // s, wq.shape[1]
    y = _conv_acc_int_mm(xq, _phase_weight(wq, s), (1, 1), (m - 1, m - 1), (1, 1), 1)
    n, _, hq, wqq = y.shape
    y = y.reshape(n, s, s, cout, hq, wqq).permute(0, 3, 4, 1, 5, 2)  # depth to space
    y = y.reshape(n, cout, hq * s, wqq * s)
    return y[:, :, p:hq * s - p, p:wqq * s - p]


def dequant(acc: torch.Tensor, x_scale: torch.Tensor, w_scale: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """acc * (x_scale * w_scale[channel]) in float32, cast to `dtype`."""
    return (acc.float() * (x_scale * w_scale)[None, :, None, None]).to(dtype)


def int8_conv(x: torch.Tensor, weight: torch.Tensor, stride: IntPair = 1, padding: IntPair = 0,
              dilation: IntPair = 1, groups: int = 1, act_amax: Optional[torch.Tensor] = None,
              route: Optional[str] = None, qweight=None) -> torch.Tensor:
    """Quantized conv2d (no bias), NCHW / OIHW; the result in x's dtype.
    `qweight` is quantize_weight(weight, 0) when the caller keeps it."""
    xq, xs = quantize_act(x, act_amax)
    wq, ws = qweight or quantize_weight(weight, out_axis=0)
    return dequant(conv_acc(xq, wq, stride, padding, dilation, groups, route), xs, ws, x.dtype)


def int8_conv_transpose(x: torch.Tensor, weight: torch.Tensor, stride: IntPair,
                        padding: IntPair, act_amax: Optional[torch.Tensor] = None,
                        route: Optional[str] = None, qweight=None) -> torch.Tensor:
    """Quantized conv_transpose2d (no bias), weight (Cin, Cout, k, k); the
    result in x's dtype. `qweight` is quantize_weight(weight, 1) when kept."""
    xq, xs = quantize_act(x, act_amax)
    wq, ws = qweight or quantize_weight(weight, out_axis=1)
    return dequant(conv_transpose_acc(xq, wq, stride, padding, route), xs, ws, x.dtype)
