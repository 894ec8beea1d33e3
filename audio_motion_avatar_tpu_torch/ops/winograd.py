"""Winograd F(2x2, 3x3) convolution: kernels K9a and K9b.

`winograd_conv3x3` computes a 3x3, stride-1 convolution ('SAME' or 'VALID')
by F(2x2, 3x3): each 2x2 output tile is A^T [(G w G^T) . (B^T d B)] A of its
4x4 input window d, the 16 elementwise products summed over the input
channels as 16 (tiles, C) x (C, K) products. `winograd_conv3x3_gn_relu`
computes conv3x3(relu(a * x + c)), a per-image channel affine (a GroupNorm
folded by `gn_affine`) and the relu fused into the window assembly; under
SAME the padded border is zero after the affine, since relu(c) != 0.

On CUDA tensors they launch csrc/winograd.cu (bf16 operands); on CPU
tensors they run their plain versions, which repeat the JAX package's
kernel roundings (its ops/winograd.py, `_wino_core` and `_wino_gn_kernel`):
U = G w G^T in fp32, rounded to the compute dtype; the input transform in
the compute dtype, rounded twice (the row combination R, then the column
combination of R); the 16 products accumulated in fp32; A^T M A and the
bias in fp32; one rounding of the output. In the GN variant relu(a x + c)
is taken in fp32 and rounded to the compute dtype.

Layouts are the JAX package's: x (N, H, W, C), w (3, 3, C, K) HWIO, b (K,),
a / c (N, C). Under autograd `WinogradConv3x3` and `WinogradConv3x3GnRelu`
run the kernel (or plain version) forward and the VJP of the direct twins
(`conv3x3_direct`, `conv3x3_gn_relu_direct`) backward, as the JAX
package's custom_vjp does; `conv3x3` picks Winograd or the direct twin by
shape (`supports_winograd`), as the JAX package's `_WinoConv` does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..device import fp32_geometry

# F(2x2, 3x3) transform matrices (Lavin & Gray 2015)
_BT = np.array([[1, 0, -1, 0],
                [0, 1, 1, 0],
                [0, -1, 1, 0],
                [0, 1, 0, -1]], np.float32)
_G = np.array([[1, 0, 0],
               [0.5, 0.5, 0.5],
               [0.5, -0.5, 0.5],
               [0, 0, 1]], np.float32)
_AT = np.array([[1, 1, 1, 0],
                [0, 1, -1, -1]], np.float32)

# (row, sign) pairs of the two nonzeros in each B^T row: every transform
# position is a signed sum of two taps
_BT_TAPS = ((0, 1.0, 2, -1.0),
            (1, 1.0, 2, 1.0),
            (1, -1.0, 2, 1.0),
            (1, 1.0, 3, -1.0))


def excess_error(out: torch.Tensor, ref: torch.Tensor, direct: torch.Tensor):
    """How far a bf16 output `out` of K9a / K9b is from its plain version's
    `ref` on the same inputs, with `direct` the direct conv on them: (the
    worst ratio of |out - ref| to 2^-7 |ref| + 2^-8 RMS(ref): a bf16 spacing
    of the value, and of the output's scale where the Winograd sums cancel;
    the mean |out - ref| over 1e-2 of the mean |ref - direct|, the rounding
    the algorithm itself adds). Both 1 or less agree: a kernel within
    rounding of its plain version, not one that rounds as the algorithm
    does in another place."""
    out, ref, direct = out.float(), ref.float(), direct.float()
    diff = (out - ref).abs()
    rms = float(ref.pow(2).mean().sqrt())
    tol = 2.0 ** -7 * ref.abs() + 2.0 ** -8 * rms + torch.finfo(torch.float32).tiny
    return (float((diff / tol).max()),
            float(diff.mean()) / (1e-2 * float((ref - direct).abs().mean())))


def supports_winograd(x_shape, C: int, K: int, padding: str) -> bool:
    """The shapes the Winograd kernels take: C and K multiples of 128, even
    H and W of at least 4."""
    H, W = x_shape[1], x_shape[2]
    if C % 128 or K % 128:
        return False
    return H % 2 == 0 and W % 2 == 0 and H >= 4 and W >= 4


def transform_kernel(w: torch.Tensor) -> torch.Tensor:
    """w (3, 3, C, K) -> U (16, C, K) = G w G^T per (C, K), fp32."""
    g = torch.as_tensor(_G, device=w.device)
    u = torch.einsum("pa,abck->pbck", g, w.float())
    u = torch.einsum("qb,pbck->pqck", g, u)
    return u.reshape(16, w.shape[2], w.shape[3])


def kernel_u(w: torch.Tensor) -> torch.Tensor:
    """U as csrc/winograd.cu takes it: transform_kernel(w) rounded to bf16
    once, contiguous (16, C, K), so that TMA reads (C, K) boxes of each of
    the 16 products with K innermost."""
    return transform_kernel(w).to(torch.bfloat16).contiguous()


def gn_affine(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              groups: int, eps: float = 1e-6):
    """GroupNorm statistics of x (N, H, W, C) folded into a per-image channel
    affine: (a, c) (N, C) fp32 with relu(a x + c) == relu(GN(x)). One fp32
    pass: var = E[x^2] - E[x]^2, clamped at 0."""
    N, H, W, C = x.shape
    Cg = C // groups
    g = x.float().reshape(N, H * W, groups, Cg)
    m = g.mean(dim=(1, 3))                                        # (N, groups)
    var = torch.clamp((g * g).mean(dim=(1, 3)) - m * m, min=0.0)
    inv = torch.rsqrt(var + eps)
    sg = scale.float().reshape(groups, Cg)
    bg = bias.float().reshape(groups, Cg)
    a = (inv[:, :, None] * sg[None]).reshape(N, C)
    c = (bg[None] - (m * inv)[:, :, None] * sg[None]).reshape(N, C)
    return a, c


def _tiles(x_shape, w_shape, padding: str):
    """(Hh, Wh) 2x2 output tiles of a conv3x3 of x (N, H, W, C) by w (3, 3,
    C, K); raises on shapes the Winograd kernels do not take."""
    N, H, W, C = x_shape
    if tuple(w_shape[:3]) != (3, 3, C):
        raise ValueError(f"winograd: w {tuple(w_shape)} is not (3, 3, {C}, K)")
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"winograd: padding {padding!r}")
    if not supports_winograd(x_shape, C, w_shape[3], padding):
        raise ValueError(f"winograd: x {tuple(x_shape)} -> {w_shape[3]} channels needs "
                         "C, K multiples of 128 and even H, W >= 4")
    if padding == "SAME":
        return H // 2, W // 2
    return (H - 2) // 2, (W - 2) // 2


def _pad(x: torch.Tensor, padding: str) -> torch.Tensor:
    return F.pad(x, (0, 0, 1, 1, 1, 1)) if padding == "SAME" else x


def _signed_pair(a, ga, b, gb):
    """ga * a + gb * b for signs +-1, one rounding in the operands' dtype
    (every row of B^T with a negative first sign has a positive second)."""
    if ga > 0:
        return a + b if gb > 0 else a - b
    return b - a


def _wino_plain(xp: torch.Tensor, u: torch.Tensor, bias: torch.Tensor,
                Hh: int, Wh: int) -> torch.Tensor:
    """The transform / product / inverse core on the padded input xp (N,
    2 Hh + 2, 2 Wh + 2, C), U (16, C, K) and the bias (K,) fp32 -> (N, 2 Hh,
    2 Wh, K) in xp's dtype. The input transform runs in xp's dtype, and the
    products take it in U's (the JAX kernel's `.astype(mm_dtype)`): both are
    the compute dtype on the kernels' path."""
    N, C, K = xp.shape[0], xp.shape[-1], u.shape[-1]

    def d(r, s):     # input tap (r, s) of every tile
        return xp[:, r:r + 2 * Hh:2, s:s + 2 * Wh:2].reshape(-1, C)

    y = [[None, None], [None, None]]
    for p in range(4):
        r0, g0, r1, g1 = _BT_TAPS[p]
        R = [_signed_pair(d(r0, s), g0, d(r1, s), g1) for s in range(4)]
        for q in range(4):
            s0, h0, s1, h1 = _BT_TAPS[q]
            v = _signed_pair(R[s0], h0, R[s1], h1)
            m = v.to(u.dtype).float() @ u[4 * p + q].float()
            for i in range(2):
                for j in range(2):
                    sign = _AT[i, p] * _AT[j, q]
                    if sign == 0.0:
                        continue
                    t = m if sign > 0 else -m
                    y[i][j] = t if y[i][j] is None else y[i][j] + t
    out = torch.empty(N, Hh, 2, Wh, 2, K, dtype=xp.dtype, device=xp.device)
    for i in range(2):
        for j in range(2):
            out[:, :, i, :, j] = (y[i][j] + bias).reshape(N, Hh, Wh, K).to(xp.dtype)
    return out.reshape(N, 2 * Hh, 2 * Wh, K)


def winograd_conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           padding: str = "SAME") -> torch.Tensor:
    """Plain version of kernel K9a: x (N, H, W, C), w (3, 3, C, K) and b (K,)
    in the compute dtype -> (N, H', W', K) in it."""
    Hh, Wh = _tiles(x.shape, w.shape, padding)
    u = transform_kernel(w).to(x.dtype)
    return _wino_plain(_pad(x, padding), u, b.float(), Hh, Wh)


def _affine_relu(x, a, c):
    """relu(a x + c) in fp32, per image and channel."""
    return torch.relu(x.float() * a.float()[:, None, None, :] + c.float()[:, None, None, :])


def winograd_conv3x3_gn_relu_plain(x: torch.Tensor, w: torch.Tensor,
                                   b: torch.Tensor, a: torch.Tensor,
                                   c: torch.Tensor,
                                   padding: str = "SAME") -> torch.Tensor:
    """Plain version of kernel K9b: conv3x3(relu(a x + c)), the affine and
    relu in fp32, rounded to the compute dtype, the border padded after."""
    Hh, Wh = _tiles(x.shape, w.shape, padding)
    u = transform_kernel(w).to(x.dtype)
    xn = _affine_relu(x, a, c).to(x.dtype)
    return _wino_plain(_pad(xn, padding), u, b.float(), Hh, Wh)


def conv3x3_direct(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   padding: str = "SAME") -> torch.Tensor:
    """The direct twin (the JAX package's conv3x3_xla): the conv with fp32
    accumulation, the bias added in fp32, cast to x's dtype."""
    with fp32_geometry():
        y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                     padding=1 if padding == "SAME" else 0)
    return (y.permute(0, 2, 3, 1) + b.float()).to(x.dtype)


def conv3x3_gn_relu_direct(x, w, b, a, c, padding="SAME"):
    """The unfused twin of K9b: relu(a x + c) in fp32, cast to x's dtype,
    then the direct conv (its SAME padding zeroes the normalised border)."""
    return conv3x3_direct(_affine_relu(x, a, c).to(x.dtype), w, b, padding)


def _launch(x, w, b, a, c, padding, name):
    """One launch of csrc/winograd.cu (a / c None: K9a, else K9b)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    Hh, Wh = _tiles(x.shape, w.shape, padding)
    N, H, W, C = x.shape
    K = w.shape[-1]
    for arg, t in (("x", x), ("w", w), ("b", b)):
        if t.dtype != torch.bfloat16 or t.device != x.device:
            raise ValueError(f"{name}: {arg} must be bf16 on {x.device} (the kernel "
                             f"takes bf16 operands), got {t.dtype} on {t.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous (N, H, W, C)")
    if a is not None:
        for arg, t in (("a", a), ("c", c)):
            if t.dtype != torch.float32 or t.shape != (N, C) or \
                    not t.is_contiguous() or t.device != x.device:
                raise ValueError(f"{name}: {arg} must be contiguous float32 "
                                 f"({N}, {C}) on {x.device}")
    u = kernel_u(w)
    bias = b.float().contiguous()
    out = torch.empty(N, 2 * Hh, 2 * Wh, K, dtype=torch.bfloat16, device=x.device)
    rc = kernels.library("winograd").winograd_launch(
        x.data_ptr(), u.data_ptr(), bias.data_ptr(),
        None if a is None else a.data_ptr(), None if c is None else c.data_ptr(),
        out.data_ptr(), N, H, W, C, K, int(padding == "SAME"),
        kernels.stream_ptr(x.device))
    kernels.check(rc, name)
    return out


def winograd_conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     padding: str = "SAME") -> torch.Tensor:
    """Kernel K9a on CUDA tensors (bf16, x contiguous), its plain version on
    CPU tensors."""
    if x.device.type == "cpu":
        return winograd_conv3x3_plain(x, w, b, padding)
    out = _launch(x, w, b, None, None, padding, "winograd_conv3x3")
    winograd_conv3x3.launches += 1
    return out


winograd_conv3x3.launches = 0


def winograd_conv3x3_gn_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                             a: torch.Tensor, c: torch.Tensor,
                             padding: str = "SAME") -> torch.Tensor:
    """Kernel K9b on CUDA tensors (bf16 x / w / b, fp32 a / c, contiguous),
    its plain version on CPU tensors."""
    if x.device.type == "cpu":
        return winograd_conv3x3_gn_relu_plain(x, w, b, a, c, padding)
    out = _launch(x, w, b, a, c, padding, "winograd_conv3x3_gn_relu")
    winograd_conv3x3_gn_relu.launches += 1
    return out


winograd_conv3x3_gn_relu.launches = 0


def _conv_vjp(x, w, padding, g):
    """(dx, dw, db) of conv3x3_direct at (x, w) against the output gradient
    g, the conv's transposes in the operands' dtype."""
    pad = 1 if padding == "SAME" else 0
    xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    gn = g.to(x.dtype).permute(0, 3, 1, 2)
    dx = torch.nn.grad.conv2d_input(xn.shape, wn, gn, padding=pad)
    dw = torch.nn.grad.conv2d_weight(xn, wn.shape, gn, padding=pad)
    db = g.float().sum(dim=(0, 1, 2))
    return dx.permute(0, 2, 3, 1), dw.permute(2, 3, 1, 0), db


class WinogradConv3x3(torch.autograd.Function):
    """K9a forward, the direct twin's VJP backward."""

    @staticmethod
    def forward(ctx, x, w, b, padding):
        ctx.padding = padding
        ctx.save_for_backward(x, w, b)
        return winograd_conv3x3(x, w, b, padding)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        dx, dw, db = _conv_vjp(x, w, ctx.padding, g)
        return dx.to(x.dtype), dw.to(w.dtype), db.to(b.dtype), None


class WinogradConv3x3GnRelu(torch.autograd.Function):
    """K9b forward, conv3x3_gn_relu_direct's VJP backward."""

    @staticmethod
    def forward(ctx, x, w, b, a, c, padding):
        ctx.padding = padding
        ctx.save_for_backward(x, w, b, a, c)
        return winograd_conv3x3_gn_relu(x, w, b, a, c, padding)

    @staticmethod
    def backward(ctx, g):
        """z = a x + c, h = relu(z); dz = dh [z > 0], dx = a dz, da = sum dz x,
        dc = sum dz. Works in place on fp32 copies it owns and frees each
        full-size temporary once it is spent (the relu mask is a boolean):
        the values are those of the unfused formula, operation for
        operation."""
        x, w, b, a, c = ctx.saved_tensors
        af = a.float()[:, None, None, :]
        z = x.to(torch.float32, copy=True).mul_(af).add_(c.float()[:, None, None, :])
        keep = z > 0
        h = z.relu_().to(x.dtype)
        del z
        dh, dw, db = _conv_vjp(h, w, ctx.padding, g)
        del h
        dz = dh.to(torch.float32, copy=True).mul_(keep)
        del dh, keep
        dc = dz.sum(dim=(1, 2))
        # dz x in dz's layout (the conv's), so that the sum runs in the
        # formula's order; x promoted element by element, not copied
        dzx = torch.mul(dz, x, out=torch.empty_like(dz))
        da = dzx.sum(dim=(1, 2))
        del dzx
        dx = dz.mul_(af)
        return (dx.to(x.dtype), dw.to(w.dtype), db.to(b.dtype), da.to(a.dtype),
                dc.to(c.dtype), None)


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, padding: str,
            gn=None) -> torch.Tensor:
    """The JAX package's `_WinoConv`: conv3x3 (x, w, b in the compute dtype;
    gn = (a, c) for conv3x3(relu(a x + c))) through the Winograd kernels
    where `supports_winograd` takes the shape, the direct twins elsewhere."""
    if not supports_winograd(x.shape, x.shape[-1], w.shape[-1], padding):
        if gn is None:
            return conv3x3_direct(x, w, b, padding)
        return conv3x3_gn_relu_direct(x, w, b, *gn, padding)
    x = x.contiguous()
    if gn is None:
        return WinogradConv3x3.apply(x, w, b, padding)
    a, c = (t.contiguous() for t in gn)
    return WinogradConv3x3GnRelu.apply(x, w, b, a, c, padding)
