"""The port's Winograd convolutions (kernels K9a, K9b: ops/winograd.py)
against the JAX package's Pallas kernels, run in interpret mode on the CPU
as tests/test_winograd.py runs them.

- Plain versions vs the JAX kernels on tests/test_winograd.py's four
  shapes: fp32 max |diff| <= 1e-5 (they repeat the kernels' arithmetic);
  bf16 under the rule every |diff| <= 2^-7 |ref| + 2^-8 RMS(ref), with a
  mean |diff| at most 1e-2 of the distance between the JAX bf16 Winograd
  and the bf16 direct conv (ops/winograd.excess_error). The rule must
  reject a version whose input transform rounds once, not twice.
- The autograd Functions' gradients against jax.grad of the JAX functions
  (custom_vjp over the direct conv) at 1e-3.
The upsampler and the serving rollout with Winograd convs are held in
tests/test_torch_winograd_paths.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_motion_avatar_tpu.ops import winograd as JW

import chip_smoke
from audio_motion_avatar_tpu_torch.ops import winograd as W
from torch_parity import one_torch_thread, t  # noqa: F401

SHAPES = [("SAME", (2, 16, 16, 128)), ("SAME", (1, 32, 8, 128)),
          ("VALID", (3, 18, 18, 128)), ("VALID", (2, 10, 18, 128))]


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(3, 3, shape[-1], 128) * 0.1).astype(np.float32)
    b = rng.randn(128).astype(np.float32)
    a = (rng.randn(shape[0], shape[-1]) * 0.3 + 1.0).astype(np.float32)
    c = (rng.randn(shape[0], shape[-1]) * 0.3).astype(np.float32)
    return x, w, b, a, c


def _jax(kernel, dtype, x, w, b, a, c, padding):
    """JAX's Pallas kernel (interpret mode) and its direct twin, as fp32
    numpy, on the operands rounded to `dtype` (a, c stay fp32)."""
    jx, jw, jb = (jnp.asarray(v).astype(dtype) for v in (x, w, b))
    ja, jc = jnp.asarray(a), jnp.asarray(c)
    if kernel == "K9a":
        out = JW._winograd_fwd_impl(jx, jw, jb, padding, interpret=True)
        direct = JW.conv3x3_xla(jx, jw, jb, padding)
    else:
        out = JW._winograd_gn_fwd_impl(jx, jw, jb, ja, jc, padding, interpret=True)
        direct = JW.conv3x3_gn_relu_xla(jx, jw, jb, ja, jc, padding)
    return np.asarray(out, np.float32), np.asarray(direct, np.float32)


def _port(kernel, dtype, x, w, b, a, c, padding):
    tx, tw, tb = (t(v).to(dtype) for v in (x, w, b))
    if kernel == "K9a":
        return W.winograd_conv3x3(tx, tw, tb, padding)
    return W.winograd_conv3x3_gn_relu(tx, tw, tb, t(a), t(c), padding)


@pytest.mark.parametrize("kernel", ["K9a", "K9b"])
@pytest.mark.parametrize("padding,shape", SHAPES)
def test_plain_matches_jax_kernel_fp32(kernel, padding, shape):
    args = _inputs(shape, 0)
    want, _ = _jax(kernel, jnp.float32, *args, padding)
    got = _port(kernel, torch.float32, *args, padding)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kernel", ["K9a", "K9b"])
@pytest.mark.parametrize("padding,shape", SHAPES)
def test_plain_matches_jax_kernel_bf16(kernel, padding, shape):
    args = _inputs(shape, 1)
    want, direct = _jax(kernel, jnp.bfloat16, *args, padding)
    got = _port(kernel, torch.bfloat16, *args, padding)
    assert got.dtype == torch.bfloat16
    excess, mean = W.excess_error(got, torch.as_tensor(want), torch.as_tensor(direct))
    assert excess <= 1.0 and mean <= 1.0, (excess, mean)


@pytest.mark.parametrize("padding,shape", SHAPES[::2])
def test_bf16_rule_rejects_a_single_rounding_transform(padding, shape):
    """The guard: an input transform rounded once to bf16 (the plain core on
    the fp32 window, the products taking it in U's bf16) fails the rule."""
    x, w, b, a, c = _inputs(shape, 1)
    want, direct = _jax("K9a", jnp.bfloat16, x, w, b, a, c, padding)
    tx, tw, tb = (t(v).to(torch.bfloat16) for v in (x, w, b))
    wrong = chip_smoke.winograd_single_rounding(tx, tw, tb, padding)
    excess, mean = W.excess_error(wrong, torch.as_tensor(want), torch.as_tensor(direct))
    assert excess > 1.0 or mean > 1.0, (excess, mean)


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_function_gradients_match_jax(padding):
    """WinogradConv3x3 / WinogradConv3x3GnRelu backward: the VJP of the
    direct twins, as the JAX custom_vjp; gradients of sum(y^2) at 1e-3."""
    x, w, b, a, c = _inputs((2, 8, 8, 128), 2)
    jargs = [jnp.asarray(v) for v in (x, w, b, a, c)]

    def loss_a(x_, w_, b_):
        return jnp.sum(JW.winograd_conv3x3(x_, w_, b_, padding) ** 2)

    def loss_b(x_, w_, b_, a_, c_):
        return jnp.sum(JW.winograd_conv3x3_gn_relu(x_, w_, b_, a_, c_, padding) ** 2)

    want = (jax.grad(loss_a, argnums=(0, 1, 2))(*jargs[:3]),
            jax.grad(loss_b, argnums=(0, 1, 2, 3, 4))(*jargs))
    targs = [t(v).requires_grad_(True) for v in (x, w, b, a, c)]
    (W.WinogradConv3x3.apply(*targs[:3], padding) ** 2).sum().backward()
    got_a = [v.grad.clone() for v in targs[:3]]
    for v in targs:
        v.grad = None
    (W.WinogradConv3x3GnRelu.apply(*targs, padding) ** 2).sum().backward()
    got_b = [v.grad for v in targs]
    for got, ref in zip((got_a, got_b), want):
        for name, gv, rv in zip("xwbac", got, ref):
            rv = np.asarray(rv)
            np.testing.assert_allclose(gv.numpy(), rv, rtol=1e-3,
                                       atol=1e-3 * float(np.abs(rv).max()), err_msg=name)


@pytest.mark.parametrize("padding,shape", SHAPES)
def test_gn_backward_keeps_the_unfused_formula(padding, shape):
    """WinogradConv3x3GnRelu's backward, which works in place and frees its
    full-size temporaries, gives the unfused formula's gradients bit for bit
    (bf16 operands, fp32 a / c, a seeded output gradient)."""
    x, w, b, a, c = (torch.as_tensor(v) for v in _inputs(shape, 3))
    x, w, b = x.bfloat16(), w.bfloat16(), b.bfloat16()
    x.requires_grad_(True)
    w.requires_grad_(True)
    b.requires_grad_(True)
    a.requires_grad_(True)
    c.requires_grad_(True)
    y = W.WinogradConv3x3GnRelu.apply(x, w, b, a, c, padding)
    g = torch.as_tensor(np.random.RandomState(4).randn(*y.shape).astype(np.float32))
    y.backward(g.to(y.dtype))
    with torch.no_grad():
        z = x.float() * a.float()[:, None, None, :] + c.float()[:, None, None, :]
        h = torch.relu(z).to(x.dtype)
        dh, dw, db = W._conv_vjp(h, w, padding, g.to(y.dtype))
        dz = dh.float() * (z > 0)
        want = ((dz * a.float()[:, None, None, :]).to(x.dtype), dw.to(w.dtype), db.to(b.dtype),
                (dz * x.float()).sum(dim=(1, 2)), dz.sum(dim=(1, 2)))
    for name, v, ref in zip("xwbac", (x, w, b, a, c), want):
        assert v.grad.dtype == ref.dtype and torch.equal(v.grad, ref), name


@pytest.mark.parametrize("C,K", [(128, 128), (256, 128), (128, 256)])
def test_kernel_u_is_the_bf16_transform_in_the_kernels_layout(C, K):
    """csrc/winograd.cu reads U by TMA as contiguous bf16 (16, C, K) boxes:
    kernel_u is transform_kernel (the JAX package's G w G^T, fp32) rounded
    once, in that layout, also from a weight whose storage is not (3, 3, C,
    K) in order."""
    rng = np.random.RandomState(C + K)
    w = torch.tensor(rng.randn(K, C, 3, 3).astype(np.float32)).permute(2, 3, 1, 0)
    u = W.kernel_u(w)
    assert u.dtype == torch.bfloat16 and u.shape == (16, C, K) and u.is_contiguous()
    assert torch.equal(u, W.transform_kernel(w).to(torch.bfloat16))
    want = np.asarray(JW.transform_kernel(jnp.asarray(w.numpy())), np.float32).reshape(16, C, K)
    np.testing.assert_allclose(u.float().numpy(), want, rtol=2 ** -8, atol=1e-6)


def test_conv3x3_picks_winograd_by_shape():
    """`conv3x3` (the JAX _WinoConv) runs the direct twin on shapes the
    kernels refuse (C % 128, odd sizes), Winograd otherwise."""
    x, w, b, a, c = (t(v) for v in _inputs((1, 8, 8, 128), 3))
    assert torch.equal(W.conv3x3(x, w, b, "SAME"), W.winograd_conv3x3(x, w, b, "SAME"))
    x7 = x[:, :7, :7].contiguous()
    assert not W.supports_winograd(x7.shape, 128, 128, "SAME")
    assert torch.equal(W.conv3x3(x7, w, b, "SAME"), W.conv3x3_direct(x7, w, b, "SAME"))
    assert torch.equal(W.conv3x3(x7, w, b, "VALID", (a, c)),
                       W.conv3x3_gn_relu_direct(x7, w, b, a, c, "VALID"))
    with pytest.raises(ValueError, match="multiples of 128"):
        W.winograd_conv3x3(x[..., :64], w[:, :, :64], b, "SAME")
