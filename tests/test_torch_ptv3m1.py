"""The refiner's published form, Pointcept's PT-v3m1 (`ptv3_form:
"pointcept"`, models/ptv3.PointceptUNet), against the benchmark's plain
float32 reference (benchmark/reference/plain_ptv3m1.py), which follows
Pointcept step for step and shares nothing with the port; its pieces
against independent oracles: the plain sparse conv against a dense
F.conv3d, the pooling against torch.unique, the curve codes at a depth
below 10 against the JAX package's `encode`; the one host sync a call; the
form on the port's normal path; and the importer's map of the whole U-Net.

Weights are seeded as the benchmark seeds them (N(0, 1/fan_in) matrices),
with every 1-D parameter and BatchNorm's running statistics drawn away from
0 / 1, so that each norm's affine and statistics show.

The refiner takes B clouds of N points each (the renderer's B frames), so
level 0 holds equal counts; the clouds here differ in extent and crowding,
so from level 1 on each cloud has its own count, one cloud is small enough
that a level falls below the patch size, and one cloud has many points
sharing voxels.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_motion_avatar_tpu.ops import serialization as jser

from audio_motion_avatar_tpu_torch.models import ptv3
from audio_motion_avatar_tpu_torch.models.config import AvatarConfig
from audio_motion_avatar_tpu_torch.ops import serialization as ser
from audio_motion_avatar_tpu_torch.ops import sparse_conv as sc
from audio_motion_avatar_tpu_torch.utils import profiling
from benchmark.reference.plain_ptv3m1 import PlainPTv3m1
from torch_parity import one_torch_thread  # noqa: F401

IN_DIM = 48
WIDTHS = dict(enc_channels=(32, 64, 32), enc_depths=(1, 2, 1), enc_heads=(2, 1, 1),
              dec_channels=(64, 32), dec_depths=(2, 1), dec_heads=(1, 2))
PATCH = 256
RES = 100.0


def seeded_state(module, seed=1):
    """The module's state_dict drawn from a seed: matrices N(0, 1/fan_in),
    1-D weights 1 + N(0, 0.3), biases and running means N(0, 0.3), running
    variances U(0.5, 1.5)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in module.state_dict().items():
        if not v.is_floating_point():
            out[k] = v
        elif k.endswith("running_var"):
            out[k] = torch.rand(v.shape, generator=g) + 0.5
        elif v.dim() == 1:
            base = 1.0 if k.endswith("weight") else 0.0
            out[k] = base + 0.3 * torch.randn(v.shape, generator=g)
        else:
            out[k] = torch.randn(v.shape, generator=g) / v[0].numel() ** 0.5
    return out


def clouds(seed=0, N=700):
    """Three clouds of N points: a wide box, a thin slab whose first 3/7
    points repeat the next 3/7 a hair apart (shared voxels), and a small
    dense ball (its level 2 below the patch size)."""
    g = torch.Generator().manual_seed(seed)
    pts = torch.rand(3, N, 3, generator=g)
    pts[0] *= torch.tensor([0.6, 0.4, 0.5])
    pts[1] *= torch.tensor([0.5, 0.5, 0.03])
    rep = 3 * N // 7
    pts[1, :rep] = pts[1, rep:2 * rep] + 1e-4
    pts[2] = torch.randn(N, 3, generator=g) * 0.04 - 1.3
    return pts, torch.randn(3, N, IN_DIM, generator=g)


def models(dtype=None):
    port = ptv3.PointceptUNet(IN_DIM, patch_size=PATCH, grid_resolution=RES, dtype=dtype,
                              **WIDTHS)
    ref = PlainPTv3m1(IN_DIM, WIDTHS["enc_channels"], WIDTHS["enc_depths"],
                      WIDTHS["enc_heads"], WIDTHS["dec_channels"], WIDTHS["dec_depths"],
                      WIDTHS["dec_heads"], PATCH, RES, False)
    sd = seeded_state(ref)
    port.load_state_dict(sd, strict=True)
    ref.load_state_dict(sd, strict=True)
    return port.eval(), ref.eval()


def test_clouds_exercise_the_form():
    """The test clouds give unequal counts from level 1 on, a level below
    the patch size, and shared voxels at level 0."""
    port, _ = models()
    level, sizes, counts, _ = port.levels(clouds()[0])
    assert len(set(sizes[1])) == 3 and len(set(sizes[2])) == 3
    assert min(sizes[2]) < PATCH < max(sizes[1])
    assert sizes[0][1] < 700 - 250                  # voxels of cloud 1: many rows share one
    assert level.depth == int(level.grid.max()).bit_length()
    assert torch.equal(counts, torch.tensor(sizes))


def test_port_matches_plain_reference_fp32():
    """The port's form in fp32 against the plain reference: at most 1e-4 of
    the output's largest magnitude. Both compute every product in fp32;
    they differ in summation order (per-voxel gathers and index_add against
    per-row ones, kernel order of the attention), ~1e-7 relative a layer,
    through 8 blocks whose residuals grow the activations. The same
    comparison with the port in bf16 misses it by far (bf16 keeps 8
    significant bits: ~4e-3 a rounding)."""
    pts, feats = clouds()
    port, ref = models()
    with torch.no_grad():
        want = ref(pts, feats)
        got = port(pts, feats)
    tol = 1e-4 * float(want.abs().max())
    assert got.shape == want.shape == (3, 700, WIDTHS["dec_channels"][0])
    err = float((got - want).abs().max())
    assert err <= tol, (err, tol)

    port16, _ = models(torch.bfloat16)
    with torch.no_grad():
        got16 = port16(pts, feats)
    assert float((got16 - want).abs().max()) > 10 * tol


@pytest.mark.parametrize("k", [3, 5])
def test_subm_conv_plain_matches_dense_conv3d(k):
    """The plain sparse conv over a neighbour map equals a dense F.conv3d
    over the voxel grid, read at the occupied voxels (float64, 1e-12): two
    clouds on a 7^3 grid, 40% occupied, some voxels of cloud 1 at the
    grid's edges."""
    g = torch.Generator().manual_seed(k)
    C_in, C_out, side = 4, 3, 7
    occ = torch.rand(2, side, side, side, generator=g) < 0.4
    occ[1, 0, 0, 0] = occ[1, side - 1, side - 1, side - 1] = True
    cloud, gx, gy, gz = occ.nonzero(as_tuple=True)
    grid = torch.stack([gx, gy, gz], 1).to(torch.int32)
    x = torch.randn(cloud.numel(), C_in, generator=g, dtype=torch.float64)
    w = torch.randn(C_out, k, k, k, C_in, generator=g, dtype=torch.float64)
    b = torch.randn(C_out, generator=g, dtype=torch.float64)
    rows = torch.arange(cloud.numel())
    nbr = sc.neighbour_map(sc.voxel_keys(cloud, grid), rows, k)
    got = sc.subm_conv_plain(x, nbr, w, b)
    dense = torch.zeros(2, C_in, side, side, side, dtype=torch.float64)
    dense[cloud, :, gx, gy, gz] = x
    conv = torch.nn.functional.conv3d(dense, w.permute(0, 4, 1, 2, 3), b, padding=k // 2)
    want = conv[cloud, :, gx, gy, gz]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    assert int((nbr >= 0).sum()) < nbr.numel()           # some offsets absent


@pytest.mark.parametrize("k", [3, 5])
def test_subm_conv_backward_matches_plain(k):
    """SubmConv's backward (on the card: kernel SC over the mirrored map
    for dx, a matmul per offset for dW; here the plain version in SC's
    place) equals autograd through the plain version, float64 within
    1e-12, and passes gradcheck: two clouds on a 6^3 grid, about a third of
    the voxels holding two rows (the second row of a voxel, which no map
    reads, gets a zero gradient; gradcheck in its fast mode, a random
    projection, for time)."""
    g = torch.Generator().manual_seed(10 + k)
    occ = torch.rand(2, 6, 6, 6, generator=g) < 0.4
    cloud, gx, gy, gz = occ.nonzero(as_tuple=True)
    M = cloud.numel()
    voxel_of_row = torch.repeat_interleave(
        torch.arange(M), 1 + (torch.rand(M, generator=g) < 0.3).long())
    rep = torch.searchsorted(voxel_of_row, torch.arange(M))
    nbr = sc.neighbour_map(sc.voxel_keys(cloud, torch.stack([gx, gy, gz], 1)), rep, k)
    x = torch.randn(voxel_of_row.numel(), 4, generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn(3, k ** 3, 4, generator=g, dtype=torch.float64, requires_grad=True)
    b = torch.randn(3, generator=g, dtype=torch.float64, requires_grad=True)
    y = sc.SubmConv.apply(x, nbr, w, b)
    want = sc.subm_conv_plain(x, nbr, w.reshape(3, k, k, k, 4), b)
    dy = torch.randn(y.shape, generator=g, dtype=torch.float64)
    for got, ref in zip(torch.autograd.grad(y, (x, w, b), dy),
                        torch.autograd.grad(want, (x, w, b), dy)):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-12)
    assert torch.autograd.gradcheck(lambda x, w, b: sc.SubmConv.apply(x, nbr, w, b), (x, w, b),
                                    fast_mode=True)
    mirror = sc.mirrored_map(nbr, x.shape[0])
    assert torch.equal(mirror >= 0, (nbr >= 0).flip(1))     # a symmetric stencil


def test_pooling_matches_unique():
    """Level 0 -> 1: the clusters are torch.unique of (cloud, g >> 1), the
    counts its counts, the pooled coordinates the clusters' mean points
    (1e-6: fp32 means of at most a few hundred points), the pooled grid
    g >> 1, the pooled rows in ascending z code within each cloud, and the
    sizes read back the clusters' counts."""
    port, _ = models()
    pts, _ = clouds()
    level, sizes, counts, _ = port.levels(pts)
    cluster, head, lengths, pooled = ptv3.pool_level(level, 1, sizes[1], counts[1])
    key = (level.cloud.long() << 30) | sc.voxel_keys(torch.zeros_like(level.cloud),
                                                     level.grid >> 1)
    uniq, uinv, ucount = torch.unique(key, return_inverse=True, return_counts=True)
    assert pooled.rows == uniq.numel() == sum(sizes[1])
    of_cluster = torch.zeros(pooled.rows, dtype=torch.long).scatter_(0, cluster, uinv)
    assert torch.equal(of_cluster[cluster], uinv)                      # a bijection
    assert torch.equal(torch.sort(of_cluster).values, torch.arange(pooled.rows))
    assert torch.equal(lengths, ucount[of_cluster])
    mean = torch.zeros(uniq.numel(), 3, dtype=torch.float64).index_add_(
        0, uinv, level.coord.double()) / ucount[:, None]
    torch.testing.assert_close(pooled.coord.double(), mean[of_cluster], rtol=0, atol=1e-6)
    assert torch.equal(pooled.grid, (level.grid >> 1)[head])
    assert torch.equal(torch.bincount(pooled.cloud), torch.tensor(sizes[1]))
    z = pooled.codes[0].long() + (pooled.cloud.long() << 31)
    assert bool((z[1:] > z[:-1]).all())
    assert torch.equal(pooled.codes, level.codes[:, head] >> 3)


@pytest.mark.parametrize("depth", [1, 4, 7])
@pytest.mark.parametrize("order", ser.ORDERS)
def test_sfc_depth_matches_jax_encode(order, depth):
    """Codes at `depth` bits an axis equal the JAX package's encode at that
    depth of the grid clamped to it, exactly (integers)."""
    pts, _ = clouds(3, N=300)
    mask = torch.ones(300, dtype=torch.bool)
    got = ser.sfc_codes(pts, mask, RES, [order], depth)[0]
    for b in range(3):
        grid = jser.grid_coords(jnp.asarray(pts[b].numpy()), RES, depth)
        want = np.asarray(jser.encode(grid, order, depth))
        np.testing.assert_array_equal(got[b].numpy(), want)


def test_sfc_default_depth_unchanged():
    """The default call is depth 10, the codes of the serial form."""
    pts, _ = clouds(4, N=300)
    mask = torch.arange(300) < 250
    a = ser.sfc_codes(pts, mask, RES, ser.ORDERS)
    assert torch.equal(a, ser.sfc_codes(pts, mask, RES, ser.ORDERS, 10))
    assert torch.equal(a, torch.stack([torch.where(mask, ser.encode(
        ser.grid_coords(pts, RES), o), ser.PAD_CODE) for o in ser.ORDERS]))
    with pytest.raises(ValueError, match="depth"):
        ser.sfc_codes(pts, mask, RES, ser.ORDERS, 11)


def test_one_host_sync_a_call():
    """A call of the form waits for the card once, at "ptv3.levels"; the
    serial form not at all."""
    port, _ = models()
    pts, feats = clouds()
    before = profiling.syncs()
    with torch.no_grad():
        port(pts, feats)
        port(pts, feats)
    after = profiling.syncs()
    grew = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    assert {k: v for k, v in grew.items() if v} == {"ptv3.levels": 2}
    serial = ptv3.PTv3Encoder(IN_DIM, 16, enc_channels=(16, 32), enc_depths=(1, 1),
                              enc_heads=(2, 2), dec_channels=(16,), dec_depths=(1,),
                              dec_heads=(2,), patch_size=64)
    before = profiling.syncs()
    with torch.no_grad():
        serial(pts[:, :256], feats[:, :256])
    assert profiling.syncs() == before


def test_form_on_the_serving_and_reconstruction_paths():
    """ptv3_form "pointcept" builds and runs through serve.build_rollout and
    reconstruct.build_reconstructor (tiny profile, CPU), with a refiner of
    the form's modules; a form that is neither raises."""
    import dataclasses

    from audio_motion_avatar_tpu_torch.ops import smplx as tsmplx
    from audio_motion_avatar_tpu_torch.reconstruct import build_reconstructor
    from audio_motion_avatar_tpu_torch.serve import build_rollout, synthetic_inputs

    cfg = dataclasses.replace(AvatarConfig.tiny(image_size=(32, 32)), ptv3_form="pointcept",
                              ptv3_output_dim=16, frames_per_chunk=2)
    body = tsmplx.synthetic_model(seed=0, num_verts=300)
    rollout = build_rollout(cfg, device="cpu", smplx_model=body)
    unet = rollout.model.renderer.point_refiner.unet
    assert isinstance(unet, ptv3.PointceptUNet)
    tri, smpl, audio, cams = synthetic_inputs(cfg, 1, "cpu")
    before = profiling.syncs().get("ptv3.levels", 0)
    frames = rollout(tri, smpl, audio, cams)[0]
    assert frames.shape == (1, cfg.triplane_output_frames, 32, 32, 3)
    assert bool(torch.isfinite(frames).all())
    assert profiling.syncs()["ptv3.levels"] - before == cfg.triplane_output_frames // 2
    recon = build_reconstructor(cfg, device="cpu", smplx_model=body)
    assert isinstance(recon.model.renderer.point_refiner.unet, ptv3.PointceptUNet)
    with pytest.raises(ValueError, match="ptv3_form"):
        ptv3.build_point_refiner(dataclasses.replace(cfg, ptv3_form="spconv"))
    with pytest.raises(ValueError, match="ptv3_output_dim"):
        ptv3.build_point_refiner(dataclasses.replace(cfg, ptv3_output_dim=256))


def upstream_state_dict(cfg, prefix):
    """A synthetic reference state dict of the PT-v3m1 U-Net in the
    upstream's names and spconv 2.x's layouts, every tensor distinct."""
    g = torch.Generator().manual_seed(5)
    sd = {}

    def t(*shape):
        return torch.randn(shape, generator=g)

    def norm(p, c, stats=False):
        sd[f"{p}.weight"], sd[f"{p}.bias"] = t(c), t(c)
        if stats:
            sd[f"{p}.running_mean"], sd[f"{p}.running_var"] = t(c), t(c).abs()
            sd[f"{p}.num_batches_tracked"] = torch.tensor(7)

    def lin(p, i, o):
        sd[f"{p}.weight"], sd[f"{p}.bias"] = t(o, i), t(o)

    def block(bp, c):
        sd[f"{bp}.cpe.0.weight"], sd[f"{bp}.cpe.0.bias"] = t(c, 3, 3, 3, c), t(c)
        lin(f"{bp}.cpe.1", c, c)
        norm(f"{bp}.cpe.2", c)
        norm(f"{bp}.norm1.0", c)
        lin(f"{bp}.attn.qkv", c, 3 * c)
        lin(f"{bp}.attn.proj", c, c)
        norm(f"{bp}.norm2.0", c)
        lin(f"{bp}.mlp.fc1", c, 4 * c)
        lin(f"{bp}.mlp.fc2", 4 * c, c)

    enc, dec = cfg.ptv3_enc_channels, cfg.ptv3_dec_channels
    sd[f"{prefix}.embedding.stem.conv.weight"] = t(enc[0], 5, 5, 5, 3 * cfg.triplane_feature_dim)
    norm(f"{prefix}.embedding.stem.norm", enc[0], True)
    for s, c in enumerate(enc):
        if s:
            lin(f"{prefix}.enc.enc{s}.down.proj", enc[s - 1], c)
            norm(f"{prefix}.enc.enc{s}.down.norm.0", c, True)
        for b in range(cfg.ptv3_enc_depths[s]):
            block(f"{prefix}.enc.enc{s}.block{b}", c)
    chans = tuple(dec) + (enc[-1],)
    for d in range(len(dec)):
        up = f"{prefix}.dec.dec{d}.up"
        lin(f"{up}.proj.0", chans[d + 1], chans[d])
        norm(f"{up}.proj.1", chans[d], True)
        lin(f"{up}.proj_skip.0", enc[d], chans[d])
        norm(f"{up}.proj_skip.1", chans[d], True)
        for b in range(cfg.ptv3_dec_depths[d]):
            block(f"{prefix}.dec.dec{d}.block{b}", chans[d])
    return sd


def test_import_maps_the_whole_unet():
    """A reference state dict of the whole PT-v3m1 U-Net (upstream names,
    spconv 2.x layouts) maps onto every parameter and running statistic of
    the port's form: none skipped, none left unset, the spconv weights
    copied as stored, the BatchNorm statistics and the qkv split in
    place."""
    import dataclasses

    from audio_motion_avatar_tpu_torch.models.audio_avatar import AudioDrivenAvatar
    from audio_motion_avatar_tpu_torch.training import torch_import as ti

    cfg = dataclasses.replace(AvatarConfig.tiny(), ptv3_form="pointcept", ptv3_output_dim=16)
    prefix = "triplane_gaussian.renderer.point_encoder.point_transformer"
    sd = upstream_state_dict(cfg, prefix)
    params, report = ti.map_reference_state_dict(sd, cfg, stage=2)
    assert not [m for m in report["skipped_modules"] if "point_transformer" in m]
    model = AudioDrivenAvatar(cfg)
    unet = model.renderer.point_refiner.unet
    marker = -12345.0
    with torch.no_grad():
        for v in unet.state_dict().values():
            if v.is_floating_point():
                v.fill_(marker)
    assert ti.merge_into(model, params) == []
    for name, v in unet.state_dict().items():
        if v.is_floating_point():
            assert not bool((v == marker).any()), name
    assert torch.equal(unet.stem_conv.weight, sd[f"{prefix}.embedding.stem.conv.weight"])
    assert torch.equal(unet.enc1_b0.cpe_conv.weight, sd[f"{prefix}.enc.enc1.block0.cpe.0.weight"])
    assert torch.equal(unet.pool1_bn.running_var, sd[f"{prefix}.enc.enc1.down.norm.0.running_var"])
    assert torch.equal(unet.dec0_bn_skip.running_mean,
                       sd[f"{prefix}.dec.dec0.up.proj_skip.1.running_mean"])
    assert torch.equal(unet.dec0_proj_up.weight, sd[f"{prefix}.dec.dec0.up.proj.0.weight"])
    C = cfg.ptv3_enc_channels[0]
    assert torch.equal(unet.enc0_b0.attn.key.weight,
                       sd[f"{prefix}.enc.enc0.block0.attn.qkv.weight"][C:2 * C])
    assert torch.equal(unet.enc0_b0.cpe_ln.weight, sd[f"{prefix}.enc.enc0.block0.cpe.2.weight"])
