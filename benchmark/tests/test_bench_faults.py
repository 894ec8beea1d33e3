"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at
the tiny profile, with the cells' own limits. One test a fault the cell
can have (one card, so no exchange between cards to leave out):

- serving: a step that returns its state unchanged; half of the batch left
  out (the other half's answer in its place); a token altered where it is
  produced;
- reconstruction: half of the novel views left out; a token altered where
  it is produced.
"""

import pytest
import torch

from benchmark.tests.test_bench_reference import RECON, SERVE, tiny_run


def unchanged_state(monkeypatch):
    from audio_motion_avatar_tpu_torch import serve

    call = serve.Rollout.__call__

    def broken(self, tri, smpl, audio, cams):
        rendered, _, _, pred = call(self, tri, smpl, audio, cams)
        return rendered, tri, smpl, pred
    monkeypatch.setattr(serve.Rollout, "__call__", broken)


def half_batch(monkeypatch):
    from audio_motion_avatar_tpu_torch import serve

    call = serve.Rollout.__call__

    def broken(self, tri, smpl, audio, cams):
        h = tri.shape[0] // 2
        out = call(self, tri[:h], smpl[:h], audio[:h], {k: v[:h] for k, v in cams.items()})

        def twice(x):
            return torch.cat([x, x], 0)
        return (twice(out[0]), twice(out[1]), twice(out[2]),
                {k: twice(v) for k, v in out[3].items()})
    monkeypatch.setattr(serve.Rollout, "__call__", broken)


def altered_token(monkeypatch):
    from audio_motion_avatar_tpu_torch.models.audio_net import AudioTriplaneNet

    forward = AudioTriplaneNet.forward

    def broken(self, *args):
        out_tri, out_smpl = forward(self, *args)
        out_tri = out_tri.clone()
        out_tri[0, -1, :, 7] = 0.0           # one token of the last frame
        return out_tri, out_smpl
    monkeypatch.setattr(AudioTriplaneNet, "forward", broken)


def half_views(monkeypatch):
    from audio_motion_avatar_tpu_torch.training import stage1

    render = stage1.render_multi_view

    def broken(gaussians, K, E, *args, **kw):
        h = K.shape[1] // 2
        out = render(gaussians, K[:, :h], E[:, :h], *args, **kw)
        return torch.cat([out, out], 1)
    monkeypatch.setattr(stage1, "render_multi_view", broken)


def altered_fused_token(monkeypatch):
    from audio_motion_avatar_tpu_torch.models.fusion import FeatureFusionNetwork

    forward = FeatureFusionNetwork.forward

    def broken(self, *args):
        tri, smpl = forward(self, *args)
        tri = tri.clone()
        tri[..., 5] = 0.0
        return tri, smpl
    monkeypatch.setattr(FeatureFusionNetwork, "forward", broken)


@pytest.mark.parametrize("spec,fault", [
    (SERVE, unchanged_state), (SERVE, half_batch), (SERVE, altered_token),
    (RECON, half_views), (RECON, altered_fused_token)],
    ids=["serve-unchanged-state", "serve-half-batch", "serve-altered-token",
         "recon-half-views", "recon-altered-token"])
def test_fault_is_not_correct(spec, fault, monkeypatch):
    fault(monkeypatch)
    out = tiny_run(spec)
    assert not out["correct"], out["checks"]
