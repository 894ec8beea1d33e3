"""Serving over a ('data', 'model') mesh, the counterpart of
tests/test_serving_mesh.py: the stage-2 rollout of B = 2 streams over a
(2, 2) mesh of four CPU ranks (gloo, tests/torch_ranks.py), the streams
sharded over 'data' and the annotated weights over 'model'
(serve.build_rollout(..., mesh=)), against the one-process rollout on the
same seeded weights (the gaussian heads perturbed off zero) and inputs, two
chunks with the token window slid between them. The JAX test's own bounds:
the 99.9th percentile of |sharded - single| below 1e-4 and its maximum
below 5e-3 (a reordered float32 sum can move a gaussian across a splat
threshold). At least one parameter is really sharded. Both the tiny
configuration and the serving profile (the sparse final upsampler level
with the affine norm, the segmented splat, the quad sampler).
"""

import numpy as np
import pytest

from torch_parity import one_torch_thread  # noqa: F401
from torch_ranks import run_ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("serve"), 4, ["serve_mesh", "serve_mesh_profile"],
                     timeout=600)


@pytest.mark.parametrize("scenario", ["serve_mesh", "serve_mesh_profile"])
def test_serving_rollout_data_model_mesh_matches_single_process(ranks, scenario):
    for r in ranks:
        out = r[scenario]
        assert out["n_sharded"] > 0, "serving TP silently replicated"
        got, want = out["got"].float().numpy(), out["want"].float().numpy()
        assert got.shape == want.shape == (2, 2 * 6, 32, 32, 3), got.shape
        assert float(want.std()) > 1e-3, "blank frames"
        diff = np.abs(got - want)
        assert np.percentile(diff, 99.9) < 1e-4, np.percentile(diff, 99.9)
        assert diff.max() < 5e-3, diff.max()
        tri = np.abs(out["got_tri"].numpy() - out["want_tri"].numpy())
        assert tri.max() <= 1e-5 * np.abs(out["want_tri"].numpy()).max()
