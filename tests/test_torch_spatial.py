"""The (data, spatial) sharded forward and the int8 forward over the data
axis: four gloo ranks on the CPU.

Four worker processes (tests/torch_parallel_worker.py, started once for the
module) run the flagship forward of ``tiny_train_args``' AdaINModel (the
port's seeded init at ``tiny_train_args``' widths, carried into the JAX
tree by ``torch_train_steps.jax_tree``, so that no Flax init runs) on a 2 x 2
mesh, each rank on its 2 images' 16 of 32 rows; gathered, it must equal the
port's unsharded forward within 1e-5 and the JAX package's
``_forward_random_jit`` within 1e-4, ``tests/test_sharding.py``'s bound.
The same ranks serve the int8 forward over a 4-rank data mesh, one image
each, with this process's calibration: it must equal this process's int8
forward on all 4 images within 1e-5 (the float stem and the f32 scales
compute per image, the int8 sums exactly). The ranks' halo rows of a
16-row image split four ways must equal ``F.pad`` of the whole image
sliced at each rank's rows. In-process: the stats-given AdaIN's plain
version against ``adain_plain``, and a shard too short to reflect raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

pytest.importorskip("flax")

from masterthesis_tpu.arguments import default_test_args as jax_test_args  # noqa: E402
from masterthesis_tpu.models import AdaINModel as JaxAdaINModel  # noqa: E402
from masterthesis_tpu_torch.ops.kernels import adain as kadain  # noqa: E402
from masterthesis_tpu_torch.parallel import spatial  # noqa: E402
from tests import torch_parallel_worker as W  # noqa: E402
from tests import torch_train_steps as S  # noqa: E402

torch.set_num_threads(2)

RANKS = 4
# tests/conftest.py tiny_train_args' widths, for serving
TINY = dict(crop_size=32, dim=8, latent_dim=4, num_domains=4, batch_size=4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("spatial")
    jm = JaxAdaINModel(jax_test_args(**TINY))
    model = W.spatial_model()
    params = jax.tree_util.tree_map(jnp.asarray, S.jax_tree(model))
    img, z, c = W.spatial_inputs()
    quant = model.calibrate_int8([img], [c], [z])
    weights = {n: net.state_dict() for n, net in model.nets.items()}
    torch.save(dict(weights=weights, quant=quant), out_dir / "inputs.pt")
    ranks = W.Ranks(RANKS, "spatial", out_dir, out_dir / "inputs.pt", timeout=240)
    try:
        int8, _, _ = model.forward_random(img, z, c)
        model.disable_int8()
        port, _, _ = model.forward_random(img, z, c)
        want = np.asarray(jm._forward_random_jit(params, jnp.asarray(img), jnp.asarray(z),
                                                 jnp.asarray(c)))
    finally:
        outs = ranks.wait()
    return dict(port=port, jax=want, int8=int8), [torch.load(o + ".pt") for o in outs]


def test_spatial_forward_matches_the_unsharded_port_and_jax(runs):
    ref, ranks = runs
    for r, out in enumerate(ranks):
        got = out["spatial"]
        assert got.shape == ref["port"].shape == (4, 32, 32, 3)
        # each rank's block is its (data, spatial) rows
        d, s = divmod(r, 2)
        torch.testing.assert_close(out["block"], got[2 * d:2 * d + 2, 16 * s:16 * s + 16],
                                   rtol=0, atol=0)
        assert (got - ref["port"]).abs().max().item() <= 1e-5, r
        np.testing.assert_allclose(got.numpy(), ref["jax"], atol=1e-4)
    assert np.abs(ref["jax"]).max() > 0.1, "outputs must be far from 0 to test anything"


def test_int8_forward_over_the_data_axis_matches_one_rank(runs):
    ref, ranks = runs
    for out in ranks:
        assert out["int8"].shape == ref["int8"].shape
        assert (out["int8"] - ref["int8"]).abs().max().item() <= 1e-5
    assert (ref["int8"] - ref["port"]).abs().max().item() > 1e-4, "int8 must differ from float"


@pytest.mark.parametrize("case", W.HALO_CASES)
def test_halo_rows_match_pad_and_slice(runs, case):
    _, ranks = runs
    top, bottom, edge = case
    x = W.halo_image()
    mode = "reflect" if edge == "reflect" else "constant"
    padded = F.pad(x, (0, 0, top, bottom), mode=mode)
    h = x.shape[2] // RANKS
    for r, out in enumerate(ranks):
        torch.testing.assert_close(out["halos"][tuple(case)], padded[:, :, r * h:(r + 1) * h
                                                                      + top + bottom],
                                   rtol=0, atol=0)


def test_stats_given_adain_plain_matches_adain_plain():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5, 7, 9), generator=g) * 2 + 0.5
    gamma, beta = torch.randn((3, 5), generator=g), torch.randn((3, 5), generator=g)
    x64 = x.double()
    mean = x64.mean(dim=(2, 3))
    rstd = torch.rsqrt((x64 - mean[:, :, None, None]).square().mean(dim=(2, 3)) + 1e-5)
    got = kadain.adain_stats_plain(x, mean.float(), rstd.float(), gamma, beta)
    want = kadain.adain_plain(x, gamma, beta)
    assert got.dtype == x.dtype
    assert (got - want).abs().max().item() <= 1e-5
    got16 = kadain.adain_stats_plain(x.bfloat16(), mean.float(), rstd.float(), gamma, beta)
    assert got16.dtype == torch.bfloat16


def test_a_shard_too_short_to_reflect_raises():
    x = torch.zeros((1, 2, 3, 4))
    with pytest.raises(ValueError, match="cannot reflect 3 rows"):
        spatial.halo_rows(x, 3, 3, None)
