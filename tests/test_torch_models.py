"""The port's HuPRNet against hupr_tpu's at reduced geometry, on the same
weights and inputs: the weights carried across by state_dict_from_jax, each
module on identical inputs, and the whole network, at 1e-4 (the bar of
tests/test_reference_parity.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hupr_tpu.models import HuPRNet as JaxHuPRNet
from hupr_tpu.models.prgcn import PRGCN as JaxPRGCN
from hupr_tpu.models.torch_convert import convert_state_dict
from hupr_tpu.utils.synthetic import synthetic_variables
from hupr_tpu_torch.models.convert import state_dict_from_jax
from hupr_tpu_torch.models.hupr import HuPRNet
from hupr_tpu_torch.models.prgcn import skeleton_adjacency
from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

torch.set_num_threads(1)

ATOL = 1e-4
F, H, B, G = 4, 16, 2, 8          # numFilters, heatmap size, batch, window


def _variables(model, seed):
    """hupr_tpu's variable tree drawn with numpy at torch-default scales, so
    activations keep their size through the net: conv kernels and GCN
    leaves U(+-1/sqrt(fan_in)), PReLU slopes 0.25, and BatchNorm scale,
    bias and running statistics drawn away from their identity values so
    that a swapped or dropped BN leaf shows."""
    tree = synthetic_variables(model, (1, G, 8, 2, H, H, 8), seed=seed)
    rng = np.random.default_rng(seed)

    def draw(path, x):
        keys = [getattr(p, "key", "") for p in path]
        name, shape = keys[-1], x.shape
        if name == "var":
            x = np.abs(rng.standard_normal(shape)) * 0.5 + 0.5
        elif name == "mean" or (name == "bias" and keys[-2].startswith("bn")):
            x = rng.standard_normal(shape) * 0.1
        elif name == "scale":
            x = 1.0 + rng.standard_normal(shape) * 0.1
        elif name == "negative_slope":
            x = np.full(shape, 0.25)
        else:
            fan_in = shape[0] if "gcn" in keys else (
                np.prod(shape[:-1]) if name == "kernel" else shape[0])
            bound = 1.0 / np.sqrt(fan_in)
            x = rng.uniform(-bound, bound, shape)
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.fixture(scope="module")
def nets():
    jax_model = JaxHuPRNet(num_filters=F, heatmap_size=H, attn_impl="xla")
    variables = _variables(jax_model, seed=0)
    port = HuPRNet(num_filters=F, heatmap_size=H, attn_impl="pallas").eval()
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jax_model, variables, port


def _cl(t):
    """NC... torch tensor -> channels-last numpy."""
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def test_state_dict_round_trip_is_exact():
    """state_dict_from_jax is the inverse of convert_state_dict: every leaf
    comes back bit for bit, and the port loads it strictly."""
    model = JaxHuPRNet(num_filters=F, heatmap_size=H)
    variables = synthetic_variables(model, (1, G, 8, 2, H, H, 8), seed=3)
    port = HuPRNet(num_filters=F, heatmap_size=H)
    port.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    want, got = _leaves(variables), _leaves(
        convert_state_dict(port.state_dict()))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_state_dict_keys_are_the_reference_names():
    keys = set(HuPRNet(num_filters=F, heatmap_size=H).state_dict())
    for key in ("RAchirpNet.temporalConvWx1x1.weight",
                "RAchirpNet.temporalConvWx1x1.bias",
                "RAradarEncoder.layer1.0.weight",
                "RAradarEncoder.layer1.1.main.1.running_var",
                "REradarEncoder.layer2.1.main.0.weight",
                "REradarEncoder.layer3.2.downsample.1.weight",
                "RAradarEncoder.temporalMerge.weight",
                "radarDecoder.decoderLayer3.0.relu.weight",
                "radarDecoder.decoderLayer1.2.weight",
                "radarDecoder.phi_cross_hori.2.weight",
                "radarDecoder.gcn.L1.weight", "radarDecoder.gcn.L3.bias"):
        assert key in keys, key
    assert not any(k.endswith("adj") for k in keys)


def test_synthetic_state_dict_is_seeded_and_positive():
    port = HuPRNet(num_filters=2, heatmap_size=H)
    a, b = synthetic_state_dict(port, seed=5), synthetic_state_dict(port, 5)
    port.load_state_dict(a, strict=True)
    assert all(torch.equal(a[k], b[k]) for k in a)
    var = [v for k, v in a.items() if k.endswith("running_var")]
    assert var and all((v >= 1.0).all() for v in var)


def test_chirp_view_is_the_reference_view(nets):
    jax_model, variables, port = nets
    v = _rand((B, G, 8, 2, H, H), seed=1)
    want = jax_model.apply(variables, jnp.asarray(v),
                           method=lambda m, x: m._chirp_view(x))
    got = port._chirp_view(torch.from_numpy(v))          # (B*G, 2, 8, H, H)
    np.testing.assert_array_equal(_cl(got), np.asarray(want))


def test_mnet_matches_jax(nets):
    jax_model, variables, port = nets
    x = _rand((B * G, 8, H, H, 2), seed=2)                 # channels-last
    want = jax_model.apply(variables, jnp.asarray(x),
                           method=lambda m, x: m.RAchirpNet(x))
    with torch.no_grad():
        got = port.RAchirpNet(torch.from_numpy(np.moveaxis(x, -1, 1)))
    np.testing.assert_allclose(_cl(got), np.asarray(want), atol=ATOL)


def test_encoder3d_matches_jax(nets):
    jax_model, variables, port = nets
    x = _rand((B, G, H, H, F), seed=3)
    want = jax_model.apply(variables, jnp.asarray(x),
                           method=lambda m, x: m.REradarEncoder(x, False))
    with torch.no_grad():
        got = port.REradarEncoder(torch.from_numpy(np.moveaxis(x, -1, 1)))
    for g, w, size in zip(got, want, (H, H // 2, H // 4)):
        assert g.shape[2:] == (size, size)
        np.testing.assert_allclose(_cl(g), np.asarray(w), atol=ATOL)


def test_prgcn_matches_jax(nets):
    """Also pins the node order: (B, P, K) nodes flattened row-major from
    the (h, w) grid, as the JAX package flattens channels-last."""
    _, variables, port = nets
    logits = _rand((B, H, H, 14), seed=4) * 3
    gcn_vars = {"params": variables["params"]["radarDecoder"]["gcn"]}
    want = JaxPRGCN(H, 14).apply(gcn_vars, jnp.asarray(logits))
    with torch.no_grad():
        got = port.radarDecoder.gcn(torch.from_numpy(
            np.moveaxis(logits, -1, 1)))
    np.testing.assert_allclose(_cl(got), np.asarray(want), atol=ATOL)
    adj = skeleton_adjacency()
    assert adj[8, 6] == adj[11, 6] == 1.0 and adj[6, 8] == adj[6, 11] == 0.0


def test_mscsa_decoder_matches_jax(nets):
    jax_model, variables, port = nets
    maps = [_rand((B, H // d, H // d, F * c), seed=10 + i)
            for i, (d, c) in enumerate(((1, 2), (2, 4), (4, 8)) * 2)]
    want = jax_model.apply(
        variables, *map(jnp.asarray, maps),
        method=lambda m, *a: m.radarDecoder(*a, False))
    with torch.no_grad():
        got = port.radarDecoder(*(torch.from_numpy(np.moveaxis(x, -1, 1))
                                  for x in maps))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_cl(g), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_hupr_stages_and_forward_match_jax(nets, attn_impl):
    """chirp_maps, pose_from_maps and the whole forward; the port runs the
    kernel wrapper (on the CPU: its plain version) or the eager path."""
    jax_model, variables, _ = nets
    port = HuPRNet(num_filters=F, heatmap_size=H, attn_impl=attn_impl).eval()
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    hori = _rand((B, G, 8, 2, H, H, 8), seed=20)
    vert = _rand((B, G, 8, 2, H, H, 8), seed=21)
    j_ra, j_re = jax_model.apply(variables, hori, vert, method="chirp_maps")
    j_heat, j_gcn = jax_model.apply(variables, hori, vert)
    with torch.no_grad():
        ra, re = port.chirp_maps(torch.from_numpy(hori),
                                 torch.from_numpy(vert))
        np.testing.assert_allclose(ra.numpy(), np.asarray(j_ra), atol=ATOL)
        np.testing.assert_allclose(re.numpy(), np.asarray(j_re), atol=ATOL)
        heat_m, gcn_m = port.pose_from_maps(
            torch.from_numpy(np.array(j_ra)),
            torch.from_numpy(np.array(j_re)))
        heat, gcn = port(torch.from_numpy(hori), torch.from_numpy(vert))
    assert heat.shape == (B, 14, 1, H, H) and gcn.shape == (B, 1, 14, H, H)
    for got in ((heat_m, gcn_m), (heat, gcn)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(j_heat),
                                   atol=ATOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(j_gcn),
                                   atol=ATOL)
    # the heatmaps carry signal, not a flat 0.5 that any net would match
    assert np.asarray(j_heat).std() > 1e-3
