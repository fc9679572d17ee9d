"""Parity of the port's EV-FlowNet and E2VID against the flax modules, and
the weight converter, on the CPU.

Weights are a flax ``init`` (narrow widths) or the committed
``runs/*/params.npz`` (full width), carried into the port by
``convert``; inputs come from numpy seeds. Outputs agree to 1e-4 of their
scale (f32 convolutions in another order; ~1e-6 measured).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_utils_tpu.models import networks as jnet
import event_utils_tpu_torch as P
from event_utils_tpu_torch import convert
from event_utils_tpu_torch.errors import ConfigurationError, DataFormatError
from event_utils_tpu_torch.models import networks as pnet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOW_PARAMS = os.path.join(REPO, "runs", "flow128_similarity", "params.npz")
RECON_PARAMS = os.path.join(REPO, "runs", "recon128v2", "params.npz")
REL = 1e-4


def flat(params):
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in leaves}


def flax_params_npz(path):
    """The flax variables of a ``params.npz``: its keys are
    ``jax.tree_util.keystr`` paths of the nested dict."""
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            if key.startswith("__"):
                continue
            node = tree
            parts = key[2:-2].split("']['")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = jnp.asarray(z[key])
    return tree


def assert_rel(got, ref, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, (err, scale)


@pytest.fixture
def gen():
    return np.random.default_rng(3)


def voxels(gen, shape):
    return gen.normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Narrow widths from a flax init
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[1, 3], ids=["depth1", "depth3"])
def narrow_flow(request):
    """A flax EV-FlowNet init at base width 8, its port, an input and the
    flax output."""
    depth = request.param
    x = np.random.default_rng(depth).normal(
        size=(2, 10, 32, 32)).astype(np.float32)
    jm = jnet.EVFlowNet(base_features=8, depth=depth)
    params = jax.jit(jm.init)(jax.random.PRNGKey(depth), jnp.asarray(x))
    pm = pnet.EVFlowNet(10, base_features=8, depth=depth)
    convert.load_flax_params(pm, flat(params))
    return pm, x, np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))


def test_evflownet_matches_flax(narrow_flow):
    pm, x, ref = narrow_flow
    assert_rel(pm(torch.as_tensor(x)), ref)


@pytest.mark.parametrize("levels,blocks", [(1, 0), (3, 2)])
def test_e2vid_matches_flax_over_windows(gen, levels, blocks):
    jm = jnet.E2VID(base_features=8, recurrent_levels=levels,
                    num_res_blocks=blocks)
    x0 = voxels(gen, (2, 10, 32, 32))
    params = jax.jit(jm.init)(jax.random.PRNGKey(5), jnp.asarray(x0), None)
    pm = pnet.E2VID(10, base_features=8, recurrent_levels=levels,
                    num_res_blocks=blocks)
    convert.load_flax_params(pm, flat(params))
    # a zero first state, as ReconstructionTrainer.reconstruct passes it
    js = jax.tree_util.tree_map(jnp.asarray, tuple(
        np.zeros((2,) + s[2:] + s[1:2], np.float32)
        for s in ((pm.state_shapes(2, 32, 32),) if levels == 1
                  else pm.state_shapes(2, 32, 32))))
    js = js[0] if levels == 1 else js
    step = jax.jit(jm.apply)
    ps = None
    for _ in range(3):
        x = voxels(gen, (2, 10, 32, 32))
        ji, js = step(params, jnp.asarray(x), js)
        pi, ps = pm(torch.as_tensor(x), ps)
        assert_rel(pi, ji)
        for a, b in zip(jax.tree_util.tree_leaves(js),
                        ps if isinstance(ps, tuple) else (ps,)):
            assert_rel(b, np.transpose(np.asarray(a), (0, 3, 1, 2)))


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_e2vid_state_shapes_match_eval_shape(levels):
    jm = jnet.E2VID(base_features=8, recurrent_levels=levels)
    x = jnp.zeros((3, 10, 32, 48))
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, None)
    _, sd = jax.eval_shape(lambda p, v: jm.apply(p, v, None), params, x)
    # NHWC there, NCHW here
    want = [tuple(np.array(s.shape)[[0, 3, 1, 2]])
            for s in jax.tree_util.tree_leaves(sd)]
    pm = pnet.E2VID(10, base_features=8, recurrent_levels=levels)
    got = pm.state_shapes(3, 32, 48)
    assert ([got] if levels == 1 else list(got)) == want
    state = pm.zero_state(3, 32, 48)
    leaves = [state] if levels == 1 else list(state)
    assert [tuple(s.shape) for s in leaves] == want
    assert all(float(s.abs().sum()) == 0 for s in leaves)


# ---------------------------------------------------------------------------
# Full width with the committed weights
# ---------------------------------------------------------------------------

def test_evflownet_committed_weights_full_width(gen):
    x = np.abs(voxels(gen, (2, 10, 128, 128)))
    ref = jax.jit(jnet.EVFlowNet().apply)(flax_params_npz(FLOW_PARAMS),
                                          jnp.asarray(x))
    pt = P.training.FlowTrainer(sensor_size=(128, 128), device="cpu")
    assert pt.load_params(FLOW_PARAMS) == 33800
    assert_rel(pt.predict(x), ref)


def test_e2vid_committed_weights_four_windows(gen):
    kwargs = convert.read_model_json_npz(RECON_PARAMS)
    assert kwargs == {"recurrent_levels": 3, "num_res_blocks": 2}
    x = np.abs(voxels(gen, (4, 1, 10, 128, 128)))
    pt = P.training.ReconstructionTrainer(sensor_size=(128, 128),
                                          model_kwargs=kwargs, device="cpu")
    assert pt.load_params(RECON_PARAMS) == 28200
    got, state = pt.reconstruct(x)
    # the JAX trainer's reconstruct: a scan of apply from a zero state
    step = jax.jit(jnet.E2VID(**kwargs).apply)
    params = flax_params_npz(RECON_PARAMS)
    ref_state = tuple(jnp.zeros((1, h, w, c)) for (_, c, h, w)
                      in pt.model.state_shapes(1, 128, 128))
    ref = []
    for vox in x:
        img, ref_state = step(params, jnp.asarray(vox), ref_state)
        ref.append(np.asarray(img))
    ref = np.stack(ref)
    assert_rel(got, ref)
    for a, b in zip(ref_state, state):
        assert_rel(b, np.transpose(np.asarray(a), (0, 3, 1, 2)))
    # the state threads across calls: two halves give the whole sequence
    first, mid = pt.reconstruct(x[:2])
    second, _ = pt.reconstruct(x[2:], state=mid)
    assert_rel(torch.cat([first, second]), ref)


# ---------------------------------------------------------------------------
# Traps: padding, upsampling, shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,stride,pads", [(8, 2, (0, 1)), (7, 2, (1, 1)),
                                           (8, 1, (1, 1)), (1, 2, (1, 1))])
def test_same_padding_is_flax_padding(n, stride, pads):
    assert pnet._same_pads(n, 3, stride) == pads


def test_symmetric_stride2_padding_breaks_parity(narrow_flow, monkeypatch):
    """``padding=1`` on the stride-2 convolutions (nn.Conv2d's habit)
    shifts every output by a pixel: the parity test must catch it."""
    pm, x, ref = narrow_flow
    monkeypatch.setattr(pnet, "_same_pads", lambda n, k, s: (1, 1))
    err = float(np.abs(pm(torch.as_tensor(x)).detach().numpy() - ref).max())
    assert err > 100 * REL * float(np.abs(ref).max())


@pytest.mark.parametrize("shape", [(1, 3, 1, 1), (2, 4, 3, 5), (1, 2, 8, 8)])
def test_upsampling_matches_jax_resize_at_the_borders(gen, shape):
    x = voxels(gen, shape)
    B, C, H, W = shape
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (B, C, 2 * H, 2 * W),
                                      "bilinear"))
    got = pnet._upsample2x(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    for edge in (got[..., 0, :], got[..., -1, :], got[..., :, 0],
                 got[..., :, -1]):
        assert np.isfinite(edge).all()


@pytest.mark.parametrize("model", ["EVFlowNet", "E2VID"])
@pytest.mark.parametrize("hw", [(30, 32), (32, 36), (33, 33)])
def test_odd_size_raises_configuration_error(model, hw):
    x = torch.zeros((1, 10) + hw)
    with pytest.raises(ConfigurationError):
        getattr(pnet, model)(10, base_features=8)(x)
    jm = getattr(jnet, model)(base_features=8)
    with pytest.raises(ValueError):  # the JAX package's ConfigurationError
        jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 10) + hw))


def test_e2vid_recurrent_levels_out_of_range():
    with pytest.raises(ConfigurationError):
        pnet.E2VID(10, recurrent_levels=4)


def test_random_init_is_seeded_lecun_normal():
    a = pnet.EVFlowNet(10, seed=1)
    b = pnet.EVFlowNet(10, seed=1)
    c = pnet.EVFlowNet(10, seed=2)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb)
        if name.endswith("bias"):
            assert not pa.detach().any()
        else:
            assert not torch.equal(pa, pc)
    w = a.Conv_0.weight  # 128 x 128 x 3 x 3: fan_in 1152
    assert abs(float(w.detach().std()) - (1 / 1152) ** 0.5) < 0.05 * (1 / 1152) ** 0.5


# ---------------------------------------------------------------------------
# The converter
# ---------------------------------------------------------------------------

def _flow_weights():
    with np.load(FLOW_PARAMS) as z:
        return {k: z[k] for k in z.files if not k.startswith("__")}


def test_converter_maps_every_committed_key():
    for path, model in ((FLOW_PARAMS, pnet.EVFlowNet(10)),
                        (RECON_PARAMS, pnet.E2VID(
                            10, recurrent_levels=3, num_res_blocks=2))):
        with np.load(path) as z:
            keys = [k for k in z.files if not k.startswith("__")]
        names = {convert.flax_key_to_name(k)[0] for k in keys}
        assert names == set(model.state_dict())
    assert convert.flax_key_to_name(
        "['params']['_Encoder_0']['Conv_1']['kernel']") == (
        "_Encoder_0.Conv_1.weight", True)


def test_converter_transposes_hwio_to_oihw():
    flat_w = _flow_weights()
    key = "['params']['_Encoder_0']['Conv_0']['kernel']"
    state = convert.convert_flax_params({key: flat_w[key]})
    w = state["_Encoder_0.Conv_0.weight"]
    assert tuple(w.shape) == (32, 10, 3, 3)
    np.testing.assert_array_equal(w[5, 2].numpy(), flat_w[key][:, :, 2, 5])


@pytest.mark.parametrize("fault", ["missing", "surplus", "shape", "name"])
def test_converter_rejects_wrong_or_missing_keys(fault):
    w = _flow_weights()
    if fault == "missing":
        del w["['params']['Conv_0']['bias']"]
    elif fault == "surplus":
        w["['params']['Conv_9']['bias']"] = np.zeros(4, np.float32)
    elif fault == "shape":
        w["['params']['Conv_0']['bias']"] = np.zeros(64, np.float32)
    else:
        w["['params']['Conv_0']['scale']"] = np.zeros(128, np.float32)
    model = pnet.EVFlowNet(10)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(DataFormatError):
        convert.load_flax_params(model, w)
    for k, v in model.state_dict().items():  # nothing was loaded
        assert torch.equal(v, before[k])


def test_load_params_npz_checks_the_architecture(tmp_path):
    with pytest.raises(DataFormatError):
        convert.load_params_npz(pnet.E2VID(10), RECON_PARAMS, {})
    # a snapshot for another architecture has other keys too
    with pytest.raises(DataFormatError):
        convert.load_params_npz(pnet.E2VID(10), RECON_PARAMS)
    path = tmp_path / "p.npz"
    arrays = dict(_flow_weights())
    arrays["__step__"] = np.asarray(7, np.int64)
    arrays["__model_json__"] = np.frombuffer(json.dumps({}).encode(),
                                             np.uint8)
    np.savez(path, **arrays)
    assert convert.read_model_json_npz(str(path)) == {}
    assert convert.load_params_npz(pnet.EVFlowNet(10), str(path), {}) == 7
