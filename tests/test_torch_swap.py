"""The port's serving path against the JAX package's, from checkpoint dirs.

The checkpoint directories are written by the JAX package's own
``utils.checkpoint.save_checkpoint`` with the ``args.json`` of
``tests/test_serving.py``; the generator weights are seeded numpy draws in
the shapes the JAX modules declare (an optimizer-backed ``init_state`` of
the 137 M-parameter warp stage costs ~20 s on the CPU and adds nothing the
generator files need).  Both ``build_fused_swap``s read them in float32 on
the CPU.

Rules, as for any two frameworks with an argmax between the stages:
  * warp logits agree within 1e-4 (float32, ~20 convs, tanh-bounded);
  * fed the same one-hot, the texture stages agree within 1e-4;
  * the uint8 swap agrees within one level at every pixel whose warp argmax
    agrees; the pixels whose argmax flips (near-ties) are counted and may
    be at most 0.1% of the labels.

Also the port's stdlib msgpack reader and writer against flax's.
"""

import json
import shutil

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swapnet_tpu.models.texture import TextureModule as JaxTexture
from swapnet_tpu.models.warp import WarpModule as JaxWarp
from swapnet_tpu.serving import SwapService as JaxService
from swapnet_tpu.serving import build_fused_swap as jax_build
from swapnet_tpu.training.state import GANTrainState
from swapnet_tpu.utils import checkpoint as jax_ckpt
from swapnet_tpu_torch.serving import SwapService, build_fused_swap
from swapnet_tpu_torch.utils import checkpoint as port_ckpt

SIZE = 64
B = 1
TOL = 1e-4
MAX_FLIP_SHARE = 1e-3
STATS = (([0.5] * 3, [0.25] * 3), ([0.5] * 3, [0.25] * 3))


def _draw(module, seed, *args):
    rng = np.random.default_rng(seed)

    def draw(path, s):
        if path[-1].key == "kernel":
            scale = np.sqrt(2.0 / np.prod(s.shape[:-1]))
            return rng.standard_normal(s.shape, dtype=np.float32) * np.float32(scale)
        return (0.1 * rng.standard_normal(s.shape, dtype=np.float32)).astype(np.float32)

    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args, False))
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _save(directory, variables, args):
    directory.mkdir()
    state = GANTrainState.create(
        jax.random.key(0), variables["params"], {},
        {k: v for k, v in variables.items() if k != "params"})
    jax_ckpt.save_checkpoint(state, str(directory), "latest")
    (directory / "args.json").write_text(json.dumps(args))
    return str(directory)


@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory):
    """The two checkpoint directories (~670 MB), removed when the module
    ends so the suite's temporary disk does not keep them."""
    root = tmp_path_factory.mktemp("torch_swap_ckpts")
    z = lambda c: jnp.zeros((1, SIZE, SIZE, c))
    warp = _draw(JaxWarp(), 0, z(3), z(19))
    tex = _draw(JaxTexture(img_size=SIZE, norm_type="instance"), 1,
                z(3), jnp.zeros((1, 12, 4)), z(19))
    warp_dir = _save(root / "warp", warp, {
        "body_representation": "rgb", "cloth_representation": "labels",
        "body_channels": 12, "cloth_channels": 19})
    tex_dir = _save(root / "texture", tex, {
        "texture_channels": 3, "cloth_channels": 19, "body_channels": 12,
        "crop_size": SIZE, "norm": "instance"})
    yield warp_dir, tex_dir
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def services(ckpt_dirs):
    jfused, _ = jax_build(*ckpt_dirs, dtype=jnp.float32)
    pfused, _ = build_fused_swap(*ckpt_dirs, dtype=torch.float32, device="cpu")
    # both services now hold the weights: free the 550 MB warp checkpoint
    shutil.rmtree(ckpt_dirs[0])
    return JaxService(jfused, *STATS), SwapService(pfused, *STATS)


@pytest.fixture(scope="module")
def request_batch():
    r = np.random.RandomState(2)
    x1 = r.uniform(0, SIZE / 2, (B, 12))
    y1 = r.uniform(0, SIZE / 2, (B, 12))
    rois = np.stack([x1, y1, x1 + r.uniform(4, SIZE / 2, (B, 12)),
                     y1 + r.uniform(4, SIZE / 2, (B, 12))], -1).astype(np.float32)
    return (r.randint(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8),
            r.randint(0, 19, (B, SIZE, SIZE)).astype(np.uint8),
            r.randint(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8),
            rois)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(x), (0, 3, 1, 2))))


def test_fused_swap_matches_jax(services, request_batch):
    jsvc, psvc = services
    body_u8, labels, tex_u8, rois = request_batch
    # the stage inputs exactly as both services prepare them
    body = (body_u8.astype(np.float32) / 255.0 - 0.5) / 0.25
    tex = (tex_u8.astype(np.float32) / 255.0 - 0.5) / 0.25
    cloth = np.eye(19, dtype=np.float32)[labels]

    jf, pf = jsvc.fused, psvc.fused
    j_logits = np.asarray(jax.jit(jf.warp.apply, static_argnums=3)(
        jf.warp_variables, jnp.asarray(body), jnp.asarray(cloth), False))
    with torch.no_grad():
        p_logits = pf.warp(_nchw(body), _nchw(cloth)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(p_logits, j_logits, atol=TOL, rtol=0)

    onehot = np.eye(19, dtype=np.float32)[j_logits.argmax(-1)]
    j_tex = np.asarray(jax.jit(jf.texture.apply, static_argnums=4)(
        jf.texture_variables, jnp.asarray(tex), jnp.asarray(rois), jnp.asarray(onehot), False))
    with torch.no_grad():
        p_tex = pf.texture(_nchw(tex), torch.from_numpy(rois),
                           _nchw(onehot)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(p_tex, j_tex, atol=TOL, rtol=0)

    j_out = jsvc.swap(*request_batch)
    p_out = psvc.swap(*request_batch)
    assert p_out.shape == j_out.shape == (B, SIZE, SIZE, 3) and p_out.dtype == np.uint8
    flips = j_logits.argmax(-1) != p_logits.argmax(-1)
    print(f"argmax flips: {int(flips.sum())} of {flips.size} labels")
    assert flips.mean() <= MAX_FLIP_SHARE
    diff = np.abs(p_out.astype(np.int16) - j_out.astype(np.int16))
    assert diff[~flips].max() <= 1


def test_swap_async_stays_on_device(services, request_batch):
    out = services[1].swap_async(*request_batch)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.uint8
    assert tuple(out.shape) == (B, SIZE, SIZE, 3)


def test_build_fused_swap_checks_netG(tmp_path):
    for name, args in (("w", {}), ("t", {"netG": "unet_128"})):
        (tmp_path / name).mkdir()
        (tmp_path / name / "args.json").write_text(json.dumps(args))
    with pytest.raises(ValueError, match="netG"):
        build_fused_swap(str(tmp_path / "w"), str(tmp_path / "t"), device="cpu")


def test_msgpack_reader_matches_flax(ckpt_dirs):
    """On the texture checkpoint; the warp checkpoint is held to JAX through
    the fused swap above and freed once both services hold it."""
    d = ckpt_dirs[1]
    ours, extra = port_ckpt.load_generator_weights(d, "latest")
    assert extra is None  # instance norm: no stats file
    with open(f"{d}/latest_net_generator.msgpack", "rb") as f:
        ref = fser.msgpack_restore(f.read())
    flat_ours = jax.tree_util.tree_leaves_with_path(ours)
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    assert [p for p, _ in flat_ours] == [p for p, _ in flat_ref]
    for (_, a), (_, b) in zip(flat_ours, flat_ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _tree():
    rng = np.random.RandomState(3)
    return {
        "f32": rng.randn(3, 4).astype(np.float32),
        "nested": {f"k{i}": np.arange(i + 1, dtype=np.int32) for i in range(17)},
        "u8": np.arange(300, dtype=np.uint8).reshape(3, 100),
        "i64": np.array([-(2 ** 40), 5], np.int64),
        "f64": np.array(1.5),
        "bool": np.array([True, False]),
        "empty": np.zeros((0, 2), np.float32),
        "big": rng.randn(70000).astype(np.float32),
        "scalar": np.float32(2.5),
        "meta": {"name": "x" * 40, "ints": [0, 1, 127, 128, -1, -33, 2 ** 40, -(2 ** 40)] * 3,
                 "float": 0.25, "none": None, "flag": True, "raw": b"\x00\x01"},
    }


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (np.ndarray, np.generic)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert list(a) == list(b) if isinstance(a, (list, tuple)) else a == b


def test_msgpack_round_trip_and_flax_compat():
    tree = _tree()
    data = port_ckpt.packb(tree)
    _assert_tree_equal(port_ckpt.unpackb(data), tree)
    _assert_tree_equal(fser.msgpack_restore(data), tree)
    _assert_tree_equal(port_ckpt.unpackb(fser.msgpack_serialize(tree)), tree)


def test_msgpack_bf16_round_trip():
    t = torch.randn(5, 3, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    back = port_ckpt.unpackb(port_ckpt.packb({"w": t}))["w"]
    assert back.dtype == torch.bfloat16
    assert torch.equal(back, t)
    restored = fser.msgpack_restore(port_ckpt.packb({"w": t}))["w"]
    np.testing.assert_array_equal(np.asarray(restored, np.float32), t.float().numpy())


def test_msgpack_reads_flax_chunked_arrays(monkeypatch):
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    arr = np.arange(100, dtype=np.float32).reshape(10, 10)
    data = fser.msgpack_serialize({"a": arr})
    assert b"__msgpack_chunked_array__" in data
    np.testing.assert_array_equal(port_ckpt.unpackb(data)["a"], arr)


def test_generator_writer_read_by_jax_package(tmp_path):
    rng = np.random.RandomState(4)
    variables = {
        "params": {"Norm_0": {"BatchNorm_0": {"scale": rng.randn(4).astype(np.float32),
                                              "bias": rng.randn(4).astype(np.float32)}},
                   "Conv_0": {"kernel": rng.randn(4, 4, 3, 4).astype(np.float32)}},
        "batch_stats": {"Norm_0": {"BatchNorm_0": {"mean": rng.randn(4).astype(np.float32),
                                                   "var": rng.rand(4).astype(np.float32)}}},
    }
    port_ckpt.save_generator_weights(str(tmp_path), "latest", variables)
    params, extra = port_ckpt.load_generator_weights(str(tmp_path), "latest")
    _assert_tree_equal(params, variables["params"])
    _assert_tree_equal(extra, {"batch_stats": variables["batch_stats"]})
    template = jax.tree.map(np.zeros_like, variables)
    jp, jx = jax_ckpt.load_generator_weights(
        str(tmp_path), "latest", template["params"], {"batch_stats": template["batch_stats"]})
    _assert_tree_equal(jax.tree.map(np.asarray, jp), variables["params"])
    _assert_tree_equal(jax.tree.map(np.asarray, jx), {"batch_stats": variables["batch_stats"]})
