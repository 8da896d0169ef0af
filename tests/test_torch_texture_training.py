"""The texture-stage GAN train step of the port against the JAX package's.

``TextureSystem`` at 32^2, batch 2, float32, fixed GAN labels
(``smooth_labels=False``); at 32^2 the U-Net has 5 levels and no dropout
level, so neither side draws a random number.  The port's state carries the
JAX ``init_state``'s weights (G, D and the frozen VGG) across the bridge;
both optimizers start from zero moments.  The JAX system runs its defaults
(width-packed VGG block 1, split first U-Net conv); the port runs the plain
forms of the same functions.

Tolerances.  Adam moves each element by about lr * g / (|g| + eps) whatever
the size of g, so an element whose gradient is round-off (|g| near the
float32 error of its sum) moves by +-lr with a sign that differs between
the frameworks, and every later step sees the difference.  Conv biases
ahead of an instance norm (G's down_1..3 and up_1..4, D's Conv_1..3) have a
true gradient of 0 and are all of that kind.  So:
  * after 1 step: metrics within 1e-5 relative; every element within its
    first-step bound, 2 lr (1 + wd |p|); elements other than those biases
    beyond 1e-2 lr at most a share of 3e-4 (measured: 3e-5).
  * after 3 steps: metrics within 1e-3 relative (measured: 5.6e-5 at
    worst); the median element within 1e-2 lr and at most a share of 1e-2
    beyond lr / 2 (measured: 1.8e-3 lr and 1.4e-3).
"""

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _texture_batch
from swapnet_tpu.losses import GANLossConfig as JaxGANCfg
from swapnet_tpu.training import TextureSystem as JaxTextureSystem
from swapnet_tpu_torch.losses.gan import GANLossConfig
from swapnet_tpu_torch.training.texture_system import TextureSystem
from swapnet_tpu_torch.utils.from_jax import jax_variables_from_module, texture_state_from_jax

SIZE, B, STEPS = 32, 2, 3
METRICS = ("loss_D", "loss_D_fake", "loss_D_real", "loss_G", "loss_G_gan", "loss_G_l1",
           "loss_G_content", "loss_G_style")
METRIC_REL = {1: 1e-5, STEPS: 1e-3}
LR = {"G": 1e-4, "D": 4e-4}


def _torch_batch(batch):
    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))

    return {"input_textures": nchw(batch["input_textures"]),
            "rois": torch.from_numpy(np.array(batch["rois"])),
            "cloths": nchw(batch["cloths"]), "target_textures": nchw(batch["target_textures"])}


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.fixture(scope="module")
def trajectories():
    batch = _texture_batch(B, SIZE)
    jsys = JaxTextureSystem(img_size=SIZE, gan_cfg=JaxGANCfg(smooth_labels=False))
    jstate = jsys.init_state(jax.random.key(0), batch)
    start = {"G": _numpy_tree(jstate.g_params), "D": _numpy_tree(jstate.d_params)}
    psys = TextureSystem(img_size=SIZE, gan_cfg=GANLossConfig(smooth_labels=False),
                         device="cpu")
    pstate = texture_state_from_jax(psys, start["G"], start["D"],
                                    _numpy_tree(jstate.frozen["vgg"]))
    tbatch = _torch_batch(batch)
    step = jax.jit(jsys.train_step)
    out = {"start": start}
    for i in range(1, STEPS + 1):
        jstate, jm = step(jstate, batch)
        pstate, pm = psys.train_step(pstate, tbatch)
        out[i] = {
            "jax": ({k: float(v) for k, v in jm.items()},
                    {"G": _numpy_tree(jstate.g_params), "D": _numpy_tree(jstate.d_params)}),
            "port": ({k: v.item() for k, v in pm.items()},
                     {"G": jax_variables_from_module(pstate.G)["params"],
                      "D": jax_variables_from_module(pstate.D)["params"]}),
        }
    return out


def _mean_free_bias(net, path):
    """Conv biases whose output goes straight into an instance norm."""
    if not path.endswith("/bias"):
        return False
    layer = path.split("/")[-2]
    if net == "D":
        return layer in ("Conv_1", "Conv_2", "Conv_3")
    return layer in ("down_1", "down_2", "down_3", "up_1", "up_2", "up_3", "up_4")


@pytest.mark.parametrize("step", [1, STEPS])
def test_metrics_match_jax(trajectories, step):
    jm, pm = trajectories[step]["jax"][0], trajectories[step]["port"][0]
    assert sorted(jm) == sorted(pm) == sorted(METRICS)
    for k in METRICS:
        assert abs(pm[k] - jm[k]) <= METRIC_REL[step] * max(1.0, abs(jm[k])), (k, pm[k], jm[k])


@pytest.mark.parametrize("net", ["G", "D"])
@pytest.mark.parametrize("step", [1, STEPS])
def test_parameters_match_jax(trajectories, step, net):
    ref = _flat(trajectories[step]["jax"][1][net])
    got = _flat(trajectories[step]["port"][1][net])
    start = _flat(trajectories["start"][net])
    assert sorted(ref) == sorted(got)
    lr, wd = LR[net], (0.01 if net == "D" else 0.0)
    errs, signal, moved = [], [], 0
    for path in ref:
        err = np.abs(got[path] - ref[path]) / lr
        errs.append(err.ravel())
        if not _mean_free_bias(net, path):
            signal.append(err.ravel())
        moved += int((np.abs(ref[path] - start[path]) > 0.1 * lr).sum())
        if step == 1:
            bound = 2 * (1 + wd * np.abs(start[path])) + 1e-6 / lr
            assert np.all(err <= bound), (path, err.max())
    errs, signal = np.concatenate(errs), np.concatenate(signal)
    if step == 1:
        assert (signal > 1e-2).mean() <= 3e-4, (signal > 1e-2).mean()
    else:
        assert np.median(errs) <= 1e-2 and (errs > 0.5).mean() <= 1e-2, (
            np.median(errs), (errs > 0.5).mean())
    assert moved > 0.5 * errs.size  # the steps really moved the parameters

def test_repeated_steps_are_deterministic_and_leave_the_global_rng_alone():
    """Dropout (the 64^2 U-Net has one dropout level) and smooth labels draw
    from the state's generator only: the same seed gives the same step, a
    different seed another, and torch's global RNG state is not touched."""
    batch = _torch_batch(_texture_batch(1, 64))

    def run(seed):
        system = TextureSystem(img_size=64, lambda_content=0.0, lambda_style=0.0, device="cpu")
        state = system.init_state(seed)
        assert any(len(getattr(m, "dropouts", {})) for m in state.G.modules())
        before = torch.get_rng_state()
        for _ in range(2):
            state, metrics = system.train_step(state, batch)
        assert torch.equal(before, torch.get_rng_state())
        return ({k: v.item() for k, v in metrics.items()},
                [p.detach().clone() for p in state.G.parameters()])

    state = TextureSystem(img_size=64, device="cpu").init_state(0)
    with pytest.raises(ValueError, match="Generator"):  # never the global RNG
        state.G.train()(batch["input_textures"], batch["rois"], batch["cloths"])
    (m1, p1), (m2, p2) = run(0), run(0)
    assert m1 == m2
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    system = TextureSystem(img_size=64, lambda_content=0.0, lambda_style=0.0, device="cpu")
    state = system.init_state(0)
    state.rng.manual_seed(1)  # same weights, other dropout masks and labels
    state, m3 = system.train_step(state, batch)
    state0 = system.init_state(0)
    _, m0 = system.train_step(state0, batch)
    assert m3["loss_G"] != m0["loss_G"] and m3["loss_D"] != m0["loss_D"]
