"""The port's AdamW and learning-rate schedules against optax.

AdamW: 5 steps of ``optax.adamw(mu_dtype=bfloat16, weight_decay=0.01)``
(the texture stage's D optimizer; G's has no decay) from the same
parameters and the same seeded gradients.  Both sides run the same float32
arithmetic in the same order, with the bias corrections in float32, so the
parameters and second moments agree to 2 float32 ulps (2.4e-7 relative) and
the bf16 first moments to one bf16 ulp.
Schedules: constant, linear and cosine, with and without warm-up, at
every step of the horizon and past it, to 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from swapnet_tpu.training.optimizers import OptimizerConfig as JaxOptCfg
from swapnet_tpu.training.optimizers import define_optimizer
from swapnet_tpu.training.optimizers import make_lr as jax_make_lr
from swapnet_tpu_torch.training.optimizers import AdamW, OptimizerConfig, make_lr

F32_REL = 2.4e-7
BF16_ULP = 2.0 ** -7
SHAPES = {"w": (4, 3, 3, 3), "b": (4,), "tiny": (7,)}


@pytest.mark.parametrize("kw", [
    dict(lr=4e-4, weight_decay=0.01),
    dict(lr=1e-4),
    dict(lr=1e-3, weight_decay=0.01, mu_dtype="float32"),
    dict(lr=2e-4, weight_decay=0.01, lr_policy="cosine", warmup_steps=2, decay_steps=6),
], ids=["D", "G", "mu_f32", "warmup_cosine"])
def test_adamw_matches_optax(kw):
    rng = np.random.RandomState(0)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    tx = define_optimizer(JaxOptCfg(**kw))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    tparams = [torch.from_numpy(params[k].copy()) for k in SHAPES]
    opt = AdamW(tparams, OptimizerConfig(**kw))
    for step in range(5):
        grads = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
        grads["tiny"] *= np.float32(1e-9)  # gradients near eps
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step([torch.from_numpy(grads[k]) for k in SHAPES])
        adam = jstate[0]
        for i, k in enumerate(SHAPES):
            ref = np.asarray(jparams[k])
            np.testing.assert_allclose(tparams[i].numpy(), ref, rtol=F32_REL, atol=0,
                                       err_msg=f"{k} after step {step + 1}")
            np.testing.assert_allclose(opt.nu[i].numpy(), np.asarray(adam.nu[k]), rtol=F32_REL,
                                       atol=0)
            mu_ref = np.asarray(adam.mu[k]).astype(np.float32)
            assert opt.mu[i].dtype == getattr(torch, kw.get("mu_dtype", "bfloat16"))
            assert np.all(np.abs(opt.mu[i].float().numpy() - mu_ref)
                          <= BF16_ULP * np.abs(mu_ref))
    assert opt.count == 5


def test_adamw_treats_a_missing_gradient_as_zero():
    p = torch.ones(3)
    opt = AdamW([p], OptimizerConfig(lr=0.1, weight_decay=0.5))
    opt.step([None])
    torch.testing.assert_close(p, torch.full((3,), 0.95))  # decay only: 1 - 0.1 * 0.5


@pytest.mark.parametrize("kw", [
    dict(),
    dict(warmup_steps=3),
    dict(lr_policy="linear", decay_steps=10),
    dict(lr_policy="linear", warmup_steps=4, decay_steps=10),
    dict(lr_policy="cosine", decay_steps=10),
    dict(lr_policy="cosine", warmup_steps=3, decay_steps=12),
    dict(lr_policy="cosine", warmup_steps=3),
])
def test_schedules_match_optax(kw):
    ref, got = jax_make_lr(JaxOptCfg(lr=3e-4, **kw)), make_lr(OptimizerConfig(lr=3e-4, **kw))
    if not callable(ref):
        assert got == ref
        return
    for t in range(16):
        r = float(ref(t))
        assert abs(got(t) - r) <= 1e-6 * max(abs(r), 1e-12), (t, got(t), r)
