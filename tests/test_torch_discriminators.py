"""The port's PatchGAN discriminator against the JAX package's.

``define_D`` at 32^2 with 22 input channels (19 cloth + 3 RGB), train mode,
float32, from one set of JAX variables carried into the port by the bridge:
the logit map and the gradients of every parameter and of the input.
Tolerance: 1e-5 of each compared tensor's largest magnitude (five convs,
float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swapnet_tpu.models.discriminators import define_D as jax_define_D
from swapnet_tpu_torch.models.discriminators import define_D
from swapnet_tpu_torch.utils.from_jax import jax_variables_from_module, load_from_jax

REL = 1e-5
IN_CH, SIZE, B = 22, 32, 2


def _close(name, got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, name
    err = np.abs(got - ref).max()
    assert err <= REL * max(1.0, np.abs(ref).max()), (name, err)


@pytest.mark.parametrize("netD,n_layers,norm", [("basic", 3, "instance"),
                                                ("n_layers", 2, "instance"),
                                                ("basic", 3, "batch")])
def test_output_and_gradients_match_jax(netD, n_layers, norm):
    rng = np.random.RandomState(0)
    x = rng.randn(B, SIZE, SIZE, IN_CH).astype(np.float32)
    jd = jax_define_D(netD, 64, n_layers, norm)
    variables = jd.init(jax.random.key(1), jnp.zeros((1, SIZE, SIZE, IN_CH)), True)
    mutable = ["batch_stats"] if norm == "batch" else False

    def f(params, x_):
        out = jd.apply({**variables, "params": params}, x_, True, mutable=mutable)
        return out[0] if mutable else out

    y_ref, vjp = jax.vjp(f, variables["params"], jnp.asarray(x))
    cot = rng.randn(*y_ref.shape).astype(np.float32)
    dparams_ref, dx_ref = vjp(jnp.asarray(cot))

    d = load_from_jax(define_D(IN_CH, netD, 64, n_layers, norm), variables).train()
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    y = d(xt)
    y.backward(torch.from_numpy(cot.transpose(0, 3, 1, 2).copy()))
    _close("logits", y.detach().permute(0, 2, 3, 1), y_ref)
    _close("dx", xt.grad.permute(0, 2, 3, 1), dx_ref)

    for p in d.parameters():  # the gradients in the JAX layout, via the bridge
        p.data = p.grad
    grads = jax_variables_from_module(d)["params"]
    ref = jax.tree_util.tree_flatten_with_path(dparams_ref)[0]
    assert len(ref) == len(jax.tree.leaves(grads))
    for path, leaf in ref:
        node = grads
        for k in path:
            node = node[k.key]
        _close(jax.tree_util.keystr(path), node, leaf)


def test_parameter_count_of_the_published_width():
    """ndf 64, n_layers 3, instance norm, 22 input channels."""
    d = define_D(IN_CH)
    assert sum(p.numel() for p in d.parameters()) == 2_784_193
    with pytest.raises(NotImplementedError):
        define_D(IN_CH, "pixel")
