"""The port's float resnets (UNet and VAE) and ``nearest_up_conv2d`` take
the JAX package's route at shapes its slab plan refuses: GroupNorm (two
passes) -> SiLU -> conv2d instead of the slab kernel, with no moments.

Held against the JAX package's ``conv_impl="gemm"`` program in float32 on
the CPU, inputs from a numpy seed.  One case puts every group's mean far
above its spread (1000 +- 0.01): the slab kernel's one-pass variance
E[x^2] - mean^2 cancels there and gives NaN in both packages
(``test_torch_kernels.py::test_slab_group_stats_cancel_at_large_mean_as_in_the_jax_kernel``),
so the results are finite only on the op path.  Tolerance: 1e-5 relative
plus 1e-5 of the output's scale, as in ``test_torch_models.py`` (the two
differ only in summation order).  At 1000 +- 0.01 the GroupNorm's inputs
are ill-conditioned: x - mean carries about half an f32 ulp of 1000
(3e-5) against a spread of 0.01, so a different summation order moves a
normalized value by up to ~1e-2 relative and a few outputs by ~2e-5 of
the output's scale.  There both must be finite and agree within 1e-5 in
relative L2 norm, and within 1e-4 of the scale elementwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdtpu.models.unet as junet
import sdtpu.models.vae as jvae
import sdtpu.ops.conv as jconvops
import sdtpu_torch.kernels.conv2d as tconv
import sdtpu_torch.models.unet as tunet
import sdtpu_torch.models.vae as tvae
import sdtpu_torch.ops.conv as tconvops
from sdtpu_torch.utils.quant import resnet_takes_slab, slab_plan_ok
from test_torch_ops import nn, port_params, tt

torch.set_num_threads(1)


def close_scaled(got, want, big):
    g, w = nn(got), nn(want)
    assert g.shape == w.shape
    assert np.isfinite(g).all() and np.isfinite(w).all()
    rtol = 1e-5
    if big:
        assert np.linalg.norm(g - w) <= rtol * np.linalg.norm(w)
        rtol = 1e-4
    np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * max(1.0, np.abs(w).max()))


def _input(rng, shape, big):
    if big:
        return (1000.0 + 0.01 * rng.normal(size=shape)).astype(np.float32)
    return (rng.normal(size=shape) * 1.5 + 0.3).astype(np.float32)


@pytest.mark.parametrize("what,c,hw,groups,big", [
    ("unet", 32, 8, 8, False),    # Ci = Co = 32 < 64
    ("unet", 32, 8, 8, True),
    ("unet", 64, 12, 32, False),  # H = W = 12, not a multiple of 8
    ("vae", 32, 8, 8, False),
    ("vae", 32, 8, 8, True),
    ("vae", 64, 12, 32, False),
    ("up", 64, 6, None, False),   # upsampled to 12 x 12
    ("up", 32, 4, None, False),   # Ci = 32
])
def test_refused_shapes_take_the_jax_op_route(rng, monkeypatch, what, c, hw, groups, big):
    """The port's function against the JAX package's at a shape the slab
    rule refuses; no slab kernel (nor its plain version) runs in the port."""
    ran = []
    real = tconv.conv3x3_slab_plain

    def spy(*a, **kw):
        ran.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tconv, "conv3x3_slab_plain", spy)
    x = _input(rng, (2, hw, hw, c), big)
    if what == "up":
        assert not slab_plan_ok((2, 2 * hw, 2 * hw, c), (3, 3, c, c))
        k = (rng.normal(size=(3, 3, c, c)) * (9 * c) ** -0.5).astype(np.float32)
        b = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
        got, st = tconvops.nearest_up_conv2d(tt(x), tt(k), tt(b), emit_stats=True)
        want, want_st = jconvops.nearest_up_conv2d(jnp.asarray(x), jnp.asarray(k),
                                                   jnp.asarray(b), impl="gemm",
                                                   emit_stats=True)
        assert st is None and want_st is None
    elif what == "unet":
        jp = junet._init_resnet(jax.random.key(3), c, c, 16, dtype=jnp.float32)
        tp = port_params(jp)
        assert not resnet_takes_slab(x.shape, tp, groups)
        temb = rng.normal(size=(2, 16)).astype(np.float32)
        got, st = tunet.resnet_block(tt(x), tt(temb), tp, num_groups=groups, emit_stats=True)
        want, want_st = junet.resnet_block(jnp.asarray(x), jnp.asarray(temb), jp,
                                           num_groups=groups, conv_impl="gemm",
                                           emit_stats=True)
        assert st is None and want_st is None
    else:
        jp = jvae._init_vae_resnet(jax.random.key(4), c, c, dtype=jnp.float32)
        tp = port_params(jp)
        assert not resnet_takes_slab(x.shape, tp, groups)
        got, st = tvae.vae_resnet(tt(x), tp, num_groups=groups, emit_stats=True)
        want, want_st = jvae.vae_resnet(jnp.asarray(x), jp, num_groups=groups,
                                        conv_impl="gemm", emit_stats=True)
        assert st is None and want_st is None
    assert ran == []
    close_scaled(got, want, big)
