"""Port parity: madarch_tpu_torch/render/sampling.py against
madarch_tpu/render/sampling.py.

torch has no threefry stream, so each port sampler is a transform of
uniforms and a draw from a torch.Generator.  The transforms are fed the
very uniforms the JAX samplers draw (their key splits reproduced here)
and held to JAX's directions to 1e-6 (measured at most 2.7e-7: cos and sin
round apart between XLA and torch).  The draws are held statistically:
2^16 directions of each sampler meet the analytic moments within 4σ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madarch_tpu.render import sampling as JSa
from madarch_tpu_torch.render import sampling as TSa

N = 4096
ATOL = 1e-6


def _normals(n, seed):
    rng = np.random.RandomState(seed)
    v = rng.randn(n, 3).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    # the axes and the cosine basis's guarded pole n = (0, 0, -1)
    v[:6] = [[0, 0, -1], [0, 0, 1], [1, 0, 0], [0, 1, 0], [-1, 0, 0],
             [0, -1, 0]]
    return v


def _split_uniforms(key, shape):
    """The two uniforms a JAX sampler draws from ``key``."""
    k1, k2 = jax.random.split(key)
    return (torch.as_tensor(np.array(jax.random.uniform(k1, shape))),
            torch.as_tensor(np.array(jax.random.uniform(k2, shape))))


def test_sphere_point_equals_jax_on_its_uniforms():
    key = jax.random.PRNGKey(5)
    u1, u2 = _split_uniforms(key, (N,))
    ref = np.asarray(JSa.random_sphere_point(key, (N,)))
    np.testing.assert_allclose(TSa.sphere_point(u1, u2).numpy(), ref,
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        TSa.sphere_point(u1, u2).numpy(),
        np.asarray(JSa.uniform_vector(key, (N,))), atol=ATOL, rtol=0)


def test_hemisphere_point_equals_jax_on_its_uniforms():
    key = jax.random.PRNGKey(6)
    nrm = _normals(N, 1)
    u1, u2 = _split_uniforms(key, (N,))
    ref = np.asarray(JSa.random_hemisphere_point(key, jnp.asarray(nrm)))
    got = TSa.hemisphere_point(u1, u2, torch.as_tensor(nrm)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_hemisphere_point_keeps_a_tangent_point():
    """sign 0 -> 1: a point on the tangent plane is not flipped to 0."""
    u1 = torch.tensor([0.0])
    u2 = torch.tensor([0.5])                         # height 0: (1, 0, 0)
    n = torch.tensor([[0.0, 0.0, 1.0]])
    np.testing.assert_array_equal(TSa.hemisphere_point(u1, u2, n).numpy(),
                                  [[1.0, 0.0, 0.0]])


def test_cosine_point_equals_jax_on_its_uniforms():
    key = jax.random.PRNGKey(7)
    nrm = _normals(N, 2)
    u, v = _split_uniforms(key, (N,))
    ref = np.asarray(JSa.cosine_direction(key, jnp.asarray(nrm)))
    got = TSa.cosine_point(u, v, torch.as_tensor(nrm)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


M = 1 << 16
SIGMA = 4.0


def _moment(x, want):
    """|mean(x) − want| within 4σ of the sample mean."""
    x = x.double()
    se = float(x.std()) / np.sqrt(x.numel())
    assert abs(float(x.mean()) - want) <= SIGMA * se, (float(x.mean()),
                                                       want, se)


@pytest.fixture
def gen():
    return torch.Generator().manual_seed(12345)


def test_sphere_draws_are_uniform_on_the_sphere(gen):
    for v in (TSa.random_sphere_point(gen, (M,), "cpu"),
              TSa.uniform_vector(gen, (M,), "cpu")):
        assert v.shape == (M, 3)
        np.testing.assert_allclose(v.norm(dim=-1).numpy(), 1.0, atol=1e-5)
        for axis in range(3):
            _moment(v[:, axis], 0.0)
            _moment(v[:, axis] ** 2, 1.0 / 3.0)


def test_hemisphere_draws_are_uniform_on_the_hemisphere(gen):
    n = torch.as_tensor(_normals(M, 3))
    h = TSa.random_hemisphere_point(gen, n)
    np.testing.assert_allclose(h.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    cos = (h * n).sum(-1)
    assert float(cos.min()) >= 0.0
    _moment(cos, 0.5)
    _moment(cos ** 2, 1.0 / 3.0)


def _xy_normals(n, seed):
    """Unit normals with z = 0, where the reference's basis is
    orthonormal."""
    a = np.random.RandomState(seed).uniform(0.0, 2.0 * np.pi, n)
    return np.stack([np.cos(a), np.sin(a), np.zeros(n)],
                    axis=-1).astype(np.float32)


def test_cosine_draws_are_cosine_weighted(gen):
    """Cosine-weighted about normals with z = 0: E[n·d] = 2/3, E[(n·d)²] =
    1/2, none below the surface."""
    n = torch.as_tensor(_xy_normals(M, 4))
    c = TSa.cosine_direction(gen, n)
    np.testing.assert_allclose(c.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    cos = (c * n).sum(-1)
    assert float(cos.min()) >= -1e-6
    _moment(cos, 2.0 / 3.0)
    _moment(cos ** 2, 0.5)


def test_cosine_draws_keep_the_references_basis(gen):
    """The reference's basis divides only n.x² and n.y² by 1 + n.z (iq's
    divides the whole of tc), so it is orthonormal only where n.z = 0
    (ROADMAP C, kept on purpose).  At n = +z the draw is
    normalize(2·sqrt(u)·(cos a, sin a, 0) + sqrt(1 − u)·z): n·d =
    sqrt((1 − u)/(1 + 3u)), whose moments are integrated here; at n = −z
    the guarded basis is 0 and every draw is n itself; at a generic normal
    some draws fall below the surface, as the JAX package's do."""
    up = torch.tensor([0.0, 0.0, 1.0]).expand(M, 3)
    cos = (TSa.cosine_direction(gen, up) * up).sum(-1)
    u = (np.arange(1 << 20) + 0.5) / (1 << 20)
    ratio = (1.0 - u) / (1.0 + 3.0 * u)
    _moment(cos, float(np.sqrt(ratio).mean()))
    _moment(cos ** 2, float(ratio.mean()))
    down = torch.tensor([0.0, 0.0, -1.0]).expand(64, 3)
    assert torch.equal(TSa.cosine_direction(gen, down), down)
    n = torch.as_tensor(_normals(M, 8))
    below = float(((TSa.cosine_direction(gen, n) * n).sum(-1) < 0.0)
                  .float().mean())
    assert 0.0 < below < 0.1


def test_draws_follow_the_generator():
    """The same seed draws the same directions, another seed others; the
    draws run on the generator's device and land on the normals'."""
    n = torch.as_tensor(_normals(64, 5))
    a = TSa.cosine_direction(torch.Generator().manual_seed(1), n)
    b = TSa.cosine_direction(torch.Generator().manual_seed(1), n)
    c = TSa.cosine_direction(torch.Generator().manual_seed(2), n)
    assert torch.equal(a, b) and not torch.equal(a, c)
    g = torch.Generator().manual_seed(3)
    u = TSa.uniform(g, (5,), "cpu")
    assert u.dtype == torch.float32 and float(u.min()) >= 0.0 \
        and float(u.max()) < 1.0
    torch.manual_seed(4)
    d1 = TSa.random_sphere_point(None, (8,), "cpu")
    torch.manual_seed(4)
    assert torch.equal(d1, TSa.random_sphere_point(None, (8,), "cpu"))
