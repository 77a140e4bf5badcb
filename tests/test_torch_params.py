"""Parity of the PyTorch port's transforms and parameter containers with the
JAX package (float64, CPU)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gparml_tpu.models import params as JP  # noqa: E402
from gparml_tpu.utils import transforms as JT  # noqa: E402
from gparml_tpu_torch.models import params as TP  # noqa: E402
from gparml_tpu_torch.utils import transforms as TT  # noqa: E402

torch.set_num_threads(2)

LEAF_NAMES = ["glob.z", "glob.u_sf2", "glob.u_alpha", "glob.u_beta", "lat.mu", "lat.u_s"]


def _jax_params(rng, n=9, q=3, m=4):
    glob = JP.make_global(rng.standard_normal((m, q)), 1.3,
                          rng.uniform(0.3, 2.0, q), 2.1)
    lat = JP.make_latents(rng.standard_normal((n, q)), rng.uniform(0.2, 1.5, (n, q)))
    return JP.GPLVMParams(glob=glob, lat=lat)


@pytest.mark.parametrize("name", ["exp", "softplus"])
def test_bijector_forward_inverse(name):
    x = np.linspace(-6.0, 6.0, 25)
    y = np.linspace(1e-3, 9.0, 25)
    tb, jb = TT.get(name), JT.get(name)
    np.testing.assert_allclose(tb.forward(torch.tensor(x)).numpy(),
                               np.asarray(jb.forward(jnp.asarray(x))), rtol=1e-12)
    np.testing.assert_allclose(tb.inverse(torch.tensor(y)).numpy(),
                               np.asarray(jb.inverse(jnp.asarray(y))), rtol=1e-12)
    np.testing.assert_allclose(tb.forward(tb.inverse(torch.tensor(y))).numpy(), y,
                               rtol=1e-12)


def test_unknown_bijector_raises():
    with pytest.raises(ValueError, match="unknown bijector"):
        TT.get("sigmoid")


def test_named_parameters_carry_jax_paths(rng):
    p = TP.from_numpy(jax.tree.map(np.asarray, _jax_params(rng)), device="cpu")
    assert [n for n, _ in p.named_parameters()] == LEAF_NAMES
    assert all(t.requires_grad for t in p.parameters())


def test_from_numpy_to_numpy_round_trip(rng):
    jp = jax.tree.map(np.asarray, _jax_params(rng))
    back = TP.to_numpy(TP.from_numpy(jp, device="cpu", dtype=torch.float64))
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tuple(back))):
        np.testing.assert_array_equal(a, b)
    # the numpy mirror rebuilds the JAX pytree field for field
    rebuilt = JP.GPLVMParams(JP.GlobalParams(*back.glob), JP.LatentParams(*back.lat))
    assert jax.tree.structure(rebuilt) == jax.tree.structure(jp)


@pytest.mark.parametrize("bijector", ["exp", "softplus"])
def test_constrain_matches_jax(rng, bijector):
    jp = _jax_params(rng)
    p = TP.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    for a, b in zip(TP.constrain(p.glob, bijector), JP.constrain(jp.glob, bijector)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-12)
    for a, b in zip(TP.constrain_latents(p.lat, bijector),
                    JP.constrain_latents(jp.lat, bijector)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-12)


def test_make_global_and_latents_match_jax(rng):
    z, mu = rng.standard_normal((4, 2)), rng.standard_normal((7, 2))
    s, alpha = rng.uniform(0.2, 1.0, (7, 2)), rng.uniform(0.5, 2.0, 2)
    tg = TP.make_global(torch.tensor(z), 1.7, torch.tensor(alpha), 3.0)
    jg = JP.make_global(z, 1.7, alpha, 3.0)
    tl = TP.make_latents(torch.tensor(mu), torch.tensor(s))
    jl = JP.make_latents(mu, s)
    for a, b in zip(TP.leaves(tg) + TP.leaves(tl), jax.tree.leaves((jg, jl))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)


@pytest.mark.parametrize("flags", [
    {}, {"fixed_beta": True}, {"fixed_embeddings": True}, {"fixed_z": True},
    {"fixed_hypers": True}, {"fixed_beta": True, "fixed_z": True},
])
def test_grad_mask_matches_jax(rng, flags):
    jp = _jax_params(rng)
    p = TP.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    got = TP.grad_mask(p, **flags)
    want = jax.tree.leaves(JP.grad_mask(jp, **flags))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    masked = TP.apply_mask(TP.leaves(p), got)
    for a, b in zip(masked, jax.tree.leaves(JP.apply_mask(jp, JP.grad_mask(jp, **flags)))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)


def test_tree_ops_match_jax(rng):
    ja, jb = _jax_params(rng), _jax_params(rng)
    ta = TP.leaves(TP.from_numpy(jax.tree.map(np.asarray, ja), device="cpu"))
    tb = TP.leaves(TP.from_numpy(jax.tree.map(np.asarray, jb), device="cpu"))
    np.testing.assert_allclose(float(TP.tree_dot(ta, tb)), float(JP.tree_dot(ja, jb)),
                               rtol=1e-12)
    for got, want in ((TP.tree_axpy(0.7, ta, tb), JP.tree_axpy(0.7, ja, jb)),
                      (TP.tree_scale(-1.5, ta), JP.tree_scale(-1.5, ja)),
                      (TP.tree_neg(ta), JP.tree_neg(ja))):
        for a, b in zip(got, jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)


def test_from_leaves_inverts_leaves(rng):
    p = TP.from_numpy(jax.tree.map(np.asarray, _jax_params(rng)), device="cpu")
    q = TP.from_leaves(TP.leaves(p))
    assert isinstance(q, TP.GPLVMParams)
    assert isinstance(TP.from_leaves(TP.leaves(p.glob)), TP.GlobalParams)
    for a, b in zip(TP.leaves(p), TP.leaves(q)):
        assert a.data_ptr() == b.data_ptr()


def test_qn_layout_not_ported():
    """The qn layout is ported now: make_latents stores (Q, N) leaves like
    the JAX package's, constrain_latents gives (N, Q) views or, native,
    the (Q, N) storage; a layout that neither package has raises."""
    mu, s = np.arange(6.0).reshape(3, 2), np.full((3, 2), 0.7)
    tl = TP.make_latents(torch.tensor(mu), torch.tensor(s), layout="qn")
    jl = JP.make_latents(mu, s, layout="qn")
    for a, b in zip(TP.leaves(tl), jax.tree.leaves(jl)):
        assert tuple(a.shape) == (2, 3) and a.is_contiguous()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
    for native in (False, True):
        for a, b in zip(TP.constrain_latents(tl, "exp", "qn", native=native),
                        JP.constrain_latents(jl, "exp", "qn", native=native)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-12)
    with pytest.raises(ValueError, match="layout"):
        TP.make_latents(torch.zeros(3, 2), torch.ones(3, 2), layout="nd")


def test_from_numpy_defaults_to_the_gpu(rng, monkeypatch):
    """Without a card the default device raises rather than give CPU
    tensors; device="cpu" asks for them."""
    arrays = jax.tree.map(np.asarray, _jax_params(rng))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.from_numpy(arrays)
    p = TP.from_numpy(arrays, device="cpu")
    assert all(t.device.type == "cpu" for t in p.parameters())


def test_from_numpy_keeps_qn_leaves(rng):
    """A qn checkpoint's (Q, N) latent leaves cross unchanged both ways."""
    jp = JP.GPLVMParams(
        glob=_jax_params(rng).glob,
        lat=JP.make_latents(rng.standard_normal((9, 3)), rng.uniform(0.2, 1.5, (9, 3)),
                            layout="qn"))
    arrays = jax.tree.map(np.asarray, jp)
    p = TP.from_numpy(arrays, device="cpu")
    assert tuple(p.lat.mu.shape) == (3, 9) and tuple(p.lat.u_s.shape) == (3, 9)
    for a, b in zip(jax.tree.leaves(arrays), jax.tree.leaves(tuple(TP.to_numpy(p)))):
        np.testing.assert_array_equal(a, b)
