"""The port's Snake (``nawc_tpu_torch/ops/snake.py``) against flax's
``Snake`` (``nawc_tpu/codec/layers.py``) and its ``jax.vjp`` on the CPU, and
the backward kernel's formula, ``snake_backward_reference``, against torch
autograd of the plain forward.  Inputs are made from a seed with numpy: x
at 2 sigma, log alpha at 0.3 sigma, the output gradient at 1 sigma.

Bars: the forward within 1e-6 in float32 (the bar of
``tests/test_torch_codec.py::test_sin2_polynomial_matches``) and bit for
bit in bfloat16; the backward formula against autograd within 1e-6 of the
largest |dx| and 1e-5 relative in d log_alpha (both sum the same terms in
another order), against JAX's vjp within 1e-5 and 1e-4; in bfloat16 within
one bfloat16 ulp of the largest |dx| and |d log_alpha| (the formula rounds
to bfloat16 where autograd of the plain bfloat16 forward rounds, and sums
in another order)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import t
from nawc_tpu.codec.layers import Snake as JaxSnake
import nawc_tpu_torch.ops  # noqa: F401  (registers nawc_tpu_torch.ops.snake)
from nawc_tpu_torch.codec.layers import Snake
from nawc_tpu_torch.ops import _lib

snake_ops = sys.modules["nawc_tpu_torch.ops.snake"]
SHAPES = [(2, 8, 300), (3, 5, 1001)]


def _case(shape, seed=0):
    b, c, n = shape
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 2).astype(np.float32)
    log_alpha = (rng.normal(size=(c,)) * 0.3).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    return x, log_alpha, g


def _jax_snake(dtype):
    def f(x, log_alpha):  # (B, C, T) in the port's layout; flax's is (B, T, C)
        y = JaxSnake(dtype=dtype).apply({"params": {"log_alpha": log_alpha}}, jnp.swapaxes(x, 1, 2))
        return jnp.swapaxes(y, 1, 2)
    return f


def _module(log_alpha):
    m = Snake(log_alpha.shape[0])
    with torch.no_grad():
        m.log_alpha.copy_(t(log_alpha))
    return m


def _function(x, log_alpha):
    """The autograd.Function as ``snake`` applies it on the card."""
    return snake_ops._SnakeFunction.apply(x, snake_ops._wide(torch.exp(log_alpha).to(x.dtype)))


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(v)) - 7)


@pytest.mark.parametrize("shape", SHAPES)
def test_snake_matches_flax_float32(shape):
    x, log_alpha, _ = _case(shape)
    want = np.asarray(jax.jit(_jax_snake(jnp.float32))(jnp.asarray(x), jnp.asarray(log_alpha)))
    with torch.no_grad():
        got = _module(log_alpha)(t(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_snake_matches_flax_bfloat16_bit_for_bit(shape):
    x, log_alpha, _ = _case(shape)
    want = jax.jit(_jax_snake(jnp.bfloat16))(jnp.asarray(x), jnp.asarray(log_alpha))
    with torch.no_grad():
        got = _module(log_alpha)(t(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_values_are_the_python_scalar_formula(dtype):
    """Dividing by 0-dim tensors (the plain version's guard against the
    card's reciprocal division) leaves every CPU value as it was: the
    formula with Python-number divisors, bit for bit."""
    x, log_alpha, _ = _case((3, 5, 1001), seed=4)
    xt, la = t(x).to(dtype), t(log_alpha)
    alpha = torch.exp(la).to(dtype)[None, :, None]
    u = alpha.float() * xt.float() * (1.0 / np.pi)
    u = u - torch.round(u)
    p = u * np.pi
    p2 = p * p
    s = p * (1.0 - p2 / 6.0 * (1.0 - p2 / 20.0 * (1.0 - p2 / 42.0)))
    want = xt + (s * s).to(dtype) / (alpha + 1e-9)
    assert torch.equal(snake_ops.snake(xt, la), want)


def _autograd(x, log_alpha, g, dtype=torch.float32):
    xt = t(x).to(dtype).requires_grad_()
    la = t(log_alpha).requires_grad_()
    dx, dla = torch.autograd.grad(snake_ops.snake_reference(xt, la), (xt, la), t(g).to(dtype))
    return dx.float().numpy(), dla.numpy()


def _formula(x, log_alpha, g, dtype=torch.float32):
    alpha = torch.exp(t(log_alpha)).to(dtype)
    dx, dalpha = snake_ops.snake_backward_reference(t(x).to(dtype), alpha.float(), t(g).to(dtype))
    assert dx.dtype == dtype and dalpha.dtype == torch.float32
    return dx.float().numpy(), (torch.exp(t(log_alpha)) * dalpha).numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_formula_matches_autograd(shape):
    x, log_alpha, g = _case(shape, seed=1)
    dx, dla = _formula(x, log_alpha, g)
    want_dx, want_dla = _autograd(x, log_alpha, g)
    np.testing.assert_allclose(dx, want_dx, atol=1e-6 * np.abs(want_dx).max())
    np.testing.assert_allclose(dla, want_dla, rtol=1e-5, atol=1e-5 * np.abs(want_dla).max())


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_formula_matches_jax_vjp(shape):
    x, log_alpha, g = _case(shape, seed=2)
    _, vjp = jax.vjp(_jax_snake(jnp.float32), jnp.asarray(x), jnp.asarray(log_alpha))
    want_dx, want_dla = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    dx, dla = _formula(x, log_alpha, g)
    np.testing.assert_allclose(dx, want_dx, atol=1e-5 * np.abs(want_dx).max())
    np.testing.assert_allclose(dla, want_dla, rtol=1e-4, atol=1e-4 * np.abs(want_dla).max())


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_bfloat16_within_one_ulp(shape):
    """The bfloat16 backward, through the autograd.Function as the card runs
    it, against autograd of the plain bfloat16 forward."""
    x, log_alpha, g = _case(shape, seed=3)
    xt = t(x).bfloat16().requires_grad_()
    la = t(log_alpha).requires_grad_()
    y = _function(xt, la)
    assert y.dtype == torch.bfloat16
    dx, dla = torch.autograd.grad(y, (xt, la), t(g).bfloat16())
    assert dx.dtype == torch.bfloat16 and dla.dtype == torch.float32
    want_dx, want_dla = _autograd(x, log_alpha, g, torch.bfloat16)
    assert np.abs(dx.float().numpy() - want_dx).max() <= _bf16_ulp(np.abs(want_dx).max())
    assert np.abs(dla.numpy() - want_dla).max() <= _bf16_ulp(np.abs(want_dla).max())
    # on the CPU the Function's backward is the formula
    fdx, _ = _formula(x, log_alpha, g, torch.bfloat16)
    np.testing.assert_array_equal(fdx, dx.float().numpy())


def test_function_gradcheck_float64():
    """The autograd.Function's wiring (the chain through exp to log_alpha)
    under gradcheck, with the plain bodies in float64."""
    x, log_alpha, _ = _case((2, 3, 40), seed=5)
    xt = t(x).double().requires_grad_()
    la = t(log_alpha).double().requires_grad_()
    assert torch.autograd.gradcheck(_function, (xt, la))


@pytest.mark.parametrize("need", [(True, False), (False, True), (True, True)])
def test_function_asks_only_for_the_gradients_it_needs(monkeypatch, need):
    """needs_input_grad reaches the backward: an input that needs no
    gradient gets None, and its side of the formula is not asked for."""
    x, log_alpha, g = _case((2, 3, 50), seed=6)
    xt = t(x).requires_grad_(need[0])
    la = t(log_alpha).requires_grad_(need[1])
    seen = []
    real = snake_ops._SnakeFunction.backward

    def spy(ctx, grad):
        seen.append(tuple(ctx.needs_input_grad))
        return real(ctx, grad)

    monkeypatch.setattr(snake_ops._SnakeFunction, "backward", staticmethod(spy))
    y = _function(xt, la)
    wanted = [v for v, n in zip((xt, la), need) if n]
    got = torch.autograd.grad(y, wanted, t(g))
    assert seen == [need]
    want = torch.autograd.grad(snake_ops.snake_reference(xt, la), wanted, t(g))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


def test_cpu_tensors_take_the_plain_version():
    """On the CPU ``snake`` is ``snake_reference`` with its autograd graph;
    no kernel is counted."""
    x, log_alpha, g = _case((2, 8, 300), seed=7)
    _lib.reset_launches()
    xt = t(x).requires_grad_()
    la = t(log_alpha).requires_grad_()
    y = snake_ops.snake(xt, la)
    assert not isinstance(y.grad_fn, snake_ops._SnakeFunction._backward_cls)
    assert torch.equal(y, snake_ops.snake_reference(xt, la))
    y.backward(t(g))
    assert _lib.KERNELS["snake"].launches == 0 and _lib.KERNELS["snake_backward"].launches == 0


@pytest.mark.parametrize("make,msg", [
    (lambda: torch.zeros(2, 3, 8, dtype=torch.float64), "float32 or bfloat16"),
    (lambda: torch.zeros(2, 8, 3).transpose(1, 2), "contiguous"),
    (lambda: torch.zeros(2, 3, 8), "CUDA"),
])
def test_check_refuses_what_the_kernel_does_not_take(make, msg):
    with pytest.raises(ValueError, match=msg):
        snake_ops.check_snake("snake", make())


def test_bound_counts():
    """One 16 x 4 s encode's Snakes (1.357 G elements) in float32: 10.86 GB
    forward, 3.24 ms at 3.35 TB/s, above the operations' time."""
    shapes = [(16, 48, 96_000), (16, 96, 48_000), (16, 192, 12_000), (16, 384, 1_500)]
    n = 7 * sum(int(np.prod(s)) for s in shapes) + 16 * 768 * 188
    assert n == 1_357_062_144
    nbytes, ops = snake_ops.bound_counts(n, 768, 4, backward=False)
    assert 3.24 < nbytes / 3.35e12 * 1e3 < 3.25 and ops / 67e12 < nbytes / 3.35e12
    nbytes16, _ = snake_ops.bound_counts(n, 768, 2, backward=False)
    assert abs(nbytes16 / 3.35e12 * 1e3 - 1.62) < 0.01
    nbytes_b, ops_b = snake_ops.bound_counts(n, 768, 4, backward=True)
    assert nbytes_b > 1.49 * nbytes and ops_b / 67e12 < nbytes_b / 3.35e12
