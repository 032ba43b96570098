"""The port's int8 gradient compression (``repro_torch.optim.compress``)
against the JAX package's ``repro.optim.compress``, on JAX's own noise:
the noise of ``quantize(g, key)`` is ``jax.random.uniform(key, g.shape,
minval=-0.5, maxval=0.5)``, drawn here and handed to the port as a tensor
(the port's RNG rule). q array-equal, the scale allclose (rtol 1e-7, both
the same float32 division of the same max), and error feedback over 3
steps of ``compress_grads``: the dequantised gradients and the carried
residuals within rtol 1e-6 (atol 1e-6 x the leaf's largest |entry|), and
each residual (g + e) - g' exactly."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as jcomp
from repro_torch.optim import compress as tcomp


def _noise(key, shape):
    return np.array(jax.random.uniform(key, shape, minval=-0.5,
                                       maxval=0.5))


@pytest.mark.parametrize("shape,scale,seed", [((64,), 1.0, 0),
                                              ((33, 17), 1e-3, 1),
                                              ((8, 4, 5), 50.0, 2),
                                              ((16,), 0.0, 3)])
def test_quantize_equals_jax_on_its_noise(shape, scale, seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(shape) * scale).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    jq, jscale = jcomp.quantize(jnp.asarray(g), key)
    q, s = tcomp.quantize(torch.from_numpy(g),
                          torch.from_numpy(_noise(key, shape)))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(s), float(jscale), rtol=1e-7)
    np.testing.assert_allclose(
        tcomp.dequantize(q, s).numpy(),
        np.asarray(jcomp.dequantize(jq, jscale)), rtol=1e-6)


def test_error_feedback_over_three_steps_equals_jax():
    rng = np.random.default_rng(4)
    shapes = [(20, 6), (6,), (3, 4, 5)]
    tree = {"a": None, "b": None, "c": None}
    jstate = jcomp.init_state({k: jnp.zeros(s) for k, s in
                               zip(tree, shapes)})
    tstate = tcomp.init_state([torch.zeros(s) for s in shapes])
    for step in range(3):
        grads = [(rng.standard_normal(s) * 10 ** -step).astype(np.float32)
                 for s in shapes]
        key = jax.random.PRNGKey(100 + step)
        jg, jstate = jcomp.compress_grads(
            {k: jnp.asarray(g) for k, g in zip(tree, grads)}, jstate, key)
        keys = jax.random.split(key, len(shapes))
        noise = [torch.from_numpy(_noise(k, s)) for k, s in zip(keys, shapes)]
        before = tstate.error
        tg, tstate = tcomp.compress_grads(
            [torch.from_numpy(g) for g in grads], tstate, noise)
        for i, k in enumerate(tree):
            want_g = np.asarray(jg[k])
            want_e = np.asarray(jstate.error[k])
            for got, want in ((tg[i], want_g), (tstate.error[i], want_e)):
                limit = 1e-6 * np.abs(want) + 1e-6 * np.abs(want).max()
                assert (np.abs(got.numpy() - want) <= limit).all(), (step, k)
            corrected = torch.from_numpy(grads[i]) + before[i]
            assert torch.equal(tstate.error[i], corrected - tg[i])


def test_compress_grads_checks_its_inputs_and_draws_noise_per_leaf():
    grads = [torch.ones(3), torch.ones(2, 2)]
    state = tcomp.init_state(grads)
    noise = tcomp.step_noise(grads, torch.Generator().manual_seed(0))
    assert [n.shape for n in noise] == [g.shape for g in grads]
    assert all(bool(((n >= -0.5) & (n < 0.5)).all()) for n in noise)
    again = tcomp.step_noise(grads, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(noise, again))
    with pytest.raises(ValueError):
        tcomp.compress_grads(grads, state, noise[:1])
