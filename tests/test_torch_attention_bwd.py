"""Port parity of K6's backward and the LM loss against the JAX package on
the CPU.

* ``ref.flash_attention_bwd_ref`` (K6's backward, plain version) and
  ``ops.flash_attention`` under autograd (the plain versions on a CPU
  tensor) against ``jax.vjp`` of the JAX package's ``flash_attention_jnp``
  (the function its train step differentiates), in float64 under
  ``jax.enable_x64``: B 2, S 37, Hq/Hkv 4/1, 4/2 and 4/4, Dh 16 and 32,
  q_offset 0 and 5 (keys then number S + q_offset, as a query block
  inside a longer sequence has them).
* ``models.common.cross_entropy_loss`` with ignored labels (-1), its value
  and its gradient in the logits, against the JAX package's, in float32
  (both take the logsumexp in float32) and in bfloat16 logits.

Tolerances. The attention and its gradients: rtol 1e-5 with atol 1e-6 of
the largest entry (the ground rule): ``flash_attention_jnp`` computes in
float32 whatever its inputs (it casts q, k and v), the port's plain
versions in float64 on float64 inputs. The loss: rtol
1e-6 in float32 (a mean of float32 terms); its gradient rtol 1e-5 with
atol 1e-6 of the largest entry in float32, one bf16 ulp (2^-7) of each
entry plus 2^-8 of the largest in bfloat16.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon
from repro_torch.kernels import ops, ref
from repro_torch.models.common import cross_entropy_loss

B, S = 2, 37


def _close(got, want, rtol: float, atol_frac: float) -> None:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * float(np.abs(want).max()))


@pytest.mark.parametrize("off", [0, 5])
@pytest.mark.parametrize("Dh", [16, 32])
@pytest.mark.parametrize("Hkv", [1, 2, 4])
def test_attention_backward_matches_jax_vjp(Hkv, Dh, off):
    Hq = 4
    rng = np.random.default_rng(Hkv * 100 + Dh + off)
    q = rng.standard_normal((B, S, Hq, Dh))
    k, v = (rng.standard_normal((B, S + off, Hkv, Dh)) for _ in range(2))
    g = rng.standard_normal((B, S, Hq, Dh))
    with jax.enable_x64(True):
        out, vjp = jax.vjp(lambda a, b, c: jcommon.flash_attention_jnp(
            a, b, c, causal=True, block_kv=16, q_offset=off),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
        out = np.asarray(out)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    plain = ref.flash_attention_bwd_ref(tq, tk, tv, torch.from_numpy(out), tg,
                                        q_offset=off)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    o = ops.flash_attention(*leaves, q_offset=off)
    _close(o, out, 1e-5, 1e-6)
    auto = torch.autograd.grad(o, leaves, tg)
    for got_plain, got_auto, w in zip(plain, auto, want):
        _close(got_plain, w, 1e-5, 1e-6)
        _close(got_auto, w, 1e-5, 1e-6)


def test_attention_backward_of_a_served_call_is_not_taken(monkeypatch):
    """Under ``no_grad``, or with no input that requires a gradient, the
    call is K6's forward alone: no graph, the plain forward's bits. On the
    card the backward needs the forward's logsumexp."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 9, 4, 16)))
               for _ in range(3))
    want = ref.flash_attention_ref(q, k, v)
    with torch.no_grad():
        served = ops.flash_attention(q.requires_grad_(True), k, v)
    assert served.grad_fn is None and torch.equal(served, want)
    assert ops.flash_attention(q.detach(), k, v).grad_fn is None
    monkeypatch.setattr(ops, "_on_cuda", lambda x: True)
    with pytest.raises(ValueError, match="logsumexp"):
        ops.flash_attention_bwd(q, k, v, want, None, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_jax_with_ignored_labels(dtype):
    rng = np.random.default_rng(3)
    V = 300
    logits = (rng.standard_normal((2, 11, V)) * 3).astype(np.float32)
    labels = rng.integers(0, V, (2, 11)).astype(np.int32)
    labels[0, :4] = -1
    labels[1, -1] = -1
    jl = jnp.asarray(logits, dtype)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    want, vjp = jax.vjp(lambda x: jcommon.cross_entropy_loss(
        x, jnp.asarray(labels)), jl)
    want_g = np.asarray(vjp(jnp.ones((), jnp.float32))[0], np.float32)
    leaf = tl.clone().requires_grad_(True)
    loss = cross_entropy_loss(leaf, torch.from_numpy(labels))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    (grad,) = torch.autograd.grad(loss, leaf)
    assert grad.dtype == tl.dtype
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    if dtype == "float32":
        _close(grad, want_g, 1e-5, 1e-6)
    else:
        np.testing.assert_allclose(
            grad.float().numpy(), want_g, rtol=2.0**-7,
            atol=2.0**-8 * float(np.abs(want_g).max()))
    # the ignored labels' rows get no gradient; every other row sums to 0
    # (to the rounding of its entries)
    rows = grad.double().reshape(-1, V)
    ignored = torch.from_numpy(labels.reshape(-1) == -1)
    assert not rows[ignored].any()
    unit = 2.0**-8 if dtype == "bfloat16" else 2.0**-20
    assert bool((rows.sum(-1).abs() <= unit * rows.abs().sum(-1)).all())
