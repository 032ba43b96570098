"""Port parity of dense LM training against the JAX package on the CPU.

* ``transformer.loss_fn``'s value and every leaf's gradient
  (``transformer.value_and_grad``, leaves in the JAX order) against
  ``jax.value_and_grad(transformer.loss_fn)`` in float64
  (``jax.enable_x64``, on the same float32 parameters and tokens), on
  gemma-2b's SMOKE (4 query heads on 1 KV head, tied embeddings, GeGLU)
  and qwen1.5-32b's SMOKE (MHA with QKV bias, an untied head), with the
  JAX parameters carried across (``transformer.params_from_numpy``) and
  ignored labels (-1) in the batch.
* Per-layer remat on against off: the same bits.
* One ``build_step("train_4k", smoke=True)`` step with ``grad_accum`` 1
  and 2 against the JAX ``LMArch`` train step from the same AdamW state
  (``state_from_numpy``): the loss, the parameters and the moments.
* ``model_flops``/``model_bytes`` of ``train_4k`` equal to the JAX
  package's, at the published shape and cut; ``make_inputs("train_4k")``
  the first ``TokenStream`` batch; the MoE LMs' train kind builds (its
  parity is ``tests/test_torch_moe_train.py``'s).
* The train step with the CUDA wrappers stood in by their plain versions:
  no float ``index_add``, ``scatter_add``, ``scatter_reduce`` or
  accumulating ``index_put_`` outside them, and the launches that
  ``chip_smoke.lm_train_launches`` gives.

Tolerances. The loss: rtol 1e-5. Gradients: rtol 1e-4 with atol 1e-6 x
the leaf's largest |entry| (the ground rule for long sums: a gradient
here sums over the batch's tokens, and the JAX package's attention and
loss run in float32 even under x64, as they cast to it). Parameters after
the step (against JAX's float32 step): rtol 1e-4 with the same atol,
except entries whose JAX gradient was at rounding level, where Adam's
update is about lr sign(g): those within 2 lr more
(``tests/test_torch_din_train.py``'s rule). Moments: the gradients' rtol,
second moments twice it.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

import chip_smoke
from repro.configs import base as jbase
from repro.configs import gemma_2b as j_gemma
from repro.configs import qwen1_5_32b as j_qwen32b
from repro.data.pipeline import TokenStream as JTokenStream
from repro.models import transformer as jt
from repro.optim import adamw as jadamw
from repro_torch.configs import LM_SHAPES, gemma_2b, get_arch, qwen1_5_32b
from repro_torch.configs.base import LMArch
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as tt
from repro_torch.models.common import tree_leaves
from repro_torch.optim import state_from_numpy

CONFIGS = {"gemma": (j_gemma.SMOKE, gemma_2b.SMOKE),
           "qwen32b": (j_qwen32b.SMOKE, qwen1_5_32b.SMOKE)}
DENSE = ("gemma-2b", "stablelm-1.6b", "qwen1.5-32b")
B, S = 4, 24


def _pair(name: str):
    jcfg, tcfg = CONFIGS[name]
    jp = jt.init(jax.random.PRNGKey(1), jcfg)
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(7)
    toks = rng.integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    labels[0, :5] = -1
    return jcfg, tcfg, jp, tp, toks, labels


def _close(got, want, rtol: float, what: str) -> None:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_and_gradients_match_jax(name):
    jcfg, tcfg, jp, tp, toks, labels = _pair(name)
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                           jp)
        cfg64 = dataclasses.replace(jcfg, dtype="float64")
        want_loss, want = jax.jit(jax.value_and_grad(jt.loss_fn),
                                  static_argnums=1)(
            p64, cfg64, jnp.asarray(toks), jnp.asarray(labels))
        want = [np.asarray(g) for g in jax.tree.leaves(want)]
    tt_toks, tt_labels = torch.from_numpy(toks), torch.from_numpy(labels)
    loss, grads = tt.value_and_grad(tp, tcfg, tt_toks, tt_labels)
    assert len(grads) == len(want) == len(tree_leaves(tp))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert torch.equal(loss, tt.loss_fn(tp, tcfg, tt_toks, tt_labels))
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.dtype == torch.float32
        _close(g.numpy(), w, 1e-4, f"{name} gradient leaf {i}")
    # the embedding rows no token names get no gather gradient: untied,
    # their gradient is 0
    if not tcfg.tie_embeddings:
        named = np.zeros(tcfg.vocab, bool)
        named[toks.reshape(-1)] = True
        assert not grads[0][torch.from_numpy(~named)].any()


def test_remat_gives_the_same_bits():
    _, tcfg, _, tp, toks, labels = _pair("gemma")
    assert tcfg.remat
    runs = [tt.value_and_grad(tp, dataclasses.replace(tcfg, remat=r),
                              torch.from_numpy(toks), torch.from_numpy(labels))
            for r in (True, False)]
    (l1, g1), (l2, g2) = runs
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def _rounding_level(g, rtol):
    g = np.abs(np.asarray(g, np.float64))
    return g <= rtol * g + rtol * g.max()


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_the_jax_train_step(accum):
    jcfg, tcfg, jp, tp, toks, labels = _pair("gemma")
    jarch = jbase.LMArch("gemma-2b", jcfg, jcfg, grad_accum=accum)
    jstep = jax.jit(jarch.build_step("train_4k"))
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    grads = jax.jit(jax.grad(jt.loss_fn), static_argnums=1)(
        jp, jcfg, jb["tokens"], jb["labels"])
    tiny = [_rounding_level(g, 1e-4) for g in jax.tree.leaves(grads)]
    jstate = jadamw.adamw_init(jp)
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    jp, jstate, jloss = jstep(jp, jstate, jb)
    step = LMArch("gemma-2b", tcfg, tcfg, grad_accum=accum).build_step(
        "train_4k", smoke=True)
    tp, tstate, loss = step(tp, tstate, {"tokens": torch.from_numpy(toks),
                                         "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert int(tstate.step) == 1
    lr = jarch.opt.lr / jarch.opt.warmup_steps
    for i, (t, j) in enumerate(zip(tree_leaves(tp), jax.tree.leaves(jp))):
        got = t.detach().numpy().astype(np.float64)
        want = np.asarray(j, np.float64)
        limit = 1e-4 * np.abs(want) + 1e-6 * np.abs(want).max()
        limit = np.where(tiny[i], limit + 2 * lr, limit)
        assert (np.abs(got - want) <= limit).all(), f"parameter leaf {i}"
    for i, (m, jm) in enumerate(zip(tstate.m, jax.tree.leaves(jstate.m))):
        want = np.asarray(jm, np.float64)
        _close(m.numpy(), want, 1e-4, f"first moment {i}")
    for i, (v, jv) in enumerate(zip(tstate.v, jax.tree.leaves(jstate.v))):
        want = np.asarray(jv, np.float64)
        _close(v.numpy(), want, 2e-4, f"second moment {i}")


@pytest.mark.parametrize("arch_id", DENSE)
def test_train_flops_and_bytes_match_jax(arch_id, monkeypatch):
    from repro.configs import get_arch as j_get_arch

    ours, theirs = get_arch(arch_id), j_get_arch(arch_id)
    assert ours.model_flops("train_4k") == theirs.model_flops("train_4k")
    assert ours.model_bytes("train_4k") == theirs.model_bytes("train_4k")
    cut = dict(batch=2, seq=4096)
    monkeypatch.setitem(jbase.LM_SHAPES, "train_4k",
                        {**jbase.LM_SHAPES["train_4k"], **cut})
    assert ours.model_flops("train_4k", **cut) == \
        theirs.model_flops("train_4k")
    assert ours.model_bytes("train_4k", **cut) == \
        theirs.model_bytes("train_4k")
    assert tt.model_flops_per_token(ours.cfg) == \
        jt.model_flops_per_token(theirs.cfg)


def test_train_inputs_and_the_moe_lms():
    arch = get_arch("gemma-2b")
    batch = arch.make_inputs("train_4k", torch.Generator(), "cpu",
                             smoke=True, seed=3, batch=2, seq=16)
    want = next(iter(JTokenStream(arch.smoke_cfg.vocab, 16, 2, seed=3)))
    for key in ("tokens", "labels"):
        assert np.array_equal(batch[key].numpy(), want[key])
    assert LM_SHAPES["train_4k"] == dict(kind="train", seq=4096, batch=256)
    for arch_id in ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"):
        moe = get_arch(arch_id)
        assert callable(moe.build_step("train_4k"))
        assert moe.model_flops("train_4k") > 0
        assert moe.model_bytes("train_4k") > 0
    with pytest.raises(ValueError, match="no options"):
        arch.build_step("train_4k", grad_accum=2)
    with pytest.raises(ValueError, match="multiple of grad_accum"):
        LMArch("gemma-2b", arch.cfg, arch.smoke_cfg, grad_accum=3).build_step(
            "train_4k", smoke=True)(None, None, batch)


def test_train_step_on_the_card_path_has_no_float_scatter(monkeypatch):
    """The train step (2 micro-batches) with ``ops`` routing to the CUDA
    wrappers, each stood in by its plain version run outside the
    recorder: no float scatter in the port's own ops, the launches a
    step that its structure gives, and the CPU's loss and gradients."""
    arch = get_arch("gemma-2b")
    cfg = arch.smoke_cfg
    counts = {"fwd": 0, "bwd": 0, "seg": 0}

    def fwd(q, k, v, *, causal=True, q_offset=0, return_lse=False):
        with _disable_current_modes():
            counts["fwd"] += 1
            out = ref.flash_attention_ref(q, k, v, causal=causal,
                                          q_offset=q_offset)
            lse = torch.zeros(q.shape[:3])
        return (out, lse) if return_lse else out

    def bwd(q, k, v, o, lse, dout, *, causal=True, q_offset=0):
        with _disable_current_modes():
            counts["bwd"] += 1
            return ref.flash_attention_bwd_ref(q, k, v, o, dout,
                                               causal=causal,
                                               q_offset=q_offset)

    def seg(values, order, keys, offsets, op):
        with _disable_current_modes():
            counts["seg"] += 1
            rows = order if order is not None else torch.arange(
                values.shape[0], dtype=torch.int32)
            return ref.segment_reduce_ref(values, rows, offsets, op)

    monkeypatch.setattr(ops, "_on_cuda", lambda x: True)
    monkeypatch.setattr(ops, "flash_attention_cuda", fwd)
    monkeypatch.setattr(ops, "flash_attention_bwd_cuda", bwd)
    monkeypatch.setattr(ops, "segment_reduce_cuda", seg)
    params = arch.init_params(torch.Generator().manual_seed(0), "cpu",
                              smoke=True)
    batch = arch.make_inputs("train_4k", torch.Generator(), "cpu",
                             smoke=True, seed=0, batch=4, seq=16)
    recorder = chip_smoke.float_scatter_recorder()
    with recorder:
        loss, grads = tt.value_and_grad(params, cfg, batch["tokens"][:2],
                                        batch["labels"][:2])
    assert not recorder.seen, sorted(set(recorder.seen))
    want = chip_smoke.lm_train_launches(cfg, 1)
    assert counts == {"fwd": want["flash_attention"],
                      "bwd": want["flash_attention_bwd"], "seg": 1}
    monkeypatch.undo()
    want_loss, want_grads = tt.value_and_grad(params, cfg,
                                              batch["tokens"][:2],
                                              batch["labels"][:2])
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))
