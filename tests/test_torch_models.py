"""Port parity of the decoder LM's serving path against the JAX package:
``prefill_step``/``decode_step`` on the five LMs' smoke configs (gemma-2b:
MQA, Dh 32, tied embeddings, GeGLU; qwen2-moe and moonshot: MoE with
shared experts; stablelm: MHA, Dh 8; qwen1.5-32b: MHA with QKV bias) and
on a small MHA config with QKV bias and an untied head, with the JAX
parameters carried across by
``transformer.params_from_numpy``; the shared blocks of ``models/common``;
then the port's own ``build_step``/``make_inputs``/``infer_run`` and
``model_flops``/``model_bytes`` for every serving shape, and the port's
mirror of the JAX prefill-then-decode test.

Tolerances: LM logits and KV caches at rtol 1e-4 with atol 1e-5 of the
largest logit (or cache entry) in float32, 2e-2 in bfloat16; the blocked
attention at ``tests/test_kernels.py``'s 3e-5 (float32) and 2e-2
(bfloat16).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_arch as j_get_arch
from repro.configs import gemma_2b as j_gemma
from repro.configs import moonshot_v1_16b_a3b as j_moonshot
from repro.configs import qwen1_5_32b as j_qwen32b
from repro.configs import qwen2_moe_a2_7b as j_qwen2_moe
from repro.configs import stablelm_1_6b as j_stablelm
from repro.models import common as jcommon
from repro.models import transformer as jt
from repro_torch.configs import (DIN_SHAPES, LM_SHAPES, gemma_2b, get_arch,
                                 moonshot_v1_16b_a3b, qwen1_5_32b,
                                 qwen2_moe_a2_7b, stablelm_1_6b)
from repro_torch.kernels import flash_attention
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as tt
from repro_torch.optim import adamw_init

# a second config beside gemma's smoke one: MHA, QKV bias, untied head
_TINY = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
             d_ff=96, vocab=256, act="silu", qkv_bias=True,
             tie_embeddings=False, dtype="float32")
LM_CONFIGS = {"gemma": (j_gemma.SMOKE, gemma_2b.SMOKE),
              "qwen2_moe": (j_qwen2_moe.SMOKE, qwen2_moe_a2_7b.SMOKE),
              "moonshot": (j_moonshot.SMOKE, moonshot_v1_16b_a3b.SMOKE),
              "stablelm": (j_stablelm.SMOKE, stablelm_1_6b.SMOKE),
              "qwen32b": (j_qwen32b.SMOKE, qwen1_5_32b.SMOKE),
              "tiny_mha": (jt.LMConfig(**_TINY), tt.LMConfig(**_TINY))}
LM_IDS = ("gemma-2b", "qwen2-moe-a2.7b", "moonshot-v1-16b-a3b",
          "stablelm-1.6b", "qwen1.5-32b")
# the JAX package's config modules, by arch id
J_CONFIGS = {"gemma-2b": j_gemma, "qwen2-moe-a2.7b": j_qwen2_moe,
             "moonshot-v1-16b-a3b": j_moonshot, "stablelm-1.6b": j_stablelm,
             "qwen1.5-32b": j_qwen32b}
KEY = jax.random.PRNGKey(0)


def _lm_pair(name: str, dtype: str = "float32"):
    jcfg, tcfg = LM_CONFIGS[name]
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    jp = jt.init(KEY, jcfg)
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rtol: float, atol_frac: float) -> None:
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * float(np.abs(want).max()))


@pytest.mark.parametrize("name", sorted(LM_CONFIGS))
def test_lm_prefill_and_decode_match_jax(name):
    jcfg, tcfg, jp, tp = _lm_pair(name)
    rng = np.random.default_rng(1)
    B, S, Smax = 2, 16, 24
    toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    jl, jkv = jt.prefill_step(jp, jcfg, jnp.asarray(toks))
    tl, tkv = tt.prefill_step(tp, tcfg, torch.from_numpy(toks))
    assert tl.dtype == torch.float32 and tl.shape == (B, jcfg.vocab)
    _close(tl, jl, 1e-4, 1e-5)
    _close(tkv, jkv, 1e-4, 1e-5)
    # decode one token against the prefilled cache, then a second one
    jc = jax.lax.dynamic_update_slice(jt.make_kv_cache(jcfg, B, Smax), jkv,
                                      (0,) * 6)
    tc = tt.make_kv_cache(tcfg, B, Smax, device="cpu")
    tc[:, :, :, :S] = tkv
    nxt = rng.integers(0, jcfg.vocab, (B, 2)).astype(np.int32)
    for i in range(2):
        jd, jc = jt.decode_step(jp, jcfg, jnp.asarray(nxt[:, i:i + 1]), jc,
                                jnp.int32(S + i))
        td, tc2 = tt.decode_step(tp, tcfg, torch.from_numpy(nxt[:, i:i + 1]),
                                 tc, S + i)
        assert tc2 is tc                     # written in place
        _close(td, jd, 1e-4, 1e-5)
        _close(tc, jc, 1e-4, 1e-5)


@pytest.mark.parametrize("name", sorted(set(LM_CONFIGS) - {"tiny_mha"}))
def test_lm_bfloat16_matches_jax(name):
    jcfg, tcfg, jp, tp = _lm_pair(name, "bfloat16")
    toks = np.random.default_rng(2).integers(0, jcfg.vocab,
                                             (2, 16)).astype(np.int32)
    jl, jkv = jt.prefill_step(jp, jcfg, jnp.asarray(toks))
    tl, tkv = tt.prefill_step(tp, tcfg, torch.from_numpy(toks))
    assert tkv.dtype == torch.bfloat16
    _close(tl, jl, 2e-2, 2e-2)
    _close(tkv, jkv, 2e-2, 2e-2)
    jc = jax.lax.dynamic_update_slice(jt.make_kv_cache(jcfg, 2, 20), jkv,
                                      (0,) * 6)
    tc = tt.make_kv_cache(tcfg, 2, 20, device="cpu")
    tc[:, :, :, :16] = tkv
    jd, _ = jt.decode_step(jp, jcfg, jnp.asarray(toks[:, :1]), jc,
                           jnp.int32(16))
    td, _ = tt.decode_step(tp, tcfg, torch.from_numpy(toks[:, :1]), tc, 16)
    _close(td, jd, 2e-2, 2e-2)


@pytest.mark.parametrize("model", ["gemma", "qwen2_moe"])
def test_params_from_numpy_carries_bfloat16_bits_and_the_tree(model):
    a = np.asarray(jax.random.normal(KEY, (5, 7), jnp.bfloat16))
    t = tcommon.tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))
    jcfg, tcfg, jp, tp = _lm_pair(model, "bfloat16")
    assert isinstance(tp, torch.nn.Module) and tp.cfg == tcfg
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    named = dict(tp.named_parameters())
    assert len(named) == len(jflat)
    for path, leaf in jflat:
        name = ".".join(k.key for k in path)
        leaf = np.asarray(leaf)
        # the MoE router stays float32 in a bfloat16 model
        assert str(named[name].dtype) == f"torch.{leaf.dtype}", name
        bits = np.int16 if leaf.dtype.name == "bfloat16" else np.int32
        np.testing.assert_array_equal(
            named[name].view(getattr(torch, bits.__name__)).numpy(),
            leaf.view(bits))
    with pytest.raises(ValueError, match="stacked layers"):
        tt.params_from_numpy(jax.tree.map(np.asarray, jp),
                             dataclasses.replace(tcfg, n_layers=3), "cpu")


def test_forward_last_position_equals_prefill_logits():
    _, tcfg, _, tp = _lm_pair("tiny_mha")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab, (2, 12)).astype(np.int32))
    h = tt.forward(tp, tcfg, toks)
    logits, _ = tt.prefill_step(tp, tcfg, toks)
    torch.testing.assert_close((h[:, -1] @ tp["lm_head"]).float(), logits)


@pytest.fixture(scope="module")
def tiny_cfg():
    return tt.LMConfig(name="t", n_layers=2, d_model=64, n_heads=4,
                       n_kv_heads=2, d_ff=96, vocab=256, qkv_bias=True,
                       dtype="float32")


def test_prefill_then_decode_matches_full_prefill(tiny_cfg):
    """Mirror of the JAX test of the same name, inside the port."""
    params = tt.init(tiny_cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, tiny_cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    logits, kv = tt.prefill_step(params, tiny_cfg, toks)
    cache = tt.make_kv_cache(tiny_cfg, 2, 24, device="cpu")
    cache[:, :, :, :16] = kv
    dec, _ = tt.decode_step(params, tiny_cfg, toks[:, :1], cache, 16)
    full, _ = tt.prefill_step(params, tiny_cfg,
                              torch.cat([toks, toks[:, :1]], dim=1))
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=2e-3)


def test_init_matches_jax_shapes_and_param_count():
    for name in LM_CONFIGS:
        jcfg, tcfg = LM_CONFIGS[name]
        jp = jax.tree.map(np.asarray, jt.init(KEY, jcfg))
        tp = tt.init(tcfg, torch.Generator().manual_seed(0), "cpu")
        jflat = {".".join(k.key for k in path): a for path, a in
                 jax.tree_util.tree_flatten_with_path(jp)[0]}
        named = {k: tuple(v.shape) for k, v in tp.named_parameters()}
        assert named == {k: a.shape for k, a in jflat.items()}
        assert sum(a.size for a in jflat.values()) == tcfg.param_count
        assert tcfg.flops_param_count == jcfg.flops_param_count
    assert gemma_2b.CONFIG.param_count == j_gemma.CONFIG.param_count \
        == 2_506_172_416
    bf16 = dataclasses.replace(qwen2_moe_a2_7b.SMOKE, dtype="bfloat16")
    tp = tt.init(bf16, torch.Generator().manual_seed(0), "cpu")
    assert tp["layers"]["ffn"]["router"].dtype == torch.float32
    assert tp["layers"]["ffn"]["w_up"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch_id", LM_IDS)
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_configs_and_parameter_counts_match_jax(arch_id, which):
    """Each LM config equals the JAX one field for field, and the port
    counts its parameters, its active parameters (MoE: a token's top k and
    shared experts) and its products' parameters as the JAX package
    does."""
    jcfg = getattr(J_CONFIGS[arch_id], which)
    tcfg = get_arch(arch_id).config(smoke=which == "SMOKE")
    assert dataclasses.asdict(tcfg) == {
        k: v for k, v in dataclasses.asdict(jcfg).items()
        if k in {f.name for f in dataclasses.fields(tcfg)}}
    for count in ("param_count", "active_param_count", "flops_param_count"):
        assert getattr(tcfg, count) == getattr(jcfg, count), count


# ---------------------------------------------------------------------------
# models/common


ATTN_SHAPES = [
    (1, 128, 128, 2, 2, 64, True, 0),
    (2, 100, 100, 4, 2, 32, True, 0),        # GQA + ragged block tail
    (1, 1, 256, 4, 1, 64, True, 255),        # decode shape (MQA)
    (2, 64, 192, 8, 8, 128, False, 0),       # cross, no mask
    (1, 37, 53, 2, 1, 16, True, 16),         # odd everything + offset
]
DTYPES = {"float32": (jnp.float32, torch.float32, 3e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,Dh,causal,off", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_blocked_attention_matches_jax(B, Sq, Skv, Hq, Hkv, Dh, causal, off,
                                       dtype):
    """``flash_attention_blocked`` against ``flash_attention_jnp`` at a key
    block that leaves a ragged tail, and ``mha_reference`` against the JAX
    oracle of the same name."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(Sq + Skv)
    arrays = [rng.standard_normal(shape, dtype=np.float32) for shape in
              ((B, Sq, Hq, Dh), (B, Skv, Hkv, Dh), (B, Skv, Hkv, Dh))]
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in arrays)
    want = np.asarray(jcommon.flash_attention_jnp(
        jq, jk, jv, causal=causal, block_kv=48, q_offset=off), np.float32)
    got = tcommon.flash_attention_blocked(tq, tk, tv, causal=causal,
                                          block_kv=48, q_offset=off)
    assert got.dtype == tdt and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    want = np.asarray(jcommon.mha_reference(jq, jk, jv, causal=causal,
                                            q_offset=off), np.float32)
    got = tcommon.mha_reference(tq, tk, tv, causal=causal, q_offset=off)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def test_common_blocks_match_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 6, 4, 16), dtype=np.float32)
    w = rng.standard_normal(16, dtype=np.float32)
    np.testing.assert_allclose(
        tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-5, atol=1e-6)
    jc, js = jcommon.rope_frequencies(16, 20, 500.0)
    tc, ts = tcommon.rope_frequencies(16, 20, 500.0, "cpu")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    pos = rng.integers(0, 20, (2, 6)).astype(np.int32)
    np.testing.assert_allclose(
        tcommon.apply_rope(torch.from_numpy(x), tc, ts,
                           torch.from_numpy(pos).long()).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jc, js,
                                      jnp.asarray(pos))),
        rtol=1e-5, atol=1e-6)
    for name in ("gelu", "silu", "relu", "gelu_tanh", "sigmoid", "tanh"):
        np.testing.assert_allclose(
            tcommon.act_fn(name)(torch.from_numpy(x)).numpy(),
            np.asarray(jcommon.act_fn(name)(jnp.asarray(x))),
            rtol=1e-5, atol=1e-6)
    jm = jcommon.mlp_init(KEY, [16, 12, 3])
    tm = tcommon.MLP([torch.from_numpy(np.array(layer["w"]))
                      for layer in jm],
                     [torch.from_numpy(np.array(layer["b"]))
                      for layer in jm])
    np.testing.assert_allclose(
        tcommon.mlp_apply(tm, torch.from_numpy(x), "sigmoid").numpy(),
        np.asarray(jcommon.mlp_apply(jm, jnp.asarray(x), "sigmoid")),
        rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# arch registry: build_step / make_inputs / infer_run / model_flops


SERVING = [(a, s) for a, shapes in [*((a, LM_SHAPES) for a in LM_IDS),
                                    ("din", DIN_SHAPES)]
           for s in shapes if shapes[s]["kind"] != "train"]
CUTS = {"prefill": dict(batch=2, seq=12), "decode": dict(batch=2, seq=12),
        "serve": dict(batch=8), "retrieval": dict(candidates=100)}


@pytest.mark.parametrize("arch_id,shape_id", SERVING)
def test_build_step_runs_every_serving_shape(arch_id, shape_id):
    arch = get_arch(arch_id)
    kind = arch.kind(shape_id)
    gen = torch.Generator().manual_seed(7)
    params = arch.init_params(gen, "cpu", smoke=True)
    batch = arch.make_inputs(shape_id, gen, "cpu", smoke=True, **CUTS[kind])
    step = arch.build_step(shape_id, smoke=True)
    flash_attention.reset_launches()
    out = step(params, batch)
    assert flash_attention.LAUNCHES["flash_attention"] == 0   # CPU tensors
    cfg = arch.smoke_cfg
    if kind == "prefill":
        logits, kv = out
        assert logits.shape == (2, cfg.vocab)
        assert kv.shape == (cfg.n_layers, 2, 2, 12, cfg.n_kv_heads,
                            cfg.head_dim)
    elif kind == "decode":
        logits, cache = out
        assert logits.shape == (2, cfg.vocab) and cache is batch["kv_cache"]
        assert batch["cache_len"] == 11
    elif kind == "serve":
        logits = out
        assert logits.shape == (8,)
    else:
        logits = out
        assert logits.shape == (100,)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch_id,shape_id", SERVING)
def test_model_flops_and_bytes_match_jax(arch_id, shape_id, monkeypatch):
    """The port counts a cell's operations and bytes as the JAX package
    does, at the published shape and cut."""
    ours, theirs = get_arch(arch_id), j_get_arch(arch_id)
    assert ours.model_flops(shape_id) == theirs.model_flops(shape_id)
    assert ours.model_bytes(shape_id) == theirs.model_bytes(shape_id)
    cut = CUTS[ours.kind(shape_id)]
    table = jbase.LM_SHAPES if arch_id in LM_IDS else jbase.DIN_SHAPES
    monkeypatch.setitem(table, shape_id, {**table[shape_id], **cut})
    assert ours.model_flops(shape_id, **cut) == theirs.model_flops(shape_id)
    assert ours.model_bytes(shape_id, **cut) == theirs.model_bytes(shape_id)


@pytest.mark.parametrize("arch_id", [*LM_IDS, "din"])
def test_infer_run_smoke(arch_id):
    out = get_arch(arch_id).infer_run(torch.Generator().manual_seed(0),
                                      "cpu")
    assert out and all(np.isfinite(v) for v in out.values())


def test_unported_kinds_and_archs_raise():
    with pytest.raises(NotImplementedError, match="later slice"):
        get_arch("gemma-2b").build_step("train_4k")
    assert callable(get_arch("din").build_step("train_batch"))  # ported
    with pytest.raises(NotImplementedError, match="later slice"):
        get_arch("gemma-2b").model_flops("train_4k")
    pna = get_arch("pna")                      # GNN training is ported
    gen = torch.Generator().manual_seed(0)
    params = pna.init_params(gen, "cpu", shape_id="full_graph_sm")
    _, state, loss = pna.build_step("full_graph_sm")(
        params, adamw_init(params),
        pna.make_inputs("full_graph_sm", gen, "cpu"))
    assert torch.isfinite(loss) and int(state.step) == 1
    with pytest.raises(KeyError, match="later slice"):
        get_arch("ppr-fora")
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")
    with pytest.raises(ValueError, match="cannot cut"):
        get_arch("din").make_inputs("serve_p99", torch.Generator(), "cpu",
                                    seq=3)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch = get_arch("din")
    with pytest.raises(RuntimeError, match="CUDA"):
        arch.init_params(torch.Generator(), smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        arch.infer_run(torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.make_kv_cache(gemma_2b.SMOKE, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_arch("gemma-2b").make_inputs("prefill_32k", torch.Generator(),
                                         smoke=True, batch=1, seq=4)
