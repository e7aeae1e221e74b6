"""The port's layer-streamed trainer (``training_stream.StreamedTrainer``)
against the JAX package on the CPU: the eleven cases of the JAX package's
``tests/test_training_stream.py``, each held against JAX's own result (its
monolithic step where JAX's test compares with one, else the JAX
behaviour it pins), a JAX ``save_state`` resumed by the port and a port
``save_state`` resumed by JAX, and a training step after an inference-mode
call in the same process. float32 unless a case says otherwise; losses
within 1e-5 relative, updated params as ``assert_update_close`` says
(JAX's rtol 2e-5 / atol 2e-6 where the gradient is not near zero)."""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexible_llm_sharding_tpu import training as jtraining
from flexible_llm_sharding_tpu.training_stream import StreamedTrainer as JStreamedTrainer
from flexible_llm_sharding_tpu.utils import checkpoint as jckpt
from flexible_llm_sharding_tpu_torch import training
from flexible_llm_sharding_tpu_torch.models import llama
from flexible_llm_sharding_tpu_torch.training_stream import StreamedTrainer
from flexible_llm_sharding_tpu_torch.utils.checkpoint import params_from_jax
from tests.test_torch_training import (
    CLIP,
    LR,
    MIXTRAL1,
    WD,
    assert_tree_close,
    assert_update_close,
    jax_params,
    jax_step,
    one_torch_thread,  # noqa: F401 (an autouse fixture, for this module too)
    port_cfg,
    port_grads,
    small_cfg,
    to_np,
    tokens_for,
)

KW = dict(lr=LR, grad_clip=CLIP, weight_decay=WD)


def _cases(tiny):
    """The configurations of the cases that compare with a JAX step."""
    return {
        "tiny": small_cfg(tiny),
        "windowed": small_cfg(tiny, model_type="qwen2", sliding_window=8,
                              layer_sliding=(True, False)),
        "moe": MIXTRAL1,
        "longrope": small_cfg(
            tiny, rope_scaling_kind="longrope",
            rope_long_factor=tuple(1.5 + 0.25 * i for i in range(8)),
            rope_short_factor=tuple(1.0 + 0.05 * i for i in range(8)),
            rope_original_max_position=16, rope_attention_factor=1.1),
        "tied": small_cfg(tiny, tie_word_embeddings=True),
    }


def _trainer(jcfg, **kw):
    cfg = port_cfg(jcfg)
    return cfg, StreamedTrainer(cfg, params_from_jax(jax_params(jcfg), cfg), device="cpu",
                                **{**KW, **kw})


@pytest.mark.parametrize("case,shape", [
    ("tiny", (2, 17)),           # test_streamed_step_matches_monolithic
    ("tiny", (2, 2, 17)),        # test_streamed_grad_accumulation
    ("windowed", (2, 15)),       # test_streamed_windowed_family
    ("moe", (2, 11)),            # test_streamed_moe_family
    ("longrope", (2, 33)),       # test_streamed_longrope_matches_monolithic (33 > 16: long)
    ("tied", (2, 17)),           # test_streamed_tied_matches_monolithic
], ids=["step", "accumulation", "windowed", "moe", "longrope", "tied"])
def test_streamed_step_matches_jax_monolithic(tiny_cfg, case, shape):
    """One StreamedTrainer.step equals one JAX make_train_step update (JAX's
    own invariant, across packages), and the port's monolithic step."""
    jcfg = _cases(tiny_cfg)[case]
    tokens, want_loss, want_params = jax_step(jcfg, shape)
    cfg, tr = _trainer(jcfg)
    if case == "tied":
        assert "lm_head" not in tr.params and "lm_head" not in tr.opt_state
    got_loss = tr.step(tokens)
    assert got_loss == pytest.approx(want_loss, rel=1e-5)
    grads = port_grads(cfg, jax_params(jcfg), tokens)
    assert_update_close(tr.params, want_params, grads, LR)

    opt = training.make_optimizer(peak_lr=LR, weight_decay=WD, grad_clip=CLIP)
    state = training.TrainState.create(cfg, params_from_jax(jax_params(jcfg), cfg), opt,
                                       device="cpu")
    step = training.make_train_step(cfg, opt, dtype=torch.float32,
                                    accum_steps=shape[0] if len(shape) == 3 else 1)
    state, loss = step(state, tokens)
    assert float(loss) == pytest.approx(got_loss, rel=1e-5)
    assert_update_close(tr.params, to_np(state.params), grads, LR)


def _save_jax_checkpoint(jcfg, path) -> None:
    jckpt.save_params(jax_params(jcfg), str(path), jcfg)


def test_streamed_from_checkpoint_roundtrip(tiny_cfg, tmp_path):
    """from_pretrained streams a JAX-written native checkpoint; its first
    step is JAX's; a repeated batch learns; save() writes back what a new
    trainer reloads exactly."""
    jcfg = small_cfg(tiny_cfg)
    tokens, want_loss, want_params = jax_step(jcfg, (2, 17))
    _save_jax_checkpoint(jcfg, tmp_path / "src")
    tr = StreamedTrainer.from_pretrained(str(tmp_path / "src"), device="cpu", **KW)
    l0 = tr.step(tokens)
    assert l0 == pytest.approx(want_loss, rel=1e-5)
    cfg = port_cfg(jcfg)
    assert_update_close(tr.params, want_params, port_grads(cfg, jax_params(jcfg), tokens), LR)
    l1 = tr.step(tokens)
    assert l1 < l0
    tr.save(str(tmp_path / "out"))
    reloaded = StreamedTrainer.from_pretrained(str(tmp_path / "out"), device="cpu", **KW)
    assert_tree_close(reloaded.params, to_np(tr.params), rtol=0, atol=0)


def test_streamed_state_checkpoint_resume(tiny_cfg, tmp_path):
    """Crash-resume: save_state after step 1, restore into a fresh trainer
    with garbage params, step 2: equal to the uninterrupted run (the same
    code on the same values, so to the bit)."""
    jcfg = small_cfg(tiny_cfg)
    t1, t2 = tokens_for(jcfg, 2, (2, 11)), tokens_for(jcfg, 3, (2, 11))
    _, straight = _trainer(jcfg)
    straight.step(t1)
    straight.step(t2)
    cfg, tr = _trainer(jcfg)
    tr.step(t1)
    ck = str(tmp_path / "state")
    tr.save_state(ck)
    zeros = training.tree_map(torch.zeros_like, params_from_jax(jax_params(jcfg), cfg))
    resumed = StreamedTrainer(cfg, zeros, device="cpu", **KW)
    resumed.restore_state(ck)
    assert resumed.step_count == 1
    resumed.step(t2)
    assert_tree_close(resumed.params, to_np(straight.params), rtol=0, atol=0)


def test_streamed_state_checkpoint_bf16(tiny_cfg, tmp_path):
    """bf16 params and moments survive the npz round trip as their uint16
    bits; saving twice into one directory swaps atomically. The JAX
    package's trainer reads the port's bf16 state to the bit."""
    jcfg = small_cfg(tiny_cfg)
    cfg = port_cfg(jcfg)
    params = params_from_jax(jax_params(jcfg), cfg, dtype=torch.bfloat16)
    tokens = tokens_for(jcfg, 4, (1, 9))
    tr = StreamedTrainer(cfg, params, lr=LR, dtype=torch.bfloat16, device="cpu")
    tr.step(tokens)
    ck = str(tmp_path / "state")
    tr.save_state(ck)
    tr.step(tokens)
    tr.save_state(ck)  # over the first: the .tmp swap
    assert not os.path.exists(ck + ".tmp") and not os.path.exists(ck + ".old")

    resumed = StreamedTrainer(cfg, params, lr=LR, dtype=torch.bfloat16, device="cpu")
    resumed.restore_state(ck)
    assert resumed.step_count == 2
    for name in training.segment_names(cfg.num_hidden_layers, False):
        got = training.segment_of(resumed.opt_state, name).leaves()
        want = training.segment_of(tr.opt_state, name).leaves()
        for g, w in zip(got, want):
            assert (g.dtype == w.dtype and torch.equal(g, w)) if torch.is_tensor(w) else g == w
    resumed.step(tokens)

    jtr = JStreamedTrainer(jcfg, jax.tree.map(lambda a: np.asarray(a, jnp.bfloat16),
                                              jax_params(jcfg)), lr=LR, dtype=jnp.bfloat16)
    jtr.restore_state(ck)
    assert jtr.step_count == 2
    for name in training.segment_names(cfg.num_hidden_layers, False):
        want = training.segment_of(tr.opt_state, name).leaves()
        for g, w in zip(jax.tree.leaves(training.segment_of(jtr.opt_state, name)), want):
            np.testing.assert_array_equal(np.asarray(g), training._to_numpy(w).view(
                np.asarray(g).dtype) if torch.is_tensor(w) else w)


def test_streamed_from_int8_checkpoint(tiny_cfg, tmp_path):
    """Fine-tuning from an int8 checkpoint (the JAX package's
    requantize_native): the params dequantize at load to JAX's host
    dequant, and training runs and learns."""
    jcfg = small_cfg(tiny_cfg)
    _save_jax_checkpoint(jcfg, tmp_path / "f32")
    jckpt.requantize_native(str(tmp_path / "f32"), str(tmp_path / "q8"))
    tr = StreamedTrainer.from_pretrained(str(tmp_path / "q8"), lr=LR, device="cpu")
    assert all(t.dtype == torch.float32 for t in training.tree_leaves(tr.params))
    want = {
        "embed": jckpt.dequantize_tree_np(jckpt.load_layer(str(tmp_path / "q8"), "model.embed_tokens")),
        "layers": [jckpt.dequantize_tree_np(jckpt.load_layer(str(tmp_path / "q8"), f"model.layers.{i}"))
                   for i in range(jcfg.num_hidden_layers)],
        "norm": jckpt.dequantize_tree_np(jckpt.load_layer(str(tmp_path / "q8"), "model.norm")),
        "lm_head": jckpt.dequantize_tree_np(jckpt.load_layer(str(tmp_path / "q8"), "lm_head")),
    }
    assert_tree_close(tr.params, want, rtol=0, atol=0)
    tokens = tokens_for(jcfg, 5, (1, 9))
    l0 = tr.step(tokens)
    l1 = tr.step(tokens)
    assert np.isfinite([l0, l1]).all() and l1 < l0


def test_streamed_tied_state_checkpoint(tiny_cfg, tmp_path):
    """A tied model's state round-trips without an lm_head segment, and a
    resumed run equals an uninterrupted one."""
    jcfg = _cases(tiny_cfg)["tied"]
    tokens = tokens_for(jcfg, 6, (4, 2, 17))
    _, ref = _trainer(jcfg)
    for mb in tokens:
        ref.step(mb)
    cfg, tr = _trainer(jcfg)
    for mb in tokens[:2]:
        tr.step(mb)
    ck = str(tmp_path / "state")
    tr.save_state(ck)
    assert not os.path.exists(os.path.join(ck, "opt-lm_head.npz"))
    _, resumed = _trainer(jcfg)
    resumed.restore_state(ck)
    assert resumed.step_count == 2
    for mb in tokens[2:]:
        resumed.step(mb)
    assert_tree_close(resumed.params, to_np(ref.params), rtol=0, atol=0)


def test_tied_rule_refuses_an_lm_head(tiny_cfg):
    jcfg = small_cfg(tiny_cfg)
    cfg = dataclasses.replace(port_cfg(jcfg), tie_word_embeddings=True)
    with pytest.raises(ValueError, match="tie_word_embeddings"):
        StreamedTrainer(cfg, params_from_jax(jax_params(jcfg), port_cfg(jcfg)), device="cpu")


# ---------------------------------------------------------------------------
# Across packages: one format, resumed both ways
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def interop(tiny_cfg, tmp_path_factory):
    """A JAX trainer on a warmup schedule: step t1, save_state, step t2."""
    jcfg = small_cfg(tiny_cfg)
    t1, t2 = tokens_for(jcfg, 7, (2, 17)), tokens_for(jcfg, 8, (2, 17))
    ck = str(tmp_path_factory.mktemp("interop") / "jax_state")
    jtr = JStreamedTrainer(jcfg, jax_params(jcfg), lr=jtraining.make_lr_schedule(LR, 3, 20),
                           grad_clip=CLIP, weight_decay=WD)
    jtr.step(t1)
    jtr.save_state(ck)
    loss2 = jtr.step(t2)
    return jcfg, t1, t2, ck, loss2, jax.tree.map(np.asarray, jtr.params)


def test_a_jax_save_state_resumes_in_the_port(interop):
    jcfg, _, t2, ck, want_loss, want_params = interop
    cfg, tr = _trainer(jcfg, lr=training.make_lr_schedule(LR, 3, 20))
    tr.restore_state(ck)
    assert tr.step_count == 1 and tr.opt_state["embed"].lr_count == 1
    restored = to_np(tr.params)
    assert tr.step(t2) == pytest.approx(want_loss, rel=1e-5)
    assert_update_close(tr.params, want_params, port_grads(cfg, restored, t2), LR)


def test_a_port_save_state_resumes_in_jax(interop, tmp_path):
    jcfg, t1, t2, _, _, _ = interop
    cfg, tr = _trainer(jcfg, lr=training.make_lr_schedule(LR, 3, 20))
    tr.step(t1)
    ck = str(tmp_path / "port_state")
    tr.save_state(ck)
    restored = to_np(tr.params)
    loss2 = tr.step(t2)
    jtr = JStreamedTrainer(jcfg, jax_params(jcfg), lr=jtraining.make_lr_schedule(LR, 3, 20),
                           grad_clip=CLIP, weight_decay=WD)
    jtr.restore_state(ck)
    assert jtr.step_count == 1
    assert jtr.step(t2) == pytest.approx(loss2, rel=1e-5)
    assert_update_close(tr.params, jax.tree.map(np.asarray, jtr.params),
                        port_grads(cfg, restored, t2), LR)


def test_a_state_parked_at_old_is_recovered(tiny_cfg, tmp_path):
    """A crash between save_state's two renames leaves the previous state
    at ``.old``; restore_state takes it from there."""
    jcfg = small_cfg(tiny_cfg)
    cfg, tr = _trainer(jcfg)
    tr.step(tokens_for(jcfg, 9, (1, 9)))
    ck = str(tmp_path / "state")
    tr.save_state(ck)
    shutil.move(ck, ck + ".old")
    _, resumed = _trainer(jcfg)
    resumed.restore_state(ck)
    assert resumed.step_count == 1 and os.path.isdir(ck) and not os.path.exists(ck + ".old")
    assert_tree_close(resumed.params, to_np(tr.params), rtol=0, atol=0)


def test_training_after_an_inference_mode_call(tiny_cfg):
    """A scoring call under torch.inference_mode, then training in the same
    process: no cache filled by the inference call may hand the training
    step an inference tensor ("cannot be saved for backward")."""
    jcfg = small_cfg(tiny_cfg)
    cfg = port_cfg(jcfg)
    params = params_from_jax(jax_params(jcfg), cfg)
    ids = torch.from_numpy(tokens_for(jcfg, 10, (2, 16)))
    with torch.inference_mode():
        llama.forward_full(params, cfg, ids, use_pallas=True)
    tokens = tokens_for(jcfg, 11, (2, 17))
    tr = StreamedTrainer(cfg, params, device="cpu", **KW)
    assert np.isfinite(tr.step(tokens))
    opt = training.make_optimizer(peak_lr=LR)
    state = training.TrainState.create(cfg, params, opt, device="cpu")
    state, loss = training.make_train_step(cfg, opt, dtype=torch.float32)(state, tokens)
    assert np.isfinite(float(loss))
