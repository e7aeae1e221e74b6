"""The port's training (``flexible_llm_sharding_tpu_torch/training.py``, the
layer it differentiates and the initialisers) against the JAX package's on
the CPU: the same seeded numpy params (JAX's ``init_params`` through
``params_from_jax``) and tokens, float32. Losses within 1e-5 relative;
gradients and updated params at JAX's own invariant tolerance (rtol 2e-5,
atol 2e-6, ``tests/test_training_stream.py``) unless a test says why not.
Each JAX reference is computed once per module."""

import dataclasses
import functools
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flexible_llm_sharding_tpu import training as jtraining
from flexible_llm_sharding_tpu.config import LlamaConfig as JLlamaConfig
from flexible_llm_sharding_tpu.models import llama as jllama
from flexible_llm_sharding_tpu.ops.attention import causal_mask as jcausal_mask
from flexible_llm_sharding_tpu_torch import training
from flexible_llm_sharding_tpu_torch.config import LlamaConfig
from flexible_llm_sharding_tpu_torch.models import llama
from flexible_llm_sharding_tpu_torch.ops.attention import causal_mask
from flexible_llm_sharding_tpu_torch.utils.checkpoint import params_from_jax, tensor_from_numpy
from tests.test_model_families import LLAMA4_CFG, MIXTRAL_CFG
from tests.test_torch_mla_moe import _deepseek_cfg

RTOL, ATOL = 2e-5, 2e-6
# One or two decoder layers of the JAX tests' tiny MoE models keep the JAX
# compiles short: Mixtral's MoE layer; Llama 4's chunked MoE layer, then its
# global NoPE layer; DeepSeek's MoE layer with MLA.
MIXTRAL1 = dataclasses.replace(MIXTRAL_CFG, num_hidden_layers=1)
LLAMA4_2 = dataclasses.replace(LLAMA4_CFG, num_hidden_layers=2, moe_layer_pattern=(True, False),
                               layer_sliding=(True, False), layer_rope=(True, False))
DEEPSEEK1 = _deepseek_cfg(num_hidden_layers=1, first_k_dense_replace=0)
LR, CLIP, WD = 1e-3, 1.0, 0.1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tiny tensors: they gain nothing
    from more, and under the suite's parallel workers every process's pool
    of spinning threads oversubscribes the cores (a CPU step here ran 40×
    slower). Restored for the worker's next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Helpers shared with tests/test_torch_training_stream.py
# ---------------------------------------------------------------------------

def port_cfg(jcfg: JLlamaConfig) -> LlamaConfig:
    return LlamaConfig.from_dict({**dataclasses.asdict(jcfg), "fls_native": True})


def small_cfg(tiny_cfg: JLlamaConfig, **kw) -> JLlamaConfig:
    """tiny_cfg at 2 layers (the JAX compile grows with depth; nothing here
    needs 4)."""
    return dataclasses.replace(tiny_cfg, **{"num_hidden_layers": 2, **kw})


# Fields that change a model's behaviour but not its weights' tree: configs
# differing only in these share one JAX init (the tied model drops lm_head).
_WEIGHTLESS = dict(model_type="llama", sliding_window=None, layer_sliding=None,
                   rope_scaling_kind=None, rope_long_factor=None, rope_short_factor=None,
                   rope_original_max_position=8192, rope_attention_factor=1.0,
                   tie_word_embeddings=False)


def jax_params(jcfg: JLlamaConfig) -> dict:
    """JAX's float32 init of ``jcfg`` (key 0) as numpy, made once per
    process. Callers copy it (``params_from_jax``) and never write it."""
    if jcfg.num_local_experts or jcfg.kv_lora_rank or jcfg.moe_layer_pattern is not None:
        return _jax_init(jcfg)
    params = dict(_jax_init(dataclasses.replace(jcfg, **_WEIGHTLESS)))
    if jcfg.tie_word_embeddings:
        del params["lm_head"]
    return params


@functools.lru_cache(maxsize=None)
def _jax_init(jcfg: JLlamaConfig) -> dict:
    """The jitted init: one compile instead of one per leaf shape."""
    init = jllama.init_mixed_params if jcfg.moe_layer_pattern is not None else jllama.init_params
    return jax.tree.map(np.asarray, jax.jit(init, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jcfg, jnp.float32))


@functools.lru_cache(maxsize=None)
def jax_step(jcfg: JLlamaConfig, shape: tuple, seed: int = 1):
    """One JAX make_train_step update (mesh None, float32, make_optimizer at
    LR/WD/CLIP) from :func:`jax_params` on seeded tokens of ``shape``
    ([accum, B, L+1] accumulates): (tokens, loss, updated params), made once
    per process."""
    tokens = tokens_for(jcfg, seed, shape)
    opt = jtraining.make_optimizer(peak_lr=LR, weight_decay=WD, grad_clip=CLIP)
    state = jtraining.TrainState.create(jcfg, jax.tree.map(jnp.asarray, jax_params(jcfg)), opt)
    step = jtraining.make_train_step(jcfg, opt, dtype=jnp.float32,
                                     accum_steps=shape[0] if len(shape) == 3 else 1)
    state, loss = step(state, jnp.asarray(tokens))
    return tokens, float(loss), jax.tree.map(np.asarray, state.params)


def to_np(tree):
    return training.tree_map(lambda t: t.detach().float().numpy(), tree)


def assert_tree_close(got, want, rtol=RTOL, atol=ATOL, path="", scaled=False):
    """got: a port tree (tensors or numpy); want: a JAX tree (numpy). With
    ``scaled``, each leaf's atol is ``atol`` times its largest magnitude
    (at least 1): float32 sums of terms that large, taken in another
    order, differ by that much."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_tree_close(got[k], want[k], rtol, atol, f"{path}.{k}", scaled)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_close(g, w, rtol, atol, f"{path}[{i}]", scaled)
    else:
        g = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
        w = np.asarray(want, np.float32)
        if scaled:
            atol = atol * max(1.0, float(np.abs(w).max(initial=0.0)))
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=path)


# A gradient this close to 0 (after the clip) is within float32 summation
# noise (about 1e-9 at these widths) of AdamW's eps (1e-8): the first update
# lr * g / (|g| + eps) of such an element can take any value in [-lr, lr] in
# either package.
NEAR_ZERO_GRAD = 1e-6


def assert_update_close(got, want, grads, lr, path=""):
    """Updated params: JAX's tolerance (rtol 2e-5, atol 2e-6) wherever the
    step's clipped gradient (``grads``, the port's) is not near zero, and
    within two steps' size (2 * lr) where it is (NEAR_ZERO_GRAD's reason);
    those gradients themselves are held tight by the gradient tests."""
    if isinstance(want, dict):
        for k in want:
            assert_update_close(got[k], want[k], grads[k], lr, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        for i, w in enumerate(want):
            assert_update_close(got[i], w, grads[i], lr, f"{path}[{i}]")
    else:
        g = got.detach().float().numpy()
        w = np.asarray(want, np.float32)
        noisy = np.abs(grads.detach().float().numpy()) < NEAR_ZERO_GRAD
        np.testing.assert_allclose(g[~noisy], w[~noisy], rtol=RTOL, atol=ATOL, err_msg=path)
        np.testing.assert_allclose(g[noisy], w[noisy], rtol=0, atol=2 * lr, err_msg=path)


def tokens_for(jcfg, seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, jcfg.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad_id", [None, 3], ids=["no-pad", "pad"])
def test_token_cross_entropy_matches_jax(pad_id):
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (2, 7, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (2, 7)).astype(np.int32)
    targets[1, 4:] = 3  # right padding
    want = float(jtraining.token_cross_entropy(jnp.asarray(logits), jnp.asarray(targets), pad_id))
    got = float(training.token_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                                             pad_id))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.fixture(scope="module")
def loss_case(tiny_cfg):
    jcfg = small_cfg(tiny_cfg)
    params_np = jax_params(jcfg)
    tokens = tokens_for(jcfg, 1, (2, 17))
    loss, grads = jax.jit(jax.value_and_grad(jtraining.next_token_loss), static_argnums=(1, 3, 4))(
        jax.tree.map(jnp.asarray, params_np), jcfg, jnp.asarray(tokens), jnp.float32, 5)
    return jcfg, params_np, tokens, float(loss), jax.tree.map(np.asarray, grads)


def test_next_token_loss_and_grads_match_jax(loss_case):
    jcfg, params_np, tokens, want_loss, want_grads = loss_case
    cfg = port_cfg(jcfg)
    loss, grads = training.value_and_grad(params_from_jax(params_np, cfg), cfg,
                                          torch.from_numpy(tokens), torch.float32, 5)
    assert float(loss) == pytest.approx(want_loss, rel=1e-5)
    assert_tree_close(grads, want_grads)


def test_the_training_loss_runs_no_kernel_wrapper(loss_case, monkeypatch):
    """The training path differentiates decoder_layer's plain attention: a
    kernel wrapper reached from it would hand the card an output with no
    gradient."""
    from flexible_llm_sharding_tpu_torch.models import llama as port_llama

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper ran on the training path")

    for name in ("flash_causal_attention", "flash_prefix_shared_attention",
                 "flash_decode_attention"):
        monkeypatch.setattr(port_llama, name, refuse)
    jcfg, params_np, tokens, want_loss, _ = loss_case
    cfg = port_cfg(jcfg)
    loss = training.next_token_loss(params_from_jax(params_np, cfg), cfg,
                                    torch.from_numpy(tokens), torch.float32, 5)
    assert float(loss) == pytest.approx(want_loss, rel=1e-5)


# ---------------------------------------------------------------------------
# decoder_layer, per family: output and gradients
# ---------------------------------------------------------------------------

# Each case chains a model's layers (its params from JAX's init, the norm
# scales as drawn: ones): the sliding family's banded layer; Llama 4's chunked
# MoE layer (routed experts scaling their input, a shared expert), then its
# dense NoPE layer with temperature-tuned queries; DeepSeek's MoE layer with
# MLA (group-limited routing, a shared expert, a correction bias that only
# selects); Mixtral's MoE layer. The llama layer is the loss test's.
LAYER_CASES = {
    "sliding": lambda tiny: (small_cfg(tiny, model_type="mistral", sliding_window=5), [0]),
    "llama4_chunked_moe_nope": lambda tiny: (LLAMA4_2, [0, 1]),
    "deepseek_mla_moe": lambda tiny: (DEEPSEEK1, [0]),
    "mixtral_moe": lambda tiny: (MIXTRAL1, [0]),
}


@pytest.fixture(scope="module")
def layer_refs(tiny_cfg):
    """Per case: the chained layers' output and the gradients of sum(out * w)
    with respect to every layer's params and the input, in JAX."""
    out = {}
    for name, case in LAYER_CASES.items():
        jcfg, idx = case(tiny_cfg)
        layers_np = [jax_params(jcfg)["layers"][i] for i in idx]
        rng = np.random.default_rng(4)
        length = 9
        x = (rng.standard_normal((2, length, jcfg.hidden_size)) * 0.7).astype(np.float32)
        w = rng.standard_normal((2, length, jcfg.hidden_size)).astype(np.float32)
        sliding = jllama.layer_sliding_pattern(jcfg)
        rope_on = jllama.layer_rope_pattern(jcfg)

        def chain(ps, h):
            for i, p in zip(idx, ps):
                mask = jcausal_mask(length, length,
                                    window=jcfg.sliding_window if sliding[i] else None,
                                    chunk=jcfg.attention_chunk_size if sliding[i] else None)
                h = jllama.decoder_layer(p, jcfg, h, jnp.arange(length), mask,
                                         sliding=sliding[i], rope_on=rope_on[i])
            return h

        @jax.jit
        def f(ps, h, dy):
            y, vjp = jax.vjp(chain, ps, h)
            return y, *vjp(dy)

        y, dp, dx = f(jax.tree.map(jnp.asarray, layers_np), jnp.asarray(x), jnp.asarray(w))
        out[name] = (jcfg, idx, layers_np, x, w, np.asarray(y), jax.tree.map(np.asarray, dp),
                     np.asarray(dx))
    return out


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_decoder_layer_and_its_gradients_match_jax(layer_refs, name):
    jcfg, idx, layers_np, x, w, want_y, want_dp, want_dx = layer_refs[name]
    cfg = port_cfg(jcfg)
    length = x.shape[1]
    sliding, rope_on = llama.layer_sliding_pattern(cfg), llama.layer_rope_pattern(cfg)
    layers = training.tree_map(lambda a: tensor_from_numpy(np.asarray(a)), layers_np)
    live = training.live_leaves(layers)
    xt = torch.from_numpy(x).requires_grad_()
    y = xt
    for i, p in zip(idx, training.tree_unflatten(layers, live)):
        y = llama.decoder_layer(p, cfg, y, torch.arange(length)[None],
                                training.layer_mask(cfg, length, sliding[i], "cpu"),
                                sliding=sliding[i], rope_on=rope_on[i])
    *dp, dx = training.grads_of(y, [*live, xt], torch.from_numpy(w))
    # JAX's tolerance, atol scaled by each leaf's largest magnitude: the
    # chained layers' gradients reach about 15, float32 sums (over the
    # batch's 18 positions for a weight) taken in another order.
    assert_tree_close([y, dx, training.tree_unflatten(layers, dp)], [want_y, want_dx, want_dp],
                      scaled=True)


# ---------------------------------------------------------------------------
# Schedules and the optimizer
# ---------------------------------------------------------------------------

SCHEDULES = {
    "constant": dict(peak_lr=3e-4),
    "warmup-cosine": dict(peak_lr=1e-3, warmup_steps=4, total_steps=20, kind="cosine"),
    "warmup-linear": dict(peak_lr=1e-3, warmup_steps=3, total_steps=12, kind="linear",
                          end_scale=0.25),
    "warmup-constant": dict(peak_lr=2e-3, warmup_steps=5),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_lr_schedule_matches_optax(name):
    kw = SCHEDULES[name]
    want = jtraining.make_lr_schedule(**kw)
    got = training.make_lr_schedule(**kw)
    for step in range(25):
        w = float(want(step)) if callable(want) else want
        g = float(got(step)) if callable(got) else got
        assert g == pytest.approx(w, rel=1e-6, abs=1e-12), step


def _opt_trees(rng):
    return {"b": {"w": rng.normal(0, 1, (5, 3)).astype(np.float32),
                  "a": rng.normal(0, 1, (4,)).astype(np.float32)},
            "layers": [{"s": rng.normal(0, 1, (3,)).astype(np.float32)}]}


@pytest.mark.parametrize("clip", [100.0, 0.5], ids=["not-clipped", "clipped"])
def test_optimizer_matches_optax_over_three_steps(clip):
    rng = np.random.default_rng(7)
    params = _opt_trees(rng)
    grads = [_opt_trees(rng) for _ in range(3)]
    kw = dict(peak_lr=1e-2, weight_decay=0.1, warmup_steps=1, total_steps=6, grad_clip=clip)
    jopt = jtraining.make_optimizer(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    jupdate = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(
        *jopt.update(g, s, p)))
    opt = training.make_optimizer(**kw)
    tp = training.tree_map(torch.from_numpy, params)
    ts = opt.init(tp)
    for g in grads:
        norm = float(optax.global_norm(g))
        assert (norm >= clip) == (clip == 0.5)
        jp, js = jupdate(jax.tree.map(jnp.asarray, g), js, jp)
        opt.update_(tp, training.tree_map(torch.from_numpy, g), ts)
        assert_tree_close(tp, jax.tree.map(np.asarray, jp), rtol=1e-6, atol=1e-7)
    # The state's leaves in JAX's tree-flatten order (the checkpoint layout).
    want_leaves = jax.tree.leaves(js)
    got_leaves = ts.leaves()
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(training._to_numpy(g), np.asarray(w), rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 17), (2, 2, 17)], ids=["step", "accum_steps=2"])
def test_train_step_matches_jax(tiny_cfg, shape):
    """One make_train_step update, and one accumulating two microbatches,
    against JAX's make_train_step (mesh None) on the same params and tokens."""
    jcfg = small_cfg(tiny_cfg)
    tokens, want_loss, want_params = jax_step(jcfg, shape)
    cfg = port_cfg(jcfg)
    opt = training.make_optimizer(peak_lr=LR, weight_decay=WD, grad_clip=CLIP)
    state = training.TrainState.create(cfg, params_from_jax(jax_params(jcfg), cfg), opt,
                                       device="cpu")
    accum = shape[0] if len(shape) == 3 else 1
    state, loss = training.make_train_step(cfg, opt, dtype=torch.float32, accum_steps=accum)(
        state, torch.from_numpy(tokens))
    assert float(loss) == pytest.approx(want_loss, rel=1e-5)
    assert state.step == 1 and state.opt_state.count == 1
    assert_update_close(state.params, want_params, port_grads(cfg, jax_params(jcfg), tokens), LR)


def port_grads(cfg: LlamaConfig, params_np: dict, tokens: np.ndarray, clip: float = CLIP):
    """The port's float32 gradient of a step from ``params_np`` (the mean
    over microbatches), clipped to a global norm of ``clip`` as the update
    sees it: the near-zero mask of :func:`assert_update_close`."""
    params = params_from_jax(params_np, cfg)
    micro = tokens[None] if tokens.ndim == 2 else tokens
    total = None
    for mb in micro:
        g = training.value_and_grad(params, cfg, torch.from_numpy(mb), torch.float32, None)[1]
        total = g if total is None else training._tree_zip(torch.add, total, g)
    scale = min(1.0, clip / float(training.global_norm(total) / len(micro)))
    return training.tree_map(lambda t: t / len(micro) * scale, total)


def test_mixtral_step_moves_the_router_as_jax_does():
    """One Mixtral-shaped MoE update equals JAX's (the port groups tokens by
    expert, JAX computes every expert and zeroes the unselected), and the
    router moves. The router's and experts' gradients are the layer test's."""
    tokens, want_loss, want_params = jax_step(MIXTRAL1, (2, 11))
    cfg = port_cfg(MIXTRAL1)
    opt = training.make_optimizer(peak_lr=LR, weight_decay=WD, grad_clip=CLIP)
    state = training.TrainState.create(cfg, params_from_jax(jax_params(MIXTRAL1), cfg), opt,
                                       device="cpu")
    state, loss = training.make_train_step(cfg, opt, dtype=torch.float32)(state, tokens)
    assert float(loss) == pytest.approx(want_loss, rel=1e-5)
    router = state.params["layers"][0]["mlp"]["router"].numpy()
    assert not np.allclose(router, jax_params(MIXTRAL1)["layers"][0]["mlp"]["router"])
    assert_update_close(state.params, want_params, port_grads(cfg, jax_params(MIXTRAL1), tokens),
                        LR)


def test_a_mesh_is_refused():
    cfg = LlamaConfig(vocab_size=16, hidden_size=8, intermediate_size=16, num_hidden_layers=1,
                      num_attention_heads=2, num_key_value_heads=1)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg)
    opt = training.AdamW()
    for call in (lambda: training.make_train_step(cfg, opt, mesh=object()),
                 lambda: training.make_train_step(cfg, opt, dp="dp"),
                 lambda: training.TrainState.create(cfg, params, opt, mesh=object(),
                                                    device="cpu"),
                 lambda: training.restore_train_state("x", cfg, opt, mesh=object())):
        with pytest.raises(NotImplementedError, match="item 8"):
            call()


# ---------------------------------------------------------------------------
# The initialisers
# ---------------------------------------------------------------------------

def _init_cases(tiny_cfg):
    return {
        "tied-biased": small_cfg(tiny_cfg, model_type="gemma2", tie_word_embeddings=True,
                                 attention_in_bias=True, attention_out_bias=True, mlp_bias=True,
                                 ffw_sandwich_norms=True, num_hidden_layers=1),
        "mixtral": MIXTRAL1,
        "deepseek": DEEPSEEK1,
        "llama4": LLAMA4_2,
    }


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}[{i}]")
    else:
        yield path, tree


@pytest.mark.parametrize("name", ["tied-biased", "mixtral", "deepseek", "llama4"])
def test_init_params_tree_matches_jax(tiny_cfg, name):
    """The same tree, key order, shapes, dtypes and per-leaf scales as the
    JAX package's initialisers (the draws themselves differ), in float32
    and bf16: ones stay ones, and each random leaf's standard deviation is
    JAX's within the spread of two samples of its size."""
    jcfg = _init_cases(tiny_cfg)[name]
    cfg = port_cfg(jcfg)
    init = jllama.init_mixed_params if jcfg.moe_layer_pattern is not None else jllama.init_params
    port_init = llama.init_mixed_params if cfg.moe_layer_pattern is not None else llama.init_params
    values = dict(_flat(jax_params(jcfg)))
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = []  # the traced tree in JAX's insertion order (jit's output sorts its keys)

        def trace(key):
            tree = init(key, jcfg, jdtype)
            want.extend(_flat(tree))
            return tree

        jax.eval_shape(trace, jax.random.PRNGKey(0))
        got = list(_flat(port_init(torch.Generator().manual_seed(0), cfg, dtype)))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            assert tuple(g.shape) == w.shape, path
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path
            g32, w32 = g.float().numpy(), values[path]
            if np.all(w32 == 1.0):
                assert np.all(g32 == 1.0), path
            else:
                # Two samples' standard deviations differ by about
                # 1/sqrt(n) relative; 5 of those, at most a half.
                rel = min(0.5, 5 / np.sqrt(w32.size))
                assert g32.std() == pytest.approx(w32.std(), rel=rel), path


# ---------------------------------------------------------------------------
# Train-state checkpoints
# ---------------------------------------------------------------------------

def test_train_state_checkpoint_resumes_and_refuses_orbax(tiny_cfg, tmp_path):
    """save_train_state at step 1, restore_train_state, step 2 == two
    uninterrupted steps (equal to the bit: the same code on the same
    values). The directory is the streamed trainer's layout; JAX's orbax
    directory is refused with a typed error naming the format."""
    jcfg = small_cfg(tiny_cfg)
    cfg = port_cfg(jcfg)
    params_np = jax_params(jcfg)
    t1, t2 = tokens_for(jcfg, 12, (2, 17)), tokens_for(jcfg, 13, (2, 17))
    opt = training.make_optimizer(peak_lr=LR, warmup_steps=2, total_steps=20)
    step = training.make_train_step(cfg, opt, dtype=torch.float32)

    straight = training.TrainState.create(cfg, params_from_jax(params_np, cfg), opt, device="cpu")
    straight, _ = step(straight, t1)
    ck = str(tmp_path / "ck")
    training.save_train_state(straight, ck, cfg)
    straight, _ = step(straight, t2)
    assert sorted(p.name for p in (tmp_path / "ck").glob("opt-*.npz")) == sorted(
        f"opt-{n}.npz" for n in training.segment_names(2, False))

    resumed = training.restore_train_state(ck, cfg, opt, device="cpu")
    assert resumed.step == 1 and resumed.opt_state.count == 1 and resumed.opt_state.lr_count == 1
    resumed, _ = step(resumed, t2)
    assert_tree_close(resumed.params, to_np(straight.params), rtol=0, atol=0)

    jtraining.save_train_state(jtraining.TrainState(params={"w": jnp.zeros(2)}, opt_state=(),
                                                    step=jnp.zeros((), jnp.int32)),
                               str(tmp_path / "orbax"))
    with pytest.raises(training.CheckpointFormatError, match="orbax"):
        training.restore_train_state(str(tmp_path / "orbax"), cfg, opt, device="cpu")


def test_causal_mask_matches_jax():
    for kw in ({}, {"window": 3}, {"chunk": 4}):
        np.testing.assert_array_equal(causal_mask(9, 9, **kw).numpy(),
                                      np.asarray(jcausal_mask(9, 9, **kw)))


def test_tree_unflatten_leaves_no_cycle():
    """F8: filling a tree left a reference cycle that held every leaf (a
    layer's device params and gradients) until the cyclic collector ran, so
    the streamed trainer's device peak grew with depth. A leaf is released
    as soon as its tree is, and a step leaves no cyclic garbage."""
    from flexible_llm_sharding_tpu_torch.training_stream import StreamedTrainer

    cfg = LlamaConfig(vocab_size=64, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                      num_attention_heads=2, num_key_value_heads=1)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.randint(1, 64, (2, 9), generator=torch.Generator().manual_seed(1))
    tr = StreamedTrainer(cfg, params, device="cpu")
    opt = training.make_optimizer()
    state = training.TrainState.create(cfg, params, opt, device="cpu")
    step = training.make_train_step(cfg, opt, dtype=torch.float32)
    tr.step(tokens)
    step(state, tokens)
    gc.collect()
    gc.disable()
    try:
        leaf = torch.zeros(3)
        ref = weakref.ref(leaf)
        tree = training.tree_unflatten({"a": {"b": None}}, [leaf])
        del leaf, tree
        assert ref() is None
        tr.step(tokens)
        step(state, tokens)
        assert gc.collect() == 0
    finally:
        gc.enable()
